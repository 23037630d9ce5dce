"""The port's recurrent mixers (RWKV6, Mamba2) against the JAX package's,
on the CPU.

Mixer level, at the smoke configs' widths: the JAX package's initialiser
draws the weights, its constant leaves (token-shift mixes, decay bias and
bonus, norms, A_log, D, dt_bias) are redrawn from a seeded numpy generator
so that no term of the block multiplies by a constant 0 or 1, and the same
weights and seeded numpy inputs go through ``rwkv6_apply``/``rwkv6_decode``
and ``mamba2_apply``/``mamba2_decode`` of both packages (the reference
under ``jax.jit``).  Outputs and carried states agree within 1e-4 of their
largest magnitude in float32 and 2e-2 in bfloat16.

The port's chunked forms equal its own per-token recurrences at chunks 2,
4 and 8 and at a length that is not a multiple of the chunk (the padding
path) within the JAX package's own bound, rtol = atol = 2e-4
(``tests/test_mixers.py``); a fast-forgetting decay stays finite.

R5 (``ROADMAP.md`` §3): the reference's mamba2/hybrid ``prefill`` has no
conv state after a prompt shorter than ``conv_width - 1`` tokens.  The
port's prefill of 1- and 2-token prompts, then decode steps, is held
against token-by-token ``decode_step`` from a fresh state, in the port and
in the JAX package (whose prefill is not called at those lengths).
"""

import copy
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jrk
from repro_torch import models as tm
from repro_torch.models import ModelConfig
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rwkv6 as trk
from repro_torch.models.convert import from_reference_params

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the JAX package's own bound between the chunked form and the recurrence
RECURRENCE_RTOL = RECURRENCE_ATOL = 2e-4
B, S = 2, 16
# (smoke config, reference init, reference apply, port weights, port apply)
MIXERS = {
    "rwkv6": ("rwkv6-1.6b", jrk.rwkv6_init, jrk.rwkv6_apply, trk.RWKV6,
              trk.rwkv6_apply),
    "mamba2": ("zamba2-1.2b", jm2.mamba2_init, jm2.mamba2_apply, tm2.Mamba2,
               tm2.mamba2_apply),
}


def _rel(got, want) -> float:
    g = np.asarray(got.to(torch.float64) if torch.is_tensor(got) else got,
                   np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _cfg(mixer: str, dt: str = "float32", **over):
    cfg = jconfigs.get_smoke_config(MIXERS[mixer][0])
    return dataclasses.replace(cfg, dtype=dt, **over)


def _tcfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _redraw(p: dict, seed: int) -> dict:
    """The reference's weights with its constant leaves redrawn."""
    rng = np.random.default_rng(seed)
    draw = {
        "mu": lambda s: rng.uniform(0.0, 1.0, s),
        "ffn_mu": lambda s: rng.uniform(0.0, 1.0, s),
        "w_bias": lambda s: rng.uniform(-7.0, -1.0, s),
        "u": lambda s: rng.normal(size=s) * 0.5,
        "norm_w": lambda s: rng.normal(size=s) * 0.2,
        "ln1": lambda s: rng.normal(size=s) * 0.2,
        "ln2": lambda s: rng.normal(size=s) * 0.2,
        "A_log": lambda s: rng.normal(size=s) * 0.5,
        "D": lambda s: rng.normal(size=s),
        "dt_bias": lambda s: rng.normal(size=s) * 0.5,
    }
    return {k: (jnp.asarray(draw[k](v.shape), jnp.float32) if k in draw
                else v) for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _weights(mixer: str, seed: int = 0):
    """(reference weights, port module) for one mixer at its smoke
    config's widths."""
    _, init, _, cls, _ = MIXERS[mixer]
    cfg = _cfg(mixer)
    p = _redraw(init(jax.random.PRNGKey(seed), cfg)[0], seed + 100)
    mod = cls(_tcfg(cfg), "cpu")
    with torch.no_grad():
        for name, w in mod.named_parameters():
            w.copy_(_t(p[name]))
    return p, mod


def _states(mixer, rng, cfg, jdt, tdt):
    """A random carried state in both packages' layouts and dtypes."""
    b = B
    if mixer == "rwkv6":
        h, hd = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
        shapes = [((b, h, hd, hd), jnp.float32, torch.float32),
                  ((b, cfg.d_model), jdt, tdt), ((b, cfg.d_model), jdt, tdt)]
    else:
        shapes = [((b, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                   jnp.float32, torch.float32),
                  ((b, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state),
                   jdt, tdt)]
    arrs = [jnp.asarray(rng.normal(size=s) * 0.5, jnp.float32).astype(jd)
            for s, jd, _ in shapes]
    return arrs, [_t(a, td) for a, (_, _, td) in zip(arrs, shapes)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_apply_matches_the_reference(mixer, dt):
    _, _, apply, _, tapply = MIXERS[mixer]
    jdt, tdt = DTYPES[dt]
    cfg = _cfg(mixer, dt)
    p, mod = _weights(mixer)
    x = np.random.default_rng(1).normal(size=(B, S, cfg.d_model))
    xj = jnp.asarray(x, jnp.float32).astype(jdt)
    want, wstate = jax.jit(lambda p, x: apply(p, cfg, x, jdt))(p, xj)
    got, gstate = tapply(mod, _tcfg(cfg), _t(xj, tdt), tdt)
    assert got.dtype == tdt
    assert _rel(got, want) <= TOL[dt]
    assert len(gstate) == len(wstate)
    for g, w in zip(gstate, wstate):
        assert g.dtype == (torch.float32 if w.dtype == jnp.float32 else tdt)
        assert _rel(g, w) <= TOL[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_decode_matches_the_reference(mixer, dt):
    jdt, tdt = DTYPES[dt]
    cfg = _cfg(mixer, dt)
    tcfg = _tcfg(cfg)
    p, mod = _weights(mixer)
    rng = np.random.default_rng(2)
    xj = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)),
                     jnp.float32).astype(jdt)
    jstate, tstate = _states(mixer, rng, cfg, jdt, tdt)
    if mixer == "rwkv6":
        want, wstate = jax.jit(lambda p, x, s: jrk.rwkv6_decode(
            p, cfg, x, s, jdt))(p, xj, tuple(jstate))
        got, gstate = trk.rwkv6_decode(mod, tcfg, _t(xj, tdt),
                                       tuple(tstate), tdt)
    else:
        want, wstate = jax.jit(lambda p, x, s, c: jm2.mamba2_decode(
            p, cfg, x, s, c, jdt))(p, xj, *jstate)
        got, gstate = tm2.mamba2_decode(mod, tcfg, _t(xj, tdt), *tstate, tdt)
    assert _rel(got, want) <= TOL[dt]
    for g, w in zip(gstate, wstate):
        assert _rel(g, w) <= TOL[dt]


def _recurrence(mixer, mod, cfg, x):
    """The port's per-token decode over x from a zero state: (y, state)."""
    b = x.shape[0]
    tcfg = _tcfg(cfg)
    f32 = torch.float32
    if mixer == "rwkv6":
        hd = cfg.ssm_head_dim
        state = (torch.zeros(b, cfg.d_model // hd, hd, hd),
                 torch.zeros(b, cfg.d_model), torch.zeros(b, cfg.d_model))
    else:
        state = (torch.zeros(b, cfg.n_ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state),
                 torch.zeros(b, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state))
    ys = []
    for t in range(x.shape[1]):
        if mixer == "rwkv6":
            y, state = trk.rwkv6_decode(mod, tcfg, x[:, t:t + 1], state, f32)
        else:
            y, state = tm2.mamba2_decode(mod, tcfg, x[:, t:t + 1], *state,
                                         f32)
        ys.append(y)
    return torch.cat(ys, dim=1), state


@pytest.mark.parametrize("length", [16, 13])
@pytest.mark.parametrize("chunk", [2, 4, 8])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_chunked_equals_recurrence(mixer, chunk, length):
    """13 is a multiple of no chunk but 1: the state-preserving padding."""
    cfg = _cfg(mixer, ssm_chunk=chunk)
    _, mod = _weights(mixer)
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(B, length, cfg.d_model)) * 0.3, dtype=torch.float32)
    y_par, state_par = MIXERS[mixer][4](mod, _tcfg(cfg), x, torch.float32)
    y_seq, state_seq = _recurrence(mixer, mod, cfg, x)
    np.testing.assert_allclose(y_par.numpy(), y_seq.numpy(),
                               rtol=RECURRENCE_RTOL, atol=RECURRENCE_ATOL)
    for a, b in zip(state_par, state_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   rtol=RECURRENCE_RTOL,
                                   atol=RECURRENCE_ATOL)


def test_rwkv6_no_overflow_with_aggressive_decay():
    """Fast-forgetting channels (log-decay −e³ a token) stay finite in the
    chunked form, as in the reference's own test."""
    cfg = _cfg("rwkv6", ssm_chunk=8)
    p, mod = _weights("rwkv6", seed=2)
    mod = copy.deepcopy(mod)
    with torch.no_grad():
        mod.w_bias.fill_(3.0)
    p = dict(p, w_bias=jnp.full_like(p["w_bias"], 3.0))
    x = np.random.default_rng(2).normal(size=(1, 32, cfg.d_model))
    y, (wkv, _, _) = trk.rwkv6_apply(mod, _tcfg(cfg), torch.as_tensor(
        x, dtype=torch.float32), torch.float32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(wkv).all())
    want, _ = jax.jit(lambda p, x: jrk.rwkv6_apply(p, cfg, x, jnp.float32))(
        p, jnp.asarray(x, jnp.float32))
    assert _rel(y, want) <= TOL["float32"]


def test_mamba2_masked_decay_is_exponentiated_finite():
    """A decay of −e³·dt a token makes the masked entries' exponents
    (cs_i − cs_j, j > i) large and positive; the port fills them with −inf
    before ``exp``, so no intermediate overflows, and the output equals the
    reference's (which zeroes ``inf`` after ``exp``) and the recurrence."""
    cfg = _cfg("mamba2", ssm_chunk=8)
    p, mod = _weights("mamba2", seed=3)
    mod = copy.deepcopy(mod)
    with torch.no_grad():
        mod.A_log.fill_(3.0)
        mod.dt_bias.fill_(4.0)
    p = dict(p, A_log=jnp.full_like(p["A_log"], 3.0),
             dt_bias=jnp.full_like(p["dt_bias"], 4.0))
    x = np.random.default_rng(3).normal(size=(1, 32, cfg.d_model))
    xt = torch.as_tensor(x, dtype=torch.float32)
    with mock.patch.object(tm2, "_ssd_chunked",
                           wraps=tm2._ssd_chunked) as ssd:
        y, (ssm, _) = tm2.mamba2_apply(mod, _tcfg(cfg), xt, torch.float32)
    # a chunk's decay spans more than float32's exponent range
    dA = ssd.call_args.args[1]
    assert float(-dA[:, :cfg.ssm_chunk].sum(1).max()) > 89.0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(ssm).all())
    want, _ = jax.jit(lambda p, x: jm2.mamba2_apply(p, cfg, x, jnp.float32))(
        p, jnp.asarray(x, jnp.float32))
    assert _rel(y, want) <= TOL["float32"]
    y_seq, _ = _recurrence("mamba2", mod, cfg, xt)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(),
                               rtol=RECURRENCE_RTOL, atol=RECURRENCE_ATOL)


# ---------------------------------------------------------------------------
# R5: prompts shorter than conv_width - 1 through prefill
# ---------------------------------------------------------------------------
R5_CASES = {"mamba2": {"family": "mamba2", "name": "mamba2-smoke"},
            "zamba2": {}}
R5_STEPS = 3


@functools.lru_cache(maxsize=None)
def _r5_models(name: str):
    cfg = dataclasses.replace(jconfigs.get_smoke_config("zamba2-1.2b"),
                              dtype="float32", **R5_CASES[name])
    params = jax.jit(lambda key: jm.init_params(key, cfg)[0])(
        jax.random.PRNGKey(5))
    tcfg = _tcfg(cfg)
    return cfg, params, tcfg, from_reference_params(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


@pytest.mark.parametrize("plen", [1, 2])
@pytest.mark.parametrize("name", list(R5_CASES))
def test_short_prompt_prefill_equals_the_recurrence(name, plen):
    cfg, params, tcfg, model = _r5_models(name)
    assert plen < cfg.conv_width - 1
    rng = np.random.default_rng(6 + plen)
    toks = rng.integers(0, cfg.vocab_size, (B, plen + R5_STEPS)).astype(
        np.int32)
    max_len = toks.shape[1]

    # the port: prefill of the prompt, then decode steps
    cache = tm.init_decode_state(tcfg, B, max_len, "cpu")
    logits, cache = tm.prefill(model, tcfg, {"tokens": torch.as_tensor(
        toks[:, :plen])}, cache)
    got, states = [logits], {k: cache[k].clone() for k in ("ssm", "conv")}
    for t in range(plen, toks.shape[1] - 1):
        logits, cache = tm.decode_step(model, tcfg, torch.as_tensor(
            toks[:, t:t + 1]), cache)
        got.append(logits)

    # token by token from a fresh state: the port and the reference
    rec = tm.init_decode_state(tcfg, B, max_len, "cpu")
    jdec = jax.jit(jm.decode_step, static_argnums=1)
    jcache = jm.init_decode_state(cfg, B, max_len)
    port_rec, ref_rec = [], []
    for t in range(toks.shape[1] - 1):
        logits, rec = tm.decode_step(model, tcfg, torch.as_tensor(
            toks[:, t:t + 1]), rec)
        jlogits, jcache = jdec(params, cfg, jnp.asarray(toks[:, t:t + 1]),
                               jcache)
        if t >= plen - 1:
            port_rec.append(logits)
            ref_rec.append(jlogits)
        if t == plen - 1:
            for k in ("ssm", "conv"):
                np.testing.assert_allclose(
                    states[k].numpy(), rec[k].numpy(),
                    rtol=RECURRENCE_RTOL, atol=RECURRENCE_ATOL)
                np.testing.assert_allclose(
                    states[k].numpy(), np.asarray(jcache[k]),
                    rtol=RECURRENCE_RTOL, atol=RECURRENCE_ATOL)
    assert cache["pos"] == rec["pos"] == toks.shape[1] - 1
    assert len(got) == len(port_rec) == R5_STEPS
    for g, p, r in zip(got, port_rec, ref_rec):
        assert _rel(g, p.numpy()) <= RECURRENCE_RTOL
        assert _rel(g, r) <= RECURRENCE_RTOL
