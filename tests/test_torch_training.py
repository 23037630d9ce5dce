"""The port's LM training path against the JAX package's, on the CPU.

``repro_torch.training`` (``cross_entropy_loss``, AdamW, ``cosine_schedule``,
``build_train_step``), ``repro_torch.data.TokenPipeline`` and
``repro_torch.distributed.ef_int8_roundtrip``: the same seeded numpy inputs
go through the reference (under ``jax.jit``) and the port.

Bounds: the loss and its metrics within 1e-6 relative (``tokens`` equal);
AdamW's parameters, moments and ``grad_norm`` within 1e-6 of each leaf's
largest magnitude over three updates; the schedule within 1e-7; the int8 round trip and the token pipeline bitwise.  Then the
first four tests of ``tests/test_training.py`` on the port with their own
bounds and step counts, the remat policies' gradients bitwise equal, and a
trajectory: five steps of smollm's smoke config, port against reference
from the same weights on the same batches, each step's loss and
``grad_norm`` within rtol 1e-5 and the parameters within ``TRAJ_TOL``
(``test_trajectory_matches_the_reference``).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_smoke_config as jsmoke
from repro.data import TokenPipeline as JPipeline
from repro.distributed.compression import ef_int8_roundtrip as jef
from repro.training import build_train_step as jbuild
from repro.training import init_train_state as jinit
from repro.training.losses import cross_entropy_loss as jce
from repro.training.optimizer import AdamWState as JAdamWState
from repro.training.optimizer import adamw_update as jadamw
from repro.training.optimizer import cosine_schedule as jcosine
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed import ef_int8_roundtrip
from repro_torch.models import ModelConfig
from repro_torch.models.convert import from_reference_params, \
    to_reference_params
from repro_torch.training.losses import IGNORE
from repro_torch.training.optimizer import adamw_init, cosine_schedule

jax.config.update("jax_platform_name", "cpu")

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# parameters after each of the trajectory's steps, port against reference:
# every entry within TRAJ_TOL, at most TRAJ_FAR entries beyond 1e-6 (see the
# test)
TRAJ_TOL = 1e-5
TRAJ_FAR = 4


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rel(got, want) -> float:
    g = np.asarray(got.detach().to(torch.float64) if isinstance(
        got, torch.Tensor) else got, np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------------------------
# the loss, the optimizer, the schedule, compression, the pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 33)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (3, 7)).astype(np.int32)
    labels[0, :3] = IGNORE
    labels[2, 5] = IGNORE
    jl = jnp.asarray(logits, dtype)
    tl = torch.as_tensor(logits).to(getattr(torch, dtype))
    want, wm = jax.jit(jce)(jl, jnp.asarray(labels))
    got, gm = tt.cross_entropy_loss(tl, torch.as_tensor(labels))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6
    for k in ("ce", "zloss"):
        assert _rel(gm[k], wm[k]) <= 1e-6, k
    assert gm["tokens"].dtype == torch.int32
    assert int(gm["tokens"]) == int(wm["tokens"]) == 17


def test_cross_entropy_of_no_labels_is_zero():
    loss, m = tt.cross_entropy_loss(torch.ones(1, 2, 5),
                                    torch.full((1, 2), IGNORE))
    assert float(loss) == 0.0 and int(m["tokens"]) == 0


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference(state_dtype):
    """Three updates from the same parameters, gradients and zero state;
    the second clips (its gradients are scaled above the clip norm)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": (11,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v).clone() for k, v in params.items()}
    jdt = getattr(jnp, state_dtype)
    js = JAdamWState(jnp.zeros((), jnp.int32),
                     {k: jnp.zeros(v.shape, jdt) for k, v in jp.items()},
                     {k: jnp.zeros(v.shape, jdt) for k, v in jp.items()})
    ts = adamw_init(tp, getattr(torch, state_dtype))
    upd = jax.jit(jadamw)
    for i, (scale, lr) in enumerate(((0.1, 1e-2), (3.0, 5e-3), (0.05, 2e-3))):
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jmet = upd({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp, lr=jnp.float32(lr))
        tp, ts, tmet = tt.adamw_update(
            {k: torch.as_tensor(v) for k, v in grads.items()}, ts, tp,
            lr=torch.tensor(lr))
        assert int(ts.step) == int(js.step) == i + 1
        assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-6
        assert float(tmet["lr"]) == float(jmet["lr"])
        for k in shapes:
            assert ts.m[k].dtype == getattr(torch, state_dtype)
            for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                              (ts.v[k], js.v[k])):
                assert _rel(got, want) <= 1e-6, (i, k)
    assert float(tmet["grad_norm"]) > 0


def test_cosine_schedule_matches_the_reference():
    base, warmup, total = 1e-2, 5, 30
    want = jax.jit(jax.vmap(jcosine(base, warmup, total)))(
        jnp.arange(total + 3, dtype=jnp.int32))
    lr = cosine_schedule(base, warmup, total)
    got = torch.stack([lr(torch.tensor(s, dtype=torch.int32))
                       for s in range(total + 3)])
    assert got.dtype == torch.float32
    # absolute: the warmup's division and the cosine round apart by an ulp
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-7
    assert float(got[0]) == 0.0 and float(got[total + 2]) == 0.0
    assert abs(float(got[warmup]) - base) <= 1e-9


@pytest.mark.parametrize("case", ["normal", "tiny", "zeros", "ties",
                                  "bfloat16"])
def test_ef_int8_roundtrip_is_bitwise(case):
    rng = np.random.default_rng(2)
    g = rng.normal(size=(64, 33)).astype(np.float32)
    if case == "tiny":
        g *= 1e-30
    elif case == "zeros":
        g[:] = 0.0
    elif case == "ties":
        # entries at k + 0.5 quantisation steps: round half to even
        g = (np.arange(-127, 128, dtype=np.float32) * 0.5)[:, None] \
            * np.ones((1, 3), np.float32)
    if case == "bfloat16":
        want = jef(jnp.asarray(g, jnp.bfloat16))
        got = ef_int8_roundtrip(torch.as_tensor(g).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))
        return
    want = np.asarray(jax.jit(jef)(jnp.asarray(g)))
    got = ef_int8_roundtrip(torch.as_tensor(g))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    if case == "normal":
        err = np.abs(got.numpy() - g).max() / np.abs(g).max()
        assert err < 1 / 127 + 1e-6


@pytest.mark.parametrize("corpus", [False, True])
def test_token_pipeline_matches_the_reference(corpus):
    stream = (np.arange(5000, dtype=np.int32) * 7919) % 1000 \
        if corpus else None
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=5,
              corpus=stream)
    jp, tp = JPipeline(**kw), TokenPipeline(**kw)
    for step in (0, 1, 17):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])
        for shard in range(4):
            w, g = jp.shard_at(step, shard, 4), tp.shard_at(step, shard, 4)
            assert all(np.array_equal(g[k], w[k]) for k in w)
        tb = tp.torch_batch(step, "cpu")
        for k in want:
            assert tb[k].dtype == torch.int32
            assert np.array_equal(tb[k].numpy(), np.asarray(
                jp.jax_batch(step)[k]))


def test_token_pipeline_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(100, 4, 2).torch_batch(0)


def test_training_modules_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    files = [*sorted((SRC / "training").glob("*.py")),
             *sorted((SRC / "distributed").glob("*.py")),
             SRC / "data" / "lm_pipeline.py", SRC / "data" / "__init__.py",
             *sorted((SRC / "models").glob("*.py"))]
    assert len(files) >= 18
    for f in files:
        assert not pat.search(f.read_text()), f


# ---------------------------------------------------------------------------
# the model: remat, to_reference_params
# ---------------------------------------------------------------------------
def _grads(model, cfg, batch, remat):
    state = tt.init_train_state(model)
    loss, _ = tt.train_loss(model, cfg, batch, remat=remat)
    return loss, torch.autograd.grad(loss, list(state.params.values()))


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x22b",
                                  "rwkv6-1.6b", "zamba2-1.2b"])
def test_remat_policies_give_bitwise_equal_gradients(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = tm.init_params(cfg, seed=3, device="cpu")
    batch = TokenPipeline(cfg.vocab_size, 16, 2, seed=3).torch_batch(
        0, "cpu")
    base_loss, base = _grads(model, cfg, batch, "none")
    assert all(bool(torch.isfinite(g).all()) for g in base)
    for remat in ("full", "dots"):
        loss, grads = _grads(model, cfg, batch, remat)
        assert torch.equal(loss, base_loss), remat
        for a, b in zip(grads, base):
            assert torch.equal(a, b), remat


def test_a_served_model_records_no_gradients():
    cfg = get_smoke_config("smollm-135m")
    model = tm.init_params(cfg, seed=0, device="cpu")
    logits, _ = tm.forward(model, cfg, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    assert not logits.requires_grad
    assert not any(w.requires_grad for w in model.parameters())
    tt.init_train_state(model)
    assert all(w.requires_grad for w in model.parameters())


def test_moe_dropped_tokens_get_no_gradient():
    """The MoE dispatch scatters a dropped (token, choice) into its
    expert's trash row, which is sliced away: a token whose every choice
    is dropped gets an exactly zero gradient through the experts, in the
    port as in the reference, and every other gradient matches."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jcfg = dataclasses.replace(jsmoke("mixtral-8x22b"), dtype="float32",
                               capacity_factor=0.25)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(5),
                                                   jcfg)[0])
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    moe = from_reference_params(tree, cfg, "cpu").layers[0].mlp
    x = np.random.default_rng(5).normal(size=(4, 16, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["mlp"])
    want = np.asarray(jax.jit(jax.grad(lambda v: jmoe.moe_apply(
        jp, jcfg, v, jnp.float32)[0].sum()))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_apply(moe, cfg, xt, torch.float32)
    (got,) = torch.autograd.grad(out.sum(), xt)
    assert float(aux["dropped_frac"]) > 0.5
    zero = (got.reshape(-1, cfg.d_model) == 0).all(dim=1).numpy()
    assert zero.any()
    assert (want.reshape(-1, cfg.d_model)[zero] == 0).all()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_to_reference_params_inverts_from_reference_params(arch):
    jcfg = jsmoke(arch)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(4),
                                                   jcfg)[0])
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    back = to_reference_params(from_reference_params(tree, cfg, "cpu"), cfg)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(jax.tree.leaves(back)) == len(flat)
    for path, want in flat:
        got = back
        for k in path:
            got = got[k.key]
        assert got.dtype == np.float32 and np.array_equal(got, want), path


# ---------------------------------------------------------------------------
# tests/test_training.py's first four tests, on the port
# ---------------------------------------------------------------------------
def _setup(microbatches=1, steps=40, arch="smollm-135m", remat="none",
           compress=False):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = tm.init_params(cfg, seed=0, device="cpu")
    state = tt.init_train_state(model)
    step = tt.build_train_step(cfg, microbatches=microbatches, base_lr=1e-2,
                               warmup=5, total_steps=steps, remat=remat,
                               compress_grads=compress)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=8, seed=7)
    return cfg, state, step, pipe


def test_loss_decreases():
    _, state, step, pipe = _setup(steps=30)
    losses = []
    for i in range(30):
        state, metrics = step(state, pipe.torch_batch(i % 4, "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::6]
    assert np.isfinite(losses).all()
    assert int(state.step) == int(state.opt.step) == 30


def test_microbatch_invariance():
    """Grad accumulation must not change the training trajectory."""
    _, s1, step1, pipe = _setup(microbatches=1)
    _, s4, step4, _ = _setup(microbatches=4)
    b = pipe.torch_batch(0, "cpu")
    s1, m1 = step1(s1, b)
    s4, m4 = step4(s4, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    d = [float((a - b_).detach().abs().max()) for a, b_ in
         zip(s1.model.parameters(), s4.model.parameters())]
    assert max(d) < 1e-4, sorted(d)[-3:]


def test_moe_train_smoke():
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              dtype="float32")
    state = tt.init_train_state(tm.init_params(cfg, seed=1, device="cpu"))
    step = tt.build_train_step(cfg, microbatches=2, base_lr=5e-3, warmup=2,
                               total_steps=20, remat="full")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4, seed=3)
    losses = []
    for i in range(12):
        state, metrics = step(state, pipe.torch_batch(i % 2, "cpu"))
        losses.append(float(metrics["loss"]))
        assert float(metrics["dropped_frac"]) <= 1.0
    assert losses[-1] < losses[0]


def test_grad_compression_preserves_convergence():
    # int8 EF roundtrip error must be < 1% of tensor scale
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(256,)),
                        dtype=torch.float32)
    r = ef_int8_roundtrip(g)
    rel = float((g - r).abs().max() / g.abs().max())
    assert rel < 1 / 127 + 1e-6
    # and training still converges with compression on
    _, state, step, pipe = _setup(steps=30, compress=True)
    losses = []
    for i in range(25):
        state, metrics = step(state, pipe.torch_batch(i % 4, "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.85


# ---------------------------------------------------------------------------
# a trajectory, port against reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_trajectory_matches_the_reference(microbatches):
    """Five steps of smollm's smoke config in float32 from the JAX
    package's weights on the same batches (``remat="full"``, warmup 2, so
    steps 1-4 move the weights), in one microbatch and in two.  Each
    step's loss, its metrics and ``grad_norm`` within rtol 1e-5.  The
    parameters after each step within ``TRAJ_TOL`` absolute, every entry
    of every leaf, and at most ``TRAJ_FAR`` of the 70,896 entries more than
    1e-6 apart.  Adam's first updates move an entry by about ``lr ·
    sign(g)`` whatever |g|, so an entry whose gradient sits at zero within
    the packages' float32 differences could move up to 2·lr (2e-3) apart;
    on these batches one entry does, partly, from step 3 on (2.5e-6 apart
    in one microbatch, 5.4e-6 in two), and every other entry stays within
    1e-7.  A step that moved such an entry by lr would fail here."""
    jcfg = dataclasses.replace(jsmoke("smollm-135m"), dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    kw = dict(microbatches=microbatches, base_lr=1e-3, warmup=2,
              total_steps=10, remat="full")
    params = jax.jit(lambda k: jm.init_params(k, jcfg)[0])(
        jax.random.PRNGKey(0))
    jstate = jinit(params)
    jstep = jax.jit(jbuild(jcfg, **kw))
    tstate = tt.init_train_state(from_reference_params(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    tstep = tt.build_train_step(cfg, **kw)
    pipe = TokenPipeline(cfg.vocab_size, 32, 4, seed=11)
    for i in range(5):
        nb = pipe.batch_at(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        tstate, tmet = tstep(tstate, {k: torch.as_tensor(v)
                                      for k, v in nb.items()})
        for k in ("loss", "grad_norm", "ce", "zloss"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
        got = to_reference_params(tstate.model, cfg)
        far = 0
        for path, want in jax.tree_util.tree_leaves_with_path(
                jstate.params):
            g = got
            for k in path:
                g = g[k.key]
            d = np.abs(g - np.asarray(want))
            assert d.max() <= TRAJ_TOL, (i, path, float(d.max()))
            far += int((d > 1e-6).sum())
        assert far <= TRAJ_FAR, (i, far)
