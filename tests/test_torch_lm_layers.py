"""The port's LM layer functions against the JAX package's, on the CPU.

The same numpy inputs and weights go through ``repro.models.{layers,
attention,moe}`` and ``repro_torch.models.{layers,attention,moe}``.  The
weights are the JAX package's own draws, copied into the port's modules by
name; the reference's attention and MoE run under ``jax.jit``, as its
serving loop runs them.  Tolerances, relative to the largest magnitude of
the reference's output: float32 ≤ 1e-5 (the two frameworks' kernels round
differently, e.g. ``exp`` and the order of a matmul's sums); bfloat16 ≤
2e-2 (a few units of bfloat16's 2^-7 rounding, which XLA and PyTorch apply
at different places).  ``load_stats`` is integer counting and must be
equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.models import ModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

jax.config.update("jax_platform_name", "cpu")

F32_TOL = 1e-5
BF16_TOL = 2e-2
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got: torch.Tensor, want) -> float:
    g = got.to(torch.float64).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _load(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX parameter tree into ``module``'s weights by name."""
    names = {n for n, _ in module.named_parameters()}
    with torch.no_grad():
        for name, w in module.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            w.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(names)
    return module


def _tcfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _x(rng, shape, dt):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, JDT[dt]), torch.as_tensor(x).to(TDT[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm(dt):
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, (2, 5, 48), dt)
    w = rng.normal(size=48).astype(np.float32) * 0.1
    want = jlayers.rms_norm(jx, jnp.asarray(w), 1e-6)
    got = tlayers.rms_norm(tx, torch.as_tensor(w), 1e-6)
    assert got.dtype == TDT[dt]
    assert _rel(got, want) <= TOL[dt]


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_and_apply_rope(theta, dt):
    rng = np.random.default_rng(1)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1)) + 7
    js, jc = jlayers.rope(jnp.asarray(pos), 16, theta)
    ts, tc = tlayers.rope(torch.as_tensor(pos), 16, theta)
    assert _rel(ts, js) <= F32_TOL and _rel(tc, jc) <= F32_TOL
    jx, tx = _x(rng, (2, 40, 3, 16), dt)
    got = tlayers.apply_rope(tx, ts, tc)
    assert got.dtype == TDT[dt]
    assert _rel(got, jlayers.apply_rope(jx, js, jc)) <= TOL[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_swiglu_mlp(dt):
    rng = np.random.default_rng(2)
    tree, _ = jlayers.mlp_init(jax.random.PRNGKey(2), 48, 96)
    mlp = _load(tlayers.MLP(48, 96, "cpu"), tree)
    jx, tx = _x(rng, (2, 6, 48), dt)
    want = jlayers.mlp_apply(tree, jx, JDT[dt])
    assert _rel(tlayers.mlp_apply(mlp, tx, TDT[dt]), want) <= TOL[dt]


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_embed_and_unembed(tie, softcap, dt):
    rng = np.random.default_rng(3)
    tree, _ = jlayers.embed_init(jax.random.PRNGKey(3), 256, 48, tie)
    emb = _load(tlayers.Embed(256, 48, tie, "cpu"), tree)
    tok = rng.integers(0, 256, (2, 7)).astype(np.int32)
    want = jlayers.embed_apply(tree, jnp.asarray(tok), JDT[dt])
    got = tlayers.embed_apply(emb, torch.as_tensor(tok), TDT[dt])
    assert got.dtype == TDT[dt]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    jx, tx = _x(rng, (2, 7, 48), dt)
    want = jlayers.unembed_apply(tree, jx, JDT[dt], softcap)
    got = tlayers.unembed_apply(emb, tx, TDT[dt], softcap)
    assert _rel(got, want) <= TOL[dt]


# attention flavours: MHA, GQA, MQA (gemma3's kv=1) with gemma3's local
# and global layers, qk-norm (qwen3) and SWA (danube; mixtral with GQA), at
# a chunk of 4 so that the prefill's online softmax runs over 4 chunks of a
# 16-token prompt; (arch, overrides, is_global)
ATTN = {
    "mha": ("smollm-135m", {}, True),
    "gqa": ("qwen3-14b", {"qk_norm": False}, True),
    "mqa-local": ("gemma3-1b", {}, False),
    "mqa-global": ("gemma3-1b", {}, True),
    "qk-norm": ("qwen3-14b", {}, True),
    "swa": ("h2o-danube-3-4b", {"sliding_window": 5}, False),
    "swa-gqa": ("mixtral-8x22b", {"sliding_window": 3}, False),
}


def _attn_case(name, dt):
    arch, over, _ = ATTN[name]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt,
                              attn_chunk=4, **over)
    tree, _ = jattn.attention_init(jax.random.PRNGKey(4), cfg)
    if cfg.qk_norm:  # non-zero norm weights, so that they count
        rng = np.random.default_rng(5)
        tree["q_norm"] = jnp.asarray(rng.normal(size=cfg.d_head) * 0.3,
                                     jnp.float32)
        tree["k_norm"] = jnp.asarray(rng.normal(size=cfg.d_head) * 0.3,
                                     jnp.float32)
    return cfg, tree, _load(tattn.Attention(_tcfg(cfg), "cpu"), tree)


@pytest.mark.parametrize("name", list(ATTN))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attention_train_and_prefill(name, dt):
    cfg, tree, mod = _attn_case(name, dt)
    is_global = ATTN[name][2]
    rng = np.random.default_rng(6)
    jx, tx = _x(rng, (2, 16, cfg.d_model), dt)
    pos = np.tile(np.arange(16), (2, 1))
    jpos, tpos = jnp.asarray(pos), torch.as_tensor(pos)
    for jfn, tfn in ((jattn.attention_train, tattn.attention_train),
                     (jattn.attention_prefill, tattn.attention_prefill)):
        want = jax.jit(jfn, static_argnums=(1, 4, 5))(
            tree, cfg, jx, jpos, is_global, JDT[dt])
        got = tfn(mod, _tcfg(cfg), tx, tpos, is_global, TDT[dt])
        got = got[0] if isinstance(got, tuple) else got
        assert got.dtype == TDT[dt]
        assert _rel(got, want) <= TOL[dt], jfn.__name__
    # the prefill's keys and values are the reference's _qkv
    _, jk, jv = jax.jit(jattn._qkv, static_argnums=(1, 4))(
        tree, cfg, jx, jpos, JDT[dt])
    _, tk, tv = tattn.attention_prefill(mod, _tcfg(cfg), tx, tpos, is_global,
                                        TDT[dt])
    assert _rel(tk, jk) <= TOL[dt] and _rel(tv, jv) <= TOL[dt]


@pytest.mark.parametrize("name", list(ATTN))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attention_decode(name, dt):
    cfg, tree, mod = _attn_case(name, dt)
    is_global = ATTN[name][2]
    rng = np.random.default_rng(7)
    smax, pos = 12, 9
    shape = (2, smax, cfg.n_kv_heads, cfg.d_head)
    jk, tk = _x(rng, shape, dt)
    jv, tv = _x(rng, shape, dt)
    jx, tx = _x(rng, (2, 1, cfg.d_model), dt)
    want, jk2, jv2 = jax.jit(jattn.attention_decode,
                             static_argnums=(1, 5, 6, 7))(
        tree, cfg, jx, jk, jv, pos, is_global, JDT[dt])
    got = tattn.attention_decode(mod, _tcfg(cfg), tx, tk, tv, pos, is_global,
                                 TDT[dt])
    assert _rel(got, want) <= TOL[dt]
    assert _rel(tk, jk2) <= TOL[dt] and _rel(tv, jv2) <= TOL[dt]
    with pytest.raises(ValueError, match="decode position"):
        tattn.attention_decode(mod, _tcfg(cfg), tx, tk, tv, smax, is_global,
                               TDT[dt])


def _moe_case(arch, dt, **over):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt, **over)
    tree, _ = jmoe.moe_init(jax.random.PRNGKey(0), cfg)
    return cfg, tree, _load(tmoe.MoE(_tcfg(cfg), "cpu"), tree)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_apply_outputs_and_aux(arch, capacity_factor, dt):
    """At capacity 0.5 tokens drop (the reference's
    ``test_moe_capacity_drop_accounting``); both must drop the same ones."""
    cfg, tree, mod = _moe_case(arch, dt, capacity_factor=capacity_factor)
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, (2, 16, cfg.d_model), dt)
    want, jaux = jax.jit(jmoe.moe_apply, static_argnums=(1, 3))(
        tree, cfg, jx, JDT[dt])
    got, taux = tmoe.moe_apply(mod, _tcfg(cfg), tx, TDT[dt])
    assert got.shape == tx.shape and got.dtype == TDT[dt]
    assert _rel(got, want) <= TOL[dt]
    assert set(taux) == set(jaux)
    for k in jaux:
        assert taux[k].dtype == torch.float32
        assert abs(float(taux[k]) - float(jaux[k])) \
            <= TOL[dt] * max(abs(float(jaux[k])), 1.0), k
    if capacity_factor == 0.5:
        assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
        assert 0.0 < float(taux["dropped_frac"]) < 1.0


def test_router_breaks_ties_as_top_k():
    """Equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` orders them: a zero router makes every expert tie."""
    cfg, tree, mod = _moe_case("moonshot-v1-16b-a3b", "float32")
    with torch.no_grad():
        mod.router.zero_()
    tree = dict(tree, router=jnp.zeros_like(tree["router"]))
    x = np.random.default_rng(2).normal(size=(5, cfg.d_model))
    _, probs, gate, idx = tmoe.route(mod, _tcfg(cfg), torch.as_tensor(
        x, dtype=torch.float32), torch.float32)
    jgate, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.tile(np.arange(cfg.top_k), (5, 1)))
    np.testing.assert_allclose(gate.numpy(), 1.0 / cfg.top_k, rtol=F32_TOL)


@pytest.mark.parametrize("n_experts,shape", [(8, (64, 2)), (64, (256, 6)),
                                             (5, (3, 1))])
def test_load_stats_is_bitwise_the_reference(n_experts, shape):
    """The reference's ``test_moe_load_stats_is_a_guarded_count_query``:
    COUNT(*) GROUP BY expert equals a bincount, and the reference's
    ``load_stats``, bit for bit (some experts get no row)."""
    rng = np.random.default_rng(n_experts)
    idx = rng.integers(0, n_experts - 1, shape).astype(np.int32)
    got = tmoe.load_stats(torch.as_tensor(idx), n_experts)
    assert got.dtype == torch.int32
    want = np.asarray(jmoe.load_stats(jnp.asarray(idx), n_experts))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(idx.ravel(),
                                              minlength=n_experts))
