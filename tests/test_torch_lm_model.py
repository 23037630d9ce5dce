"""The port's LM models against the JAX package's, on the CPU.

For each of the ten architectures, its smoke config (``get_smoke_config``)
in float32 and bfloat16, plus two variants of zamba2's: the ``mamba2``
family (the same widths without the shared block) and a hybrid of 5
layers, whose last group is short (groups [2, 2, 1]), so that an
off-by-one between the groups' cache slots cannot pass by chance.  The
JAX package's ``init_params`` draws the weights,
``from_reference_params`` carries them into the port, and the same seeded
numpy tokens (plus patch embeddings for pixtral's vision stub) go through
``forward``, ``prefill`` and three ``decode_step``s of both packages.  The
reference runs under ``jax.jit``, as its serving loop runs it, once per
case and dtype (module-scoped fixtures).  Logits must agree within 1e-4 of
their largest magnitude in float32 (a few layers of float32 matmuls summed
in different orders) and 2e-2 in bfloat16 (bfloat16 rounds at 2^-8; the
port rounds where XLA does, ``models/layers.py``); the MoE aux values
within the same bounds, and the recurrent families return no aux.

Also: the configs equal the JAX package's, each family's weights are the
reference's leaves at every width (on the meta device) and drawn as its
initialiser draws them, an unknown family raises, ``from_reference_params``
refuses a tree that does not fit, and the LM modules import neither JAX
nor the JAX package.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.models import ModelConfig
from repro_torch.models.convert import from_reference_params

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# variants of a smoke config: (architecture, fields replaced)
VARIANTS = {
    "mamba2-smoke": ("zamba2-1.2b", {"family": "mamba2",
                                     "name": "mamba2-smoke"}),
    "zamba2-short-group": ("zamba2-1.2b", {"n_layers": 5}),
}
CASES = [(a, dt) for a in (*jconfigs.ARCHS, *VARIANTS)
         for dt in ("float32", "bfloat16")]
B, S, STEPS = 2, 16, 3
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _rel(got: torch.Tensor, want) -> float:
    g = got.to(torch.float64).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _tcfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _smoke(name: str):
    """The reference's smoke config of an architecture or a variant."""
    if name in VARIANTS:
        arch, over = VARIANTS[name]
        return dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    return jconfigs.get_smoke_config(name)


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The JAX package's weights for ``name``'s smoke config (seed 0),
    drawn once for both dtypes."""
    cfg = _smoke(name)
    return jax.jit(lambda key: jm.init_params(key, cfg)[0])(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=CASES,
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """Both packages' outputs for one smoke config and dtype."""
    name, dt = request.param
    cfg = dataclasses.replace(_smoke(name), dtype=dt)
    params = _tree(name)
    tcfg = _tcfg(cfg)
    model = from_reference_params(jax.tree.map(np.asarray, params), tcfg,
                                  "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if cfg.frontend == "vision_stub":
        img = rng.normal(size=(B, cfg.num_patches, cfg.d_model))
        jb["image_embeds"] = jnp.asarray(img, jnp.float32)
        tb["image_embeds"] = torch.as_tensor(img, dtype=torch.float32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    sp = S + cfg.num_patches
    out = {"cfg": cfg, "tcfg": tcfg, "model": model, "want": {}, "got": {}}

    logits, aux = jax.jit(jm.forward, static_argnums=1)(params, cfg, jb)
    out["want"]["forward"], out["want"]["aux"] = logits, aux
    out["got"]["forward"], out["got"]["aux"] = tm.forward(model, tcfg, tb)

    jpre = jax.jit(jm.prefill, static_argnums=1)
    jdec = jax.jit(jm.decode_step, static_argnums=1)
    cache = jm.init_decode_state(cfg, B, sp + STEPS)
    logits, cache = jpre(params, cfg, jb, cache)
    want = [logits]
    for t in steps:
        logits, cache = jdec(params, cfg, jnp.asarray(t), cache)
        want.append(logits)
    out["want"]["prefill"], out["want"]["decode"] = want[0], want[1:]

    cache = tm.init_decode_state(tcfg, B, sp + STEPS, "cpu")
    logits, cache = tm.prefill(model, tcfg, tb, cache)
    got = [logits]
    for t in steps:
        logits, cache = tm.decode_step(model, tcfg, torch.as_tensor(t),
                                       cache)
        got.append(logits)
    out["got"]["prefill"], out["got"]["decode"] = got[0], got[1:]
    out["pos"] = cache["pos"]
    return out


def test_forward_logits(case):
    cfg, got = case["cfg"], case["got"]["forward"]
    assert got.shape == (B, S + cfg.num_patches, cfg.vocab_size)
    assert got.dtype == cfg_dtype(cfg)
    assert _rel(got, case["want"]["forward"]) <= TOL[cfg.dtype]


def test_forward_aux(case):
    cfg, got, want = case["cfg"], case["got"]["aux"], case["want"]["aux"]
    if want is None:
        assert cfg.family in ("rwkv6", "mamba2", "hybrid") and got is None
        return
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        w = float(want[k])
        assert abs(float(got[k]) - w) <= TOL[cfg.dtype] * max(abs(w), 1.0), k
    if cfg.family == "dense":
        assert all(float(v) == 0.0 for v in got.values())


def test_prefill_logits(case):
    cfg, got = case["cfg"], case["got"]["prefill"]
    assert got.shape == (B, cfg.vocab_size)
    assert _rel(got, case["want"]["prefill"]) <= TOL[cfg.dtype]


def test_decode_step_logits(case):
    cfg = case["cfg"]
    assert case["pos"] == S + cfg.num_patches + STEPS
    for i, (got, want) in enumerate(zip(case["got"]["decode"],
                                        case["want"]["decode"])):
        assert got.shape == (B, cfg.vocab_size)
        assert _rel(got, want) <= TOL[cfg.dtype], i


def cfg_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.compute_dtype == cfg_dtype(got)
    assert tconfigs.cells_for(arch) == jconfigs.cells_for(arch)


def test_registry_equals_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


def test_unknown_family_raises():
    """As the reference's ``init_params`` and ``init_decode_state`` raise
    ``ValueError(cfg.family)``."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("smollm-135m"),
                              family="retnet")
    with pytest.raises(ValueError, match="retnet"):
        tm.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="retnet"):
        from_reference_params({}, cfg, "cpu")
    with pytest.raises(ValueError, match="retnet"):
        tm.init_decode_state(cfg, 1, 8, "cpu")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "mamba2-smoke"])
def test_full_width_weights_are_the_reference_leaves(arch):
    """At the published widths and depth, on the meta device (no memory):
    every weight of the port is a leaf of the reference's tree of the same
    shape (``layers/...`` stacked over the layers), and no leaf is left
    over."""
    if arch in VARIANTS:
        base, over = VARIANTS[arch]
        jcfg = dataclasses.replace(jconfigs.get_config(base), **over)
    else:
        jcfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda key: jm.init_params(key, jcfg)[0],
                            jax.random.PRNGKey(0))
    want = {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {}
    for name, w in tm.LM(ModelConfig(**dataclasses.asdict(jcfg)),
                         "meta").named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key = "/".join(["layers"] + parts[2:])
            assert got.setdefault(key, (jcfg.n_layers, *w.shape)) \
                == (jcfg.n_layers, *w.shape), name
        else:
            got["/".join(parts)] = tuple(w.shape)
    assert got == want


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "mamba2-smoke"])
def test_init_params_draws_the_mixers_as_the_reference(arch):
    """Each constant leaf (token-shift mixes 0.5, decay bias −6, bonus and
    norms 0, A_log 0, D 1, dt_bias 0) equals the reference's; each drawn
    leaf has the reference's scale (``ww`` a tenth of ``dense_init``)."""
    cfg = ModelConfig(**dataclasses.asdict(_smoke(arch)))
    model = tm.init_params(cfg, seed=1, device="cpu")
    tree = jax.tree.map(np.asarray, _tree(arch))
    consts = {"mu", "ffn_mu", "w_bias", "u", "norm_w", "ln1", "ln2",
              "final_norm", "A_log", "D", "dt_bias"}
    seen = set()
    for name, w in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            ref = tree["layers"]
            for k in parts[2:]:
                ref = ref[k]
            ref = ref[int(parts[1])]
        else:
            ref = tree
            for k in parts:
                ref = ref[k]
        leaf = parts[-1]
        if leaf in consts:
            assert np.array_equal(w.numpy(), ref), name
            seen.add(leaf)
        else:
            assert abs(float(w.std()) / float(ref.std()) - 1.0) < 0.1, name
    family = {"rwkv6": {"mu", "ffn_mu", "w_bias", "u", "norm_w"},
              "mamba2": {"A_log", "D", "dt_bias", "norm_w"}}
    assert family["rwkv6" if cfg.family == "rwkv6" else "mamba2"] <= seen


def test_from_reference_params_refuses_a_hybrid_tree_without_shared():
    cfg = tconfigs.get_smoke_config("zamba2-1.2b")
    tree = jax.tree.map(np.asarray, _tree("zamba2-1.2b"))
    model = from_reference_params(tree, cfg, "cpu")
    assert np.array_equal(model.shared.attn.wq.numpy(),
                          tree["shared"]["attn"]["wq"])
    assert np.array_equal(model.layers[3].mixer.conv_w.numpy(),
                          tree["layers"]["mixer"]["conv_w"][3])
    with pytest.raises(KeyError, match="shared/"):
        from_reference_params({k: v for k, v in tree.items()
                               if k != "shared"}, cfg, "cpu")
    mamba = dataclasses.replace(cfg, family="mamba2")
    with pytest.raises(KeyError, match="shared"):
        from_reference_params(tree, mamba, "cpu")


def test_forward_refuses_remat_until_the_training_slice():
    """The training slice brought the reference's three policies: each
    gives ``forward``'s logits, and any other name raises."""
    cfg = tconfigs.get_smoke_config("smollm-135m")
    model = tm.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    want, _ = tm.forward(model, cfg, batch)
    for remat in ("full", "dots"):
        assert torch.equal(tm.forward(model, cfg, batch, remat=remat)[0],
                           want)
    with pytest.raises(ValueError, match="remat='nothing'"):
        tm.forward(model, cfg, batch, remat="nothing")


def test_decode_past_the_cache_raises():
    """The reference's dynamic_update_slice would clamp silently."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("smollm-135m"),
                              dtype="float32")
    model = tm.init_params(cfg, seed=0, device="cpu")
    cache = tm.init_decode_state(cfg, 1, 5, "cpu")
    ones = {n: torch.ones((1, n), dtype=torch.int32) for n in (4, 6)}
    _, cache = tm.prefill(model, cfg, {"tokens": ones[4]}, cache)
    tok = torch.ones((1, 1), dtype=torch.int32)
    _, cache = tm.decode_step(model, cfg, tok, cache)
    assert cache["pos"] == 5
    with pytest.raises(ValueError, match="decode position 5"):
        tm.decode_step(model, cfg, tok, cache)
    with pytest.raises(ValueError, match="prefill of 6"):
        tm.prefill(model, cfg, {"tokens": ones[6]},
                   tm.init_decode_state(cfg, 1, 5, "cpu"))


def test_init_params_is_seeded_and_shaped_as_the_reference():
    cfg = tconfigs.get_smoke_config("moonshot-v1-16b-a3b")
    a = tm.init_params(cfg, seed=3, device="cpu")
    b = tm.init_params(cfg, seed=3, device="cpu")
    c = tm.init_params(cfg, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.mlp.wi"], sc["layers.0.mlp.wi"])
    assert float(sa["layers.1.ln2"].abs().sum()) == 0.0
    n = sum(v.numel() for v in sa.values())
    assert n == sum(np.asarray(x).size
                    for x in jax.tree.leaves(_tree("moonshot-v1-16b-a3b")))
    # every draw scaled as the reference's: 1/sqrt(fan_in), 0.02 for rows
    assert abs(float(sa["layers.0.mlp.wi"].std()) * cfg.d_model ** 0.5
               - 1.0) < 0.05
    assert abs(float(sa["embed.embedding"].std()) / 0.02 - 1.0) < 0.05


def test_default_device_is_the_gpu():
    """Without a card, an entry point not told the CPU raises, never
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_decode_state(cfg, 1, 8)


def test_from_reference_params_refuses_a_tree_that_does_not_fit():
    cfg = tconfigs.get_smoke_config("smollm-135m")
    tree = jax.tree.map(np.asarray, _tree("smollm-135m"))
    model = from_reference_params(tree, cfg, "cpu")
    assert np.array_equal(model.layers[1].attn.wq.numpy(),
                          tree["layers"]["attn"]["wq"][1])
    missing = {**tree, "layers": {k: v for k, v in tree["layers"].items()
                                  if k != "ln2"}}
    with pytest.raises(KeyError, match="layers/ln2"):
        from_reference_params(missing, cfg, "cpu")
    extra = {**tree, "stray": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="stray"):
        from_reference_params(extra, cfg, "cpu")
    wrong = {**tree, "final_norm": np.zeros(5, np.float32)}
    with pytest.raises(ValueError, match="final_norm"):
        from_reference_params(wrong, cfg, "cpu")
    deeper = dataclasses.replace(cfg, n_layers=3)
    with pytest.raises(ValueError, match="stacked over 3 layers"):
        from_reference_params(tree, deeper, "cpu")


LM_DIRS = ("configs", "models", "launch", "serving")


def test_lm_modules_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    files = [f for d in LM_DIRS for f in sorted((SRC / d).glob("*.py"))]
    assert len(files) >= 21
    assert {SRC / "models" / "rwkv6.py", SRC / "models" / "mamba2.py"} \
        <= set(files)
    for f in files:
        assert not pat.search(f.read_text()), f
