"""The port's gradients against the JAX package's, per family, on the CPU.

For each of the ten architectures' smoke configs (``get_smoke_config``)
and the two variants of ``tests/test_torch_lm_model.py`` (``mamba2-smoke``
and ``zamba2-short-group``), in float32 here and in each config's own
dtype (bfloat16) in ``test_torch_train_families_bf16.py``: the JAX
package's ``init_params`` draws the weights (float32 masters),
``from_reference_params`` carries them into the port, and the
same seeded numpy batch (tokens, labels, patch embeddings for pixtral's
vision stub) goes through the reference's train loss under
``jax.jit(jax.value_and_grad(...))`` and through the port's
``training.train_loss`` and ``torch.autograd.grad``, both with
``remat="full"`` as ``tests/test_arch_smoke.py`` runs the reference's
families.

Bounds.  float32: the loss within 1e-5 relative, each leaf's gradient
within 1e-4 of that leaf's largest |g| (a few layers of float32 products
summed in other orders).  bfloat16: the loss within the LM model tests'
2e-2; each leaf's gradient within ``BF16_GRAD_TOL`` of its largest |g|,
the largest gap measured over the families (6.4e-2, zamba2-short-group's
``A_log``) with room.  The port rounds its bfloat16 forward where XLA
rounds the reference's on the CPU (``models/layers.py``), but XLA's
backward keeps float32 across chains of bfloat16 operations where
autograd rounds after each (a straight-through rounding before mamba2's
gated norm takes the mamba2 smoke's ``D`` from 3.4e-2 to 2.6e-2), and the
largest gaps sit on leaves whose gradient is a sum over every token that
cancels (norm weights, ``A_log``, ``D``): on them each package's own
bfloat16 gradient is 2-25% off its float32 gradient, and the two packages
agree 1.6-4× closer than either does with float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro.training.losses import cross_entropy_loss as jce
from repro_torch import training as tt
from repro_torch.models import ModelConfig
from repro_torch.models.convert import from_reference_params, \
    to_reference_params

jax.config.update("jax_platform_name", "cpu")

VARIANTS = {
    "mamba2-smoke": ("zamba2-1.2b", {"family": "mamba2",
                                     "name": "mamba2-smoke"}),
    "zamba2-short-group": ("zamba2-1.2b", {"n_layers": 5}),
}
NAMES = (*jconfigs.ARCHS, *VARIANTS)
B, S = 2, 16
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4}
BF16_GRAD_TOL = 7.5e-2


def _smoke(name: str):
    if name in VARIANTS:
        arch, over = VARIANTS[name]
        return dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    return jconfigs.get_smoke_config(name)


def ref_loss(params, cfg, batch, remat):
    """``src/repro/training/step.py``'s ``loss_fn`` (a closure there)."""
    logits, aux = jm.forward(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub":
        pad = jnp.full(labels.shape[:1] + (cfg.num_patches,), -1,
                       labels.dtype)
        labels = jnp.concatenate([pad, labels], axis=1)
    loss, metrics = jce(logits, labels)
    if cfg.family == "moe" and aux is not None:
        loss = loss + cfg.router_aux_weight * aux["load_balance"] \
            + cfg.router_z_weight * aux["router_z"]
    return loss


def batches(cfg, seed=1):
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
          "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        nb["image_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.as_tensor(v) for k, v in nb.items()})


@functools.lru_cache(maxsize=None)
def _tree(name):
    cfg = dataclasses.replace(_smoke(name), dtype="float32")
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jm.init_params(key, cfg)[0])(jax.random.PRNGKey(1)))


def grads_both(name: str, dtype: str):
    """(reference loss, port loss, [(leaf path, reference grad, port
    grad)]) for ``name``'s smoke config in ``dtype``."""
    cfg = dataclasses.replace(_smoke(name), dtype=dtype)
    tree = _tree(name)
    jb, tb = batches(cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss(p, cfg, b, "full")))
    jloss, jgrad = fn(jax.tree.map(jnp.asarray, tree), jb)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    model = from_reference_params(tree, tcfg, "cpu")
    state = tt.init_train_state(model)
    loss, _ = tt.train_loss(model, tcfg, tb, remat="full")
    grads = torch.autograd.grad(loss, list(state.params.values()))
    got = to_reference_params(model, tcfg, dict(zip(state.params, grads)))
    leaves = []
    for path, want in jax.tree_util.tree_leaves_with_path(jgrad):
        g = got
        for k in path:
            g = g[k.key]
        leaves.append(("/".join(k.key for k in path),
                       np.asarray(want, np.float64), g.astype(np.float64)))
    return float(jloss), float(loss.detach()), leaves


def leaf_gaps(leaves) -> dict:
    """Each leaf's max |port − reference| over its largest reference |g|."""
    out = {}
    for path, want, got in leaves:
        assert got.shape == want.shape, path
        out[path] = float(np.abs(got - want).max()
                          / max(np.abs(want).max(), 1e-30))
    return out


def check_gradients(name: str, dtype: str) -> None:
    jloss, loss, leaves = grads_both(name, dtype)
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_TOL[dtype] * abs(jloss), (loss, jloss)
    gaps = leaf_gaps(leaves)
    tol = GRAD_TOL.get(dtype, BF16_GRAD_TOL)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= tol, (worst, gaps[worst])


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_the_reference(name):
    """float32 (``test_torch_train_families_bf16.py`` holds bfloat16)."""
    check_gradients(name, "float32")
