"""Meta-device stand-ins and shardings for every (arch × shape) cell.

The port of the JAX package's ``launch/inputs.py``: ``input_specs(cfg,
cell)`` gives every model input of one shape cell as a tensor on the meta
device (the reference's ``ShapeDtypeStruct``s), ``abstract_params`` the
parameter tree's shapes and logical specs, and ``to_named_shardings`` /
``batch_shardings`` each leaf's ``NamedSharding`` on a mesh, by the
logical rules (``distributed.sharding``).  Nothing is allocated.
``state_shardings`` is the tree a ``TrainState`` is placed and restored
by, and ``abstract_cache`` the decode caches' shapes and logical specs.
``serving_shardings`` gives the reference's serving in-shardings (its
``lower_prefill_cell`` / ``lower_decode_cell``), by which ``place_params``
and ``place_cache`` lay out a served model's weights and decode caches.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ShapeCell
from repro_torch.distributed.sharding import (
    NamedSharding,
    resolve_spec,
    use_mesh,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_rows
from repro_torch.models.model import (
    LM,
    decode_state_specs,
    init_decode_state,
    param_specs,
)
from repro_torch.training.step import param_shardings, placed_model


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract model inputs for one shape cell."""
    b, s = cell.global_batch, cell.seq_len
    s_txt = s - (cfg.num_patches if cfg.frontend == "vision_stub" else 0)
    if cell.kind in ("train", "prefill"):
        out = {"tokens": sds((b, s_txt), torch.int32)}
        if cell.kind == "train":
            out["labels"] = sds((b, s_txt), torch.int32)
        if cfg.frontend == "vision_stub":
            out["image_embeds"] = sds((b, cfg.num_patches, cfg.d_model),
                                      torch.float32)
        return out
    if cell.kind == "decode":
        return {"tokens": sds((b, 1), torch.int32)}
    raise ValueError(cell.kind)


def batch_shardings(mesh, specs_tree: dict) -> dict:
    """Batch inputs shard over ("pod","data") on dim 0 (shape-aware: a
    batch of 1 falls back to replication)."""
    def one(x):
        axes = ("batch",) + (None,) * (x.dim() - 1)
        with use_mesh(mesh):
            return NamedSharding(mesh, resolve_spec(tuple(x.shape), axes))

    return {k: one(x) for k, x in specs_tree.items()}


def abstract_params(cfg: ModelConfig, dtype=None):
    """(the parameter tree's shapes as meta tensors, its logical-spec
    tree), both by the reference tree's paths as nested dicts, a
    ``layers/...`` leaf stacked ``[L, ...]``; ``dtype`` replaces float32."""
    model = LM(cfg, "meta")
    shapes: dict = {}
    for path, leaf in reference_rows(model, cfg).items():
        shape = (cfg.n_layers, *leaf[0].shape) if isinstance(leaf, list) \
            else tuple(leaf.shape)
        node = shapes
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = sds(shape, dtype or torch.float32)
    return shapes, param_specs(cfg)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    """(the decode caches as meta tensors, their logical-spec tree
    ``decode_state_specs``): each cache the shape and dtype
    ``init_decode_state`` gives it; ``pos``, which ``init_decode_state``
    keeps as a host integer, is the reference's 0-d int32 leaf (spec
    ``()``)."""
    shapes = init_decode_state(cfg, batch, max_len, device="meta")
    shapes["pos"] = sds((), torch.int32)
    return shapes, decode_state_specs(cfg)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def to_named_shardings(mesh, spec_tree, shapes_tree, rules=None):
    """A logical-axis spec tree (dicts, lists and tuples whose leaves are
    tuples of axis names) mapped to shape-aware ``NamedSharding``s on
    ``mesh`` under ``rules`` (the divisibility fallbacks are
    ``resolve_spec``'s)."""
    if _is_spec(spec_tree):
        with use_mesh(mesh, rules):
            return NamedSharding(mesh, resolve_spec(tuple(shapes_tree.shape),
                                                    spec_tree))
    if isinstance(spec_tree, dict):
        return {k: to_named_shardings(mesh, v, shapes_tree[k], rules)
                for k, v in spec_tree.items()}
    return type(spec_tree)(to_named_shardings(mesh, v, s, rules)
                           for v, s in zip(spec_tree, shapes_tree))


def state_shardings(cfg: ModelConfig, mesh, rules=None) -> tuple:
    """A ``TrainState``'s shardings in the reference's tree order:
    ``(params, (AdamW's step, m, v), step)``, the moments sharded as the
    parameters, the step counters replicated."""
    pshapes, pspecs = abstract_params(cfg)
    params = to_named_shardings(mesh, pspecs, pshapes, rules)
    rep = NamedSharding(mesh, ())
    return params, (rep, params, params), rep


def serving_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int,
                      rules=None) -> tuple:
    """``(parameters, caches)``: the ``NamedSharding`` trees of the
    bfloat16 parameters (``abstract_params(cfg, dtype=torch.bfloat16)``)
    and of the decode caches (``abstract_cache``'s shapes, laid out by
    ``decode_state_specs``) on ``mesh`` under ``rules``, as the reference
    places a served model (``src/repro/launch/dryrun.py:115-147``)."""
    pshapes, pspecs = abstract_params(cfg, dtype=torch.bfloat16)
    cshapes, cspecs = abstract_cache(cfg, batch, max_len)
    return (to_named_shardings(mesh, pspecs, pshapes, rules),
            to_named_shardings(mesh, cspecs, cshapes, rules))


def place_params(model: LM, shardings: dict,
                 dtype: torch.dtype | None = torch.bfloat16) -> LM:
    """A new model holding ``model``'s weights in ``dtype`` (their own
    where None) laid out by ``shardings`` (the parameter tree of
    ``serving_shardings``): each a DTensor of this rank's block, which the
    rank copies from the whole weight (no communication), requiring no
    gradients."""
    by_name = param_shardings(model, shardings)
    with torch.no_grad():
        weights = {n: by_name[n].distribute(w if dtype is None
                                            else w.to(dtype))
                   for n, w in model.named_parameters()}
    return placed_model(model.cfg, weights, model)


def place_cache(cache: dict, shardings: dict) -> dict:
    """``cache`` (whole decode caches, the same on every rank) laid out by
    ``shardings`` (the cache tree of ``serving_shardings``): each cache a
    DTensor of this rank's block, which the rank copies (no
    communication); ``pos`` stays a host integer."""
    with torch.no_grad():
        return {k: v if k == "pos" else shardings[k].distribute(v)
                for k, v in cache.items()}
