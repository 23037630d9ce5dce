"""Weights carried across between the JAX package's parameter tree and the
port's model.

``from_reference_params(tree, cfg, device)`` takes the tree the JAX
package's ``init_params`` returns, as nested dicts of numpy arrays, and
returns the port's ``LM`` holding the same float32 values.  The port names
its weights by the tree's keys, so the map is mechanical: ``layers/<path>``
is stacked ``[L, ...]`` and row ``i`` fills ``layers.<i>.<path>`` (for the
recurrent families ``layers/mixer/<leaf>`` fills ``layers.<i>.mixer.<leaf>``);
every other leaf, the hybrid's unstacked ``shared/...`` among them, fills
the weight of its own path.  ``to_reference_params`` is the inverse: the
reference's tree, stacked ``[L, ...]``, of the model's weights or of any
tensors named as they are (their gradients, say).

``reference_rows`` and ``split_reference`` are the same map on tensors of
any dtype, kept as they are: the checkpointer writes a ``TrainState``'s
parameters and AdamW moments through them in the reference's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def reference_rows(model: LM, cfg: ModelConfig, tensors=None) -> dict:
    """The leaves of the reference's parameter tree, by path, of
    ``model``'s weights or of ``tensors`` (a map from the model's weight
    names to tensors of their shapes): a ``layers/...`` leaf as the list
    of its rows, layer 0 first, every other leaf as its tensor, each in
    its own dtype on its own device."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    out: dict = {}
    for name, _ in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] == "layers":
            out.setdefault(("layers",) + parts[2:],
                           [None] * cfg.n_layers)[int(parts[1])] = \
                tensors[name]
        else:
            out[parts] = tensors[name]
    return out


def split_reference(leaves: dict, model: LM, cfg: ModelConfig) -> dict:
    """The inverse of ``reference_rows``: from the reference tree's leaves
    by path (numpy arrays or tensors, ``layers/...`` stacked over the
    layers), each of ``model``'s weight names with its leaf or row, in the
    leaf's own dtype.  Raises ``KeyError`` on a weight the leaves lack or a
    leaf no weight takes, and ``ValueError`` on a leaf of another shape."""
    out, used = {}, set()
    for name, w in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] == "layers":
            path, row = ("layers",) + parts[2:], int(parts[1])
        else:
            path, row = parts, None
        if path not in leaves:
            raise KeyError(f"the reference tree has no leaf "
                           f"{'/'.join(path)} for {name}")
        arr = leaves[path]
        if row is not None:
            if tuple(arr.shape[:1]) != (cfg.n_layers,):
                raise ValueError(f"{'/'.join(path)}: {tuple(arr.shape)} is "
                                 f"not stacked over {cfg.n_layers} layers")
            arr = arr[row]
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"{'/'.join(path)}: {tuple(arr.shape)} for "
                             f"{name} of {tuple(w.shape)}")
        out[name] = arr
        used.add(path)
    extra = sorted("/".join(p) for p in set(leaves) - used)
    if extra:
        raise KeyError(f"reference leaves no weight takes: {extra}")
    return out


def from_reference_params(tree, cfg: ModelConfig, device=None) -> LM:
    """The port's model with the weights of ``tree``.  Raises ``KeyError``
    on a weight the tree lacks or a leaf no weight takes, and
    ``ValueError`` on a leaf of another shape."""
    model = LM(cfg, device)
    named = split_reference(dict(_leaves(tree)), model, cfg)
    with torch.no_grad():
        for name, w in model.named_parameters():
            w.copy_(torch.from_numpy(np.array(named[name],
                                              dtype=np.float32)))
    return model


def to_reference_params(model: LM, cfg: ModelConfig, tensors=None) -> dict:
    """The reference's parameter tree (nested dicts of float32 numpy
    arrays, ``layers/...`` stacked over the layers) of ``model``'s weights,
    or of ``tensors``, a map from the model's weight names to tensors of
    their shapes."""
    tree: dict = {}
    for path, leaf in reference_rows(model, cfg, tensors).items():
        rows = leaf if isinstance(leaf, list) else [leaf]
        arrs = [r.detach().to("cpu", torch.float32, copy=True).numpy()
                for r in rows]
        _put(tree, path, np.stack(arrs) if isinstance(leaf, list)
             else arrs[0])
    return tree


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
