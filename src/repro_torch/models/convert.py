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


def from_reference_params(tree, cfg: ModelConfig, device=None) -> LM:
    """The port's model with the weights of ``tree``.  Raises ``KeyError``
    on a weight the tree lacks or a leaf no weight takes, and
    ``ValueError`` on a leaf of another shape."""
    leaves = dict(_leaves(tree))
    model = LM(cfg, device)
    used = set()
    with torch.no_grad():
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
                if arr.shape[:1] != (cfg.n_layers,):
                    raise ValueError(f"{'/'.join(path)}: {arr.shape} is not "
                                     f"stacked over {cfg.n_layers} layers")
                arr = arr[row]
            if arr.shape != tuple(w.shape):
                raise ValueError(f"{'/'.join(path)}: {arr.shape} for {name} "
                                 f"of {tuple(w.shape)}")
            w.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
            used.add(path)
    extra = sorted("/".join(p) for p in set(leaves) - used)
    if extra:
        raise KeyError(f"reference leaves no weight takes: {extra}")
    return model


def to_reference_params(model: LM, cfg: ModelConfig, tensors=None) -> dict:
    """The reference's parameter tree (nested dicts of float32 numpy
    arrays, ``layers/...`` stacked over the layers) of ``model``'s weights,
    or of ``tensors``, a map from the model's weight names to tensors of
    their shapes."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    tree: dict = {}
    stacked: dict = {}
    for name, w in model.named_parameters():
        arr = tensors[name].detach().to("cpu", torch.float32).numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            stacked.setdefault(("layers",) + tuple(parts[2:]),
                               [None] * cfg.n_layers)[int(parts[1])] = arr
        else:
            _put(tree, parts, arr)
    for path, rows in stacked.items():
        _put(tree, path, np.stack(rows))
    return tree


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
