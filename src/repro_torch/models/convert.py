"""Weights carried across from the JAX package's parameter tree.

``from_reference_params(tree, cfg, device)`` takes the tree the JAX
package's ``init_params`` returns, as nested dicts of numpy arrays, and
returns the port's ``LM`` holding the same float32 values.  The port names
its weights by the tree's keys, so the map is mechanical: ``layers/<path>``
is stacked ``[L, ...]`` and row ``i`` fills ``layers.<i>.<path>`` (for the
recurrent families ``layers/mixer/<leaf>`` fills ``layers.<i>.mixer.<leaf>``);
every other leaf, the hybrid's unstacked ``shared/...`` among them, fills
the weight of its own path.
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
