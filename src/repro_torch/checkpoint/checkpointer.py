"""Async, atomic checkpoints in the JAX package's on-disk format.

The port of the JAX package's ``checkpoint/checkpointer.py``.

Layout: ``<dir>/step_<N>/manifest.json``, ``{"step": N, "leaves": {key:
{"file", "shape", "dtype"}}}``, and one ``.npy`` per leaf, named
``leaf_<i>.npy`` by the key's index in sorted order.  A key is the leaf's
path in the reference's pytree, joined by ``/``: dict keys, list and
tuple indices, a dataclass's fields by position.  A ``TrainState``
flattens as the reference's does: ``0/<path>`` for the parameters, ``1/0``
for AdamW's step, ``1/1/<path>`` and ``1/2/<path>`` for ``m`` and ``v``,
``2`` for the step, with the parameter tree's paths (``models.convert``;
``layers/...`` stacked over the layers).  So a checkpoint written by
either package restores in the other.

Each leaf keeps its dtype.  numpy has no bfloat16: a bfloat16 leaf is
written as the reference writes one (its 2-byte words under the ``.npy``
descriptor ``<V2``, ``"bfloat16"`` in the manifest), and every leaf is
read back in the manifest's dtype, never in the ``.npy`` header's.  The
reference's own restore fails on such a leaf (a void type is no JAX
array type).

``save`` copies every leaf to host memory, pinned for CUDA tensors and
kept from one save to the next, and waits for the copies before it
returns: a step that updates the state in place after ``save`` returns
never reaches the files.  Only the file writing runs on the background
thread.  A save lands in ``step_<N>.tmp`` and is renamed once its
manifest is written, so ``latest_step`` never sees a torn one.  ``save``
and ``restore`` first join the write in flight, and re-raise its error.

On a mesh (a state of DTensors, ``training.place_train_state``) ``save``
is a collective: every rank calls it and gathers each leaf whole, and rank
0 alone writes the same files; ``wait`` (and so the next ``save`` and
``restore``) is then a barrier of the default process group, after which
every rank sees the files.  ``restore(shardings=...)`` takes the tree of
``NamedSharding``s that ``launch.inputs.state_shardings`` gives and hands
each rank its own blocks, whatever mesh the checkpoint was written from.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import NamedSharding, mesh_device
from repro_torch.models.convert import reference_rows, split_reference
from repro_torch.models.model import LM
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.step import (
    TrainState,
    param_shardings,
    placed_model,
)

# the .npy descriptor numpy writes for ml_dtypes' bfloat16, as the JAX
# package saves it
_BF16_DESCR = "<V2"
_STEP_DIR = re.compile(r"step_(\d+)")
# a TrainState's children in the reference's pytree, their paths' prefixes
_PARAMS, _OPT_STEP, _M, _V, _STEP = "0", "1/0", "1/1", "1/2", "2"


def _key(prefix: str, part) -> str:
    return f"{prefix}/{part}" if prefix else str(part)


def _children(tree) -> list:
    """(key part, child) of a dict, list, tuple or dataclass instance."""
    if isinstance(tree, dict):
        return list(tree.items())
    if type(tree) in (list, tuple):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(i, getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}: leaves are "
                    f"tensors in dicts, lists, tuples and dataclasses")


def _flatten(tree, prefix: str = "") -> dict:
    """``tree``'s leaves by key: tensors, and each ``layers/...`` leaf of
    a ``TrainState`` as the list of its rows."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, TrainState):
        cfg = tree.model.cfg
        out = {_key(prefix, _OPT_STEP): tree.opt.step,
               _key(prefix, _STEP): tree.step}
        for sub, tensors in ((_PARAMS, None), (_M, tree.opt.m),
                             (_V, tree.opt.v)):
            for path, leaf in reference_rows(tree.model, cfg,
                                             tensors).items():
                out[_key(prefix, "/".join((sub,) + path))] = leaf
        return out
    out = {}
    for part, child in _children(tree):
        out.update(_flatten(child, _key(prefix, part)))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _write_npy(path: pathlib.Path, t: torch.Tensor) -> None:
    """``t`` (on the host) as ``np.save`` writes it; bfloat16 as the JAX
    package's ``np.save`` of an ml_dtypes array writes it."""
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    words = t.view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": words.shape})
        words.tofile(f)


def _read_npy(path: pathlib.Path, entry: dict) -> torch.Tensor:
    """The leaf ``entry`` of a manifest names, on the host, in the
    manifest's dtype (the header's may be the void type of a bfloat16
    leaf)."""
    dtype = getattr(torch, entry["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{path}: unknown dtype {entry['dtype']!r}")
    arr = np.load(path)
    if list(arr.shape) != list(entry["shape"]) \
            or arr.dtype.itemsize != dtype.itemsize:
        raise ValueError(f"{path}: {arr.dtype}{list(arr.shape)} on disk for "
                         f"{entry['dtype']}{entry['shape']} in the manifest")
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.view(np.dtype(entry["dtype"])))


def _subtree(leaves: dict, prefix: str) -> dict:
    """The leaves under ``prefix``, keyed by their paths below it."""
    head = prefix + "/"
    return {tuple(k[len(head):].split("/")): v for k, v in leaves.items()
            if k.startswith(head)}


def _rebuild(like, leaves: dict, prefix: str, device, shardings=None):
    """A tree of ``like``'s structure holding ``leaves`` (host tensors by
    key), each copied to ``device`` or, where that is None, to the device
    of ``like``'s leaf; with ``shardings`` (a tree of ``like``'s structure
    whose leaves are ``NamedSharding``s), each rank's blocks instead."""
    if isinstance(like, torch.Tensor):
        if shardings is not None:
            return shardings.distribute(leaves[prefix])
        return leaves[prefix].to(like.device if device is None else device,
                                 copy=True)
    if isinstance(like, TrainState):
        return _rebuild_state(like, leaves, prefix, device, shardings)
    kids = {part: _rebuild(child, leaves, _key(prefix, part), device,
                           None if shardings is None else shardings[part])
            for part, child in _children(like)}
    if isinstance(like, dict):
        return kids
    if type(like) in (list, tuple):
        return type(like)(kids.values())
    return dataclasses.replace(like, **{
        f.name: kids[i] for i, f in enumerate(dataclasses.fields(like))})


def _rebuild_state(like: TrainState, leaves: dict, prefix: str, device,
                   shardings=None):
    """A new ``TrainState`` (its own ``LM`` and tensors) of ``like``'s
    config, each weight requiring gradients as ``like``'s does; with
    ``shardings`` (``launch.inputs.state_shardings``' tree), the weights
    and moments as DTensors of this rank's blocks by the parameters'
    shardings, the step counters on the mesh's device."""
    cfg = like.model.cfg
    model = LM(cfg, "meta")
    by_name = None
    if shardings is not None:
        by_name = param_shardings(model, shardings[0])
        device = mesh_device(next(iter(by_name.values())).mesh)
    elif device is None:
        device = next(like.model.parameters()).device

    def named(sub):
        rows = split_reference(_subtree(leaves, _key(prefix, sub)), model,
                               cfg)
        if by_name is not None:
            return {n: by_name[n].distribute(t) for n, t in rows.items()}
        return {n: t.to(device, copy=True) for n, t in rows.items()}

    opt = AdamWState(
        leaves[_key(prefix, _OPT_STEP)].to(device, copy=True),
        named(_M), named(_V))
    return TrainState(placed_model(cfg, named(_PARAMS), like.model), opt,
                      leaves[_key(prefix, _STEP)].to(device, copy=True),
                      by_name)


def _sharding_keys(tree, prefix: str = "") -> set:
    """The keys of a tree of ``NamedSharding``s (dicts, lists, tuples);
    ``TypeError`` on any other leaf."""
    if isinstance(tree, NamedSharding):
        return {prefix}
    if isinstance(tree, dict):
        items = tree.items()
    elif type(tree) in (list, tuple):
        items = enumerate(tree)
    else:
        raise TypeError(f"shardings must be a torch.device for every leaf "
                        f"or a tree of NamedShardings "
                        f"(launch.inputs.state_shardings), not a "
                        f"{type(tree).__name__} at {prefix or 'the root'}")
    return {k for part, child in items
            for k in _sharding_keys(child, _key(prefix, part))}


def _whole(leaf):
    """A leaf (or a list of rows) with every DTensor gathered whole: a
    collective for each DTensor."""
    if isinstance(leaf, list):
        return [_whole(r) for r in leaf]
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


class Checkpointer:
    """Checkpoints under ``directory``; holds the host copy of the last
    save's leaves for the next one."""

    def __init__(self, directory: str | pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._host: dict[str, torch.Tensor] = {}
        self._barrier = False      # the last save was a mesh's

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, async_: bool = True):
        """Snapshot ``tree`` at ``step``: every leaf is on the host when
        this returns; with ``async_`` the files are written by a
        background thread (``wait`` joins it).  A tree holding DTensors is
        gathered on every rank and written by rank 0 (the module's
        docstring)."""
        self.wait()
        flat = _flatten(tree)
        self._barrier = any(isinstance(r, DTensor) for v in flat.values()
                            for r in (v if isinstance(v, list) else [v]))
        if self._barrier:
            with torch.no_grad():
                flat = {k: _whole(v) for k, v in flat.items()}
            if dist.get_rank() != 0:
                if not async_:
                    self.wait()
                return
        host = self._snapshot(flat)

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {}
            for i, (k, v) in enumerate(sorted(host.items())):
                fname = f"leaf_{i:05d}.npy"
                _write_npy(tmp / fname, v)
                manifest[k] = {"file": fname, "shape": list(v.shape),
                               "dtype": _dtype_name(v.dtype)}
            with open(tmp / "manifest.json", "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)

        def run():
            try:
                write()
            except Exception as exc:   # re-raised by wait()
                self._error = exc

        if async_:
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        elif self._barrier:
            run()
            self.wait()
        else:
            write()

    def _snapshot(self, flat: dict) -> dict[str, torch.Tensor]:
        """Each leaf copied into its host buffer (reused when its shape
        and dtype are the last save's); returns once every copy is done."""
        host, devices = {}, set()
        with torch.no_grad():
            for key, leaf in flat.items():
                src = torch.stack(leaf) if isinstance(leaf, list) else leaf
                buf = self._host.get(key)
                if buf is None or buf.shape != src.shape \
                        or buf.dtype != src.dtype:
                    buf = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=src.is_cuda)
                buf.copy_(src, non_blocking=src.is_cuda)
                host[key] = buf
                if src.is_cuda:
                    devices.add(src.device)
        for d in devices:
            torch.cuda.synchronize(d)
        self._host = host
        return host

    def wait(self):
        """Joins the write in flight, then, after a mesh's save, waits for
        every rank; raises the write's error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        err, self._error = self._error, None
        if err is not None:
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = [int(m.group(1)) for p in self.dir.glob("step_*")
                 if (m := _STEP_DIR.fullmatch(p.name))]
        return max(steps) if steps else None

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None) -> Any:
        """A new tree of ``like``'s structure from the checkpoint at
        ``step`` (the latest by default); ``like`` is left as it is.  Each
        leaf lands on ``like``'s device, or on ``shardings``: one
        ``torch.device`` for every leaf, or a tree of ``like``'s structure
        of ``NamedSharding``s (``launch.inputs.state_shardings`` for a
        ``TrainState``), each rank then holding its own blocks."""
        self.wait()
        device, placed = None, None
        if isinstance(shardings, (torch.device, str)):
            device = torch.device(shardings)
        elif shardings is not None:
            placed = _sharding_keys(shardings)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)["leaves"]
        keys = set(_flatten(like))
        if keys != set(manifest):
            raise ValueError(
                f"checkpoint/model structure mismatch: not in the "
                f"checkpoint {sorted(keys - set(manifest))}, not in the "
                f"model {sorted(set(manifest) - keys)}")
        if placed is not None and placed != keys:
            raise ValueError(
                f"shardings/model structure mismatch: no sharding for "
                f"{sorted(keys - placed)}, no leaf for "
                f"{sorted(placed - keys)}")
        leaves = {k: _read_npy(d / manifest[k]["file"], manifest[k])
                  for k in keys}
        return _rebuild(like, leaves, "", device,
                        None if placed is None else shardings)
