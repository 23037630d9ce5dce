"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake ranks.

The port of the JAX package's ``launch/dryrun.py``.  Where the reference
forces 512 host devices and lowers and compiles each cell, this runs the
port's own code once per cell with no card and no allocation: a
``torch.distributed`` process group of the ``"fake"`` backend at the
mesh's world size (``fake_world``; every collective returns at once), the
production ``DeviceMesh`` over it on the CPU device type, and every tensor
a ``FakeTensorMode`` fake (shapes and dtypes, no storage).  For each cell
it reports:

  * that the shardings are coherent: the state is placed on the mesh by
    the logical rules and the step runs on it;
  * per-rank bytes: the arguments' from their placements, the outputs',
    and ``MemTracker``'s peak of the trace (does it fit the card's 80 GB?);
  * FLOPs (``FlopCounterMode``: matmuls, attention, convolutions);
  * the collective schedule (``CollectiveMode``, ``collective_bytes``;
    ``collective_ops_by_name`` counts the ops by their torch names).

A train cell is one mesh step (``training.step``, ``microbatches =
global_batch // microbatch``, ``remat="full"``) traced on rank 0: every
rank holds equal blocks (``resolve_spec`` shards a dim only by axes that
divide it) and runs the same step, so rank 0's numbers are every rank's.
A dense or MoE model's prefill or decode cell (``SERVE_FAMILIES``) is
traced the same way, ``"scope": "rank"``: ``prefill`` or ``decode_step``
(at position 0 of a fresh cache, which it attends whole) under
``use_mesh`` on rank 0, from its bfloat16 parameters and caches placed
as the reference places them (``launch.inputs.serving_shardings``) and
its batch by the batch rule.  A MoE layer there runs the placed layer
of the train step on the whole batch's capacity and first-come
positions: per rank and layer one ``allreduce_`` of the ``[blocks, e]``
int32 count table (``moe.first_come``), the dispatch buffer's
reduce-scatters onto the expert blocks and the combine's gathers.  The
recurrent families' serving cells are traced whole on one fake device
(``"scope": "cell"``, the whole cell's memory under ``"cell_memory"``,
no collectives): their per-rank argument bytes come from the placements
alone.

What has no counterpart: the reference's ``bytes_accessed`` (XLA's cost
analysis) and ``generated_code_bytes`` (there is no compiled program),
and the HLO text its collectives are parsed from (they are counted as the
trace issues them).  What the numbers do not count:

  * the trace runs the port's CPU code, so a bfloat16 product is taken in
    float32 and rounded once (``models.layers.matmul``): the float32
    copies of its operands are in the peak, where the card multiplies in
    bfloat16;
  * the mesh step is handed the whole global batch on every rank: the
    peak holds it whole, ``argument_bytes`` counts each rank's block of it
    (the reference's ``batch_shardings``), and ``temp_bytes`` is the peak
    less ``argument_bytes``;
  * on a CPU mesh DTensor moves a shard from one tensor dim to another
    (the dense step's annotation points) by an all-gather of the whole
    tensor and a chunk, where NCCL runs an all-to-all of the block: the
    trace takes the card's route (``_card_redistribution``), so the record
    counts the all-to-all and the peak holds only the block;
  * DTensor infers each op's output metadata by running it on fakes of
    the whole, unsharded shapes: those are not tensors of the step and
    are not counted (``PeakTracker``);
  * no allocator: the peak is the largest sum of live tensors' storage
    bytes, without the caching allocator's rounding and fragmentation, the
    CUDA context or NCCL's buffers.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh multi --out results.json
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import functools
import json
import math
import multiprocessing
import os
import threading
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config
from repro_torch.distributed.sharding import (
    batch_group,
    batch_row_blocks,
    mesh_device,
    mesh_sizes,
    spec_axes,
    use_mesh,
)
from repro_torch.launch.inputs import (
    abstract_cache,
    abstract_params,
    batch_shardings,
    input_specs,
    place_cache,
    place_params,
    sds,
    serving_shardings,
    state_shardings,
    to_named_shardings,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LM, decode_step, prefill
from repro_torch.training import init_train_state
from repro_torch.training.step import (
    TP_FAMILIES,
    build_train_step,
    microbatch_specs,
    place_train_state,
)

DEVICE_BYTES = 80 * 10**9   # one H100's device memory
# the families whose serving cells are traced on a rank of the mesh
SERVE_FAMILIES = ("dense", "moe")

# the reference's collective kinds (its HLO op names), and the torch ops of
# each: c10d's in-place ops and the functional collectives DTensor issues
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    # DTensor's move of a shard from one tensor dim to another
    "shard_dim_alltoall": "all-to-all",
}
# any other op of these namespaces but a wait (or the autograd wrapper of a
# functional collective's output) fails the cell: a collective of no kind
# is not dropped from the count
_C10D = ("c10d", "_c10d_functional", "c10d_functional", "_dtensor")
_NOT_COLLECTIVES = ("wait_tensor", "wait", "_wrap_tensor_autograd",
                    "mesh_get_process_group")


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """The default process group as ``rank`` of ``world_size`` on the
    ``"fake"`` backend (collectives return at once and move nothing),
    destroyed on the way out.  Refuses to start beside a real group."""
    if dist.is_initialized():
        raise RuntimeError(f"a process group ({dist.get_backend()}) is "
                           f"already initialised: the dry run starts its own")
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class CollectiveMode(TorchDispatchMode):
    """Records each collective the code under it issues, ``(op name,
    output bytes)`` in ``records``: c10d's ops and the functional
    collectives DTensor desugars into (an op on a DTensor is passed on to
    DTensor first, as ``CommDebugMode`` does).  ``CommDebugMode`` itself
    counts no bytes, and its module tracker fails on a module called once
    a microbatch under remat (the MoE layer)."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name in KIND_OF:
            self.records.append((name, sum(
                t.numel() * t.element_size() for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))))
        elif func.namespace in _C10D and name not in _NOT_COLLECTIVES:
            raise NotImplementedError(f"collective {func} has no kind")
        return out


def collective_bytes(records) -> dict:
    """The counterpart of the reference's ``collective_bytes_of_text``:
    the output bytes of every collective by kind, and ``"ops"``, their
    counts by kind, from ``CollectiveMode.records`` (the port has no HLO
    text: each collective is counted as the trace issues it, a loop's once
    an iteration)."""
    out = dict.fromkeys(KINDS, 0)
    counts = dict.fromkeys(KINDS, 0)
    for name, nbytes in records:
        out[KIND_OF[name]] += nbytes
        counts[KIND_OF[name]] += 1
    out["ops"] = counts
    return out


def block_bytes(shape, dtype, sharding) -> int:
    """The bytes of one rank's block of a leaf of ``shape`` and ``dtype``
    laid out by ``sharding`` (each rank's block is the same size)."""
    sizes = mesh_sizes(sharding.mesh)
    n = math.prod(shape)
    for entry in sharding.spec:
        n //= math.prod(sizes[a] for a in spec_axes(entry))
    return n * torch.empty((), dtype=dtype).element_size()


def _tree_bytes(shapes, shardings) -> int:
    """Σ ``block_bytes`` over two trees of one structure (meta tensors and
    their ``NamedSharding``s)."""
    if isinstance(shapes, torch.Tensor):
        return block_bytes(tuple(shapes.shape), shapes.dtype, shardings)
    if isinstance(shapes, dict):
        return sum(_tree_bytes(v, shardings[k]) for k, v in shapes.items())
    return sum(_tree_bytes(v, s) for v, s in zip(shapes, shardings))


def argument_bytes(cfg, cell, mesh, rules=None) -> dict:
    """One rank's argument bytes of a cell, from the placements alone (no
    trace), by part: a train cell's placed ``TrainState`` (float32
    parameters and AdamW moments, two int32 step counters) and its batch;
    a serving cell's bfloat16 parameters, its caches (``pos`` a 0-d int32)
    and its tokens; ``"total"`` their sum."""
    batch = input_specs(cfg, cell)
    out = {"batch": _tree_bytes(batch, batch_shardings(mesh, batch))}
    if cell.kind == "train":
        pshapes, _ = abstract_params(cfg)
        params, (opt_step, m, _v), step = state_shardings(cfg, mesh, rules)
        scalar = sds((), torch.int32)
        out["state"] = 3 * _tree_bytes(pshapes, params) + _tree_bytes(
            scalar, opt_step) + _tree_bytes(scalar, step)
    else:
        pshapes, pspecs = abstract_params(cfg, dtype=torch.bfloat16)
        cshapes, cspecs = abstract_cache(cfg, cell.global_batch,
                                         cell.seq_len)
        out["params"] = _tree_bytes(
            pshapes, to_named_shardings(mesh, pspecs, pshapes, rules))
        out["cache"] = _tree_bytes(
            cshapes, to_named_shardings(mesh, cspecs, cshapes, rules))
    out["total"] = sum(out.values())
    return out


def _fake_like(tree, device):
    """Zeros of each meta tensor's shape and dtype on ``device`` (under a
    ``FakeTensorMode``: fakes)."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in tree.items()}


def _state_leaves(state) -> list:
    """A ``TrainState``'s tensors: weights, AdamW moments, step counters."""
    return [*state.params.values(), *state.opt.m.values(),
            *state.opt.v.values(), state.opt.step, state.step]


def _local_bytes(tree) -> int:
    """Σ bytes of the tensors of ``tree`` as this rank holds them (a
    DTensor's local block)."""
    return sum(
        (t.to_local() if hasattr(t, "to_local") else t).numel()
        * t.element_size() for t in tree_leaves(tree)
        if isinstance(t, torch.Tensor))


_PROPAGATING = threading.local()


@contextlib.contextmanager
def _marked_propagation():
    """Marks the ops DTensor runs to infer an op's output metadata (on
    fakes of the whole, unsharded shapes, under the active fake mode, which
    in a dry run is the trace's own) so that ``PeakTracker`` can tell them
    from the ops that compute each rank's block."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def _card_redistribution():
    """DTensor's move of a shard from one tensor dim to another as a card
    runs it, an all-to-all of the block (``_dtensor.shard_dim_alltoall``),
    where on a CPU mesh it gathers the whole tensor and keeps a chunk."""
    from torch.distributed.tensor import placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    orig = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


class PeakTracker(MemTracker):
    """``MemTracker`` without its per-module statistics: the dry run reads
    only its peak, and the module hooks refuse a module called twice from
    the top level in one step (a MoE layer, once a microbatch).  Every
    tensor an op makes is still tracked by its storage, so a view and its
    base count once; the fakes of DTensor's metadata propagation
    (``_marked_propagation``) hold no memory on a card and are not
    tracked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(_PROPAGATING, "depth", 0):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _pre_fw_hook(self, module, inputs) -> None:
        pass

    def _post_fw_hook(self, module, inputs, outputs) -> None:
        pass

    def _pre_bw_hook(self, module, args) -> None:
        pass

    def _post_bw_hook(self, module, args) -> None:
        pass

    def peak(self, device) -> int:
        """The peak on ``device``.  The meta device's bucket (the weights
        of a model built on ``"meta"`` before real ones are assigned) holds
        no memory and is not counted."""
        return self.get_tracker_snapshot("peak").get(
            torch.device(device), {}).get("Total", 0)


class _GlobalOnly:
    """``FlopCounterMode``'s module tracker, every op counted under
    "Global" and no hooks installed.  ``ModuleTracker`` puts grad hooks on
    each module call's inputs and outputs, whose closures form reference
    cycles with autograd nodes; those keep a checkpointed block's
    recomputed tensors alive until Python's garbage collector runs (the
    MoE layer is the one module a block calls), a peak of the tracer's own
    making (one MoE block's recomputation a layer)."""
    parents = frozenset({"Global"})

    def __enter__(self):
        return self

    def __exit__(self, *args) -> None:
        pass


def _traced(fn, device, held, args_bytes: int) -> dict:
    """Runs ``fn()`` once under the counters: FLOPs, the collectives, and
    the peak of the live tensors on ``device``, ``held`` (tensors that live
    before the call) included."""
    flops = FlopCounterMode(display=False)
    flops.mod_tracker = _GlobalOnly()
    comm = CollectiveMode()
    mem = PeakTracker()
    mem.track_external(*held)
    with _marked_propagation(), _card_redistribution(), flops, comm, mem:
        out = fn()
    peak = mem.peak(device)
    coll = collective_bytes(comm.records)
    return {
        "flops": flops.get_total_flops(),
        "collective_bytes": {k: v for k, v in coll.items() if k != "ops"},
        "collective_ops": coll["ops"],
        "collective_ops_by_name": dict(collections.Counter(
            name for name, _ in comm.records)),
        "memory": {"argument_bytes": args_bytes,
                   "output_bytes": _local_bytes(out),
                   "temp_bytes": peak - args_bytes,
                   "peak_bytes": peak,
                   "device_bytes": DEVICE_BYTES}}


# --------------------------------------------------------------------------
# cell tracing
# --------------------------------------------------------------------------
def lower_train_cell(cfg, cell, mesh, rules=None) -> dict:
    """One mesh step of ``cfg`` on ``cell``'s batch, traced on this rank of
    ``mesh`` (a fake world's): the state placed by ``state_shardings``,
    ``build_train_step(cfg, microbatches=global_batch // microbatch,
    remat="full")`` run under ``use_mesh(mesh, rules)``.  A MoE model
    takes the placed step: each rank runs the experts of its own block of
    the expert dim (or, where the experts do not divide by their axes, as
    mixtral-8x22b's 8 on 16 or 32 ranks, every expert on its own slice of
    the capacity, the weights gathered along the freed axis) on a
    ``[e, cap]`` buffer whose capacity is the whole microbatch's; on more
    than one batch shard one ``allreduce_`` of the ``[blocks, experts]``
    int32 count table a layer and microbatch, and again in each block's
    recomputation."""
    micro = max(1, cell.global_batch // max(cell.microbatch, 1))
    step_fn = build_train_step(cfg, microbatches=micro, remat="full")
    batch_abs = input_specs(cfg, cell)
    args = argument_bytes(cfg, cell, mesh, rules)
    # the batch group's flattened sub-mesh is built from the mesh's rank
    # tensor, which a fake mode cannot index: build it before
    with use_mesh(mesh, rules):
        axes = spec_axes(microbatch_specs(batch_abs, micro)["tokens"][0])
    batch_group(mesh, axes)
    dev = mesh_device(mesh)
    with FakeTensorMode():
        model = LM(cfg, dev)
        state = place_train_state(init_train_state(model),
                                  state_shardings(cfg, mesh, rules))
        del model
        batch = _fake_like(batch_abs, dev)
        leaves = _state_leaves(state)
        placed = _local_bytes(leaves)
        if placed != args["state"]:
            raise AssertionError(f"placed state {placed} B, its shardings "
                                 f"give {args['state']} B")

        def run():
            with use_mesh(mesh, rules):
                new, metrics = step_fn(state, batch)
            return _state_leaves(new), metrics

        held = [t.to_local() if hasattr(t, "to_local") else t
                for t in [*leaves, *batch.values()]]
        out = _traced(run, dev, held, args["total"])
    out["memory"]["placed_state_bytes"] = args["state"]
    out["memory"]["batch_bytes"] = args["batch"]
    out["scope"] = "rank"
    return out


@functools.lru_cache(maxsize=1)
def _serve_trace(cfg, cell) -> dict:
    """FLOPs and memory of ``prefill`` (a prefill cell) or ``decode_step``
    (a decode cell, at position 0 of a fresh cache, which it attends whole)
    on the whole cell on one fake device, with bfloat16 parameters, and the
    trace's seconds (``cell_trace_s``).  The same for every mesh, so the
    last one is kept: the sweep runs a cell's meshes one after the
    other."""
    dev = torch.device("cpu")
    cshapes, _ = abstract_cache(cfg, cell.global_batch, cell.seq_len)
    with FakeTensorMode():
        model = LM(cfg, dev)
        model.load_state_dict({n: w.to(torch.bfloat16) for n, w in
                               model.state_dict().items()}, assign=True)
        cache = _fake_like({k: v for k, v in cshapes.items() if k != "pos"},
                           dev)
        inputs = _fake_like(input_specs(cfg, cell), dev)
        held = [*model.parameters(), *cache.values(), *inputs.values()]
        cache["pos"] = 0
        # pos: the reference's 0-d int32 leaf, a host int here
        whole = sum(t.numel() * t.element_size() for t in held) + 4
        fn, arg = ((prefill, inputs) if cell.kind == "prefill"
                   else (decode_step, inputs["tokens"]))
        t0 = time.time()
        out = _traced(lambda: fn(model, cfg, arg, cache), dev, held, whole)
    out["cell_trace_s"] = round(time.time() - t0, 2)
    return out


def _lower_serve_cell(cfg, cell, mesh, rules=None) -> dict:
    """A serving cell: a dense or MoE model's traced on this rank of
    ``mesh`` (``_lower_placed_serve_cell``); another family's with per-rank
    argument bytes from the placements on ``mesh`` and the FLOPs and
    memory of the whole cell on one fake device (``_serve_trace``), under
    ``"cell_memory"``, with ``"scope": "cell"``."""
    if cfg.family in SERVE_FAMILIES:
        return _lower_placed_serve_cell(cfg, cell, mesh, rules)
    args = argument_bytes(cfg, cell, mesh, rules)
    out = copy.deepcopy(_serve_trace(cfg, cell))
    out["cell_memory"] = out.pop("memory")
    out["memory"] = {"argument_bytes": args["total"],
                     "params_bytes": args["params"],
                     "cache_bytes": args["cache"],
                     "batch_bytes": args["batch"],
                     "output_bytes": None, "temp_bytes": None,
                     "peak_bytes": None, "device_bytes": DEVICE_BYTES}
    out["scope"] = "cell"
    return out


def _lower_placed_serve_cell(cfg, cell, mesh, rules=None) -> dict:
    """``prefill`` (a prefill cell) or ``decode_step`` (a decode cell, at
    position 0 of a fresh cache) of a dense or MoE model traced on this
    rank of ``mesh`` under ``use_mesh(mesh, rules)``: its bfloat16
    parameters and caches placed by ``serving_shardings``, its batch by
    ``batch_shardings``, each rank holding its blocks.  A MoE model's
    layers read the whole batch (the row blocks ``prefill`` and
    ``decode_step`` set): one ``allreduce_`` of the ``[blocks, e]`` int32
    count table a layer where the batch axes cut the rows, whose group
    (a flattened sub-mesh) is built here, before the fake mode.  The
    per-rank memory, FLOPs and collectives of the cell,
    ``"scope": "rank"``."""
    args = argument_bytes(cfg, cell, mesh, rules)
    if cfg.family == "moe":
        with use_mesh(mesh, rules):
            batch_row_blocks(cell.global_batch)
    pshard, cshard = serving_shardings(cfg, mesh, cell.global_batch,
                                       cell.seq_len, rules)
    batch_abs = input_specs(cfg, cell)
    bshard = batch_shardings(mesh, batch_abs)
    cshapes, _ = abstract_cache(cfg, cell.global_batch, cell.seq_len)
    dev = mesh_device(mesh)
    with FakeTensorMode():
        model = place_params(LM(cfg, dev), pshard)
        cache = place_cache(_fake_like(
            {k: v for k, v in cshapes.items() if k != "pos"}, dev), cshard)
        batch = {k: bshard[k].distribute(v)
                 for k, v in _fake_like(batch_abs, dev).items()}
        held = [t.to_local() for t in [*model.parameters(),
                                       *cache.values(), *batch.values()]]
        # pos: the reference's 0-d int32 leaf, a host int here
        placed = _local_bytes(held) + 4
        if placed != args["total"]:
            raise AssertionError(f"placed serving arguments {placed} B, "
                                 f"their shardings give {args['total']} B")
        cache["pos"] = 0

        def run():
            with use_mesh(mesh, rules):
                if cell.kind == "prefill":
                    return prefill(model, cfg, batch, cache)
                return decode_step(model, cfg, batch["tokens"], cache)

        out = _traced(run, dev, held, args["total"])
    out["memory"].update(params_bytes=args["params"],
                         cache_bytes=args["cache"],
                         batch_bytes=args["batch"])
    out["scope"] = "rank"
    return out


lower_prefill_cell = lower_decode_cell = _lower_serve_cell

_LOWER = {"train": lower_train_cell, "prefill": lower_prefill_cell,
          "decode": lower_decode_cell}


def run_cell(arch: str, shape: str, multi_pod: bool,
             verbose: bool = True) -> dict:
    """One cell on the production mesh, (16, 16) or (2, 16, 16), in a fake
    world of its rank count."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = time.time()
        traced = _LOWER[cell.kind](cfg, cell, mesh)
        t1 = time.time()
    result = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n,
        "trace_s": round(t1 - t0, 2),
        **traced,
    }
    if verbose:
        mem = result["memory"]
        print(f"[dryrun] {arch} × {shape} × {result['mesh']}: "
              f"trace {result['trace_s']}s, flops={result['flops']:.3e} "
              f"({result['scope']}), "
              f"coll={sum(result['collective_bytes'].values()):.3e} B")
        print(f"         memory per rank: {mem}")
        if "cell_memory" in result:
            print(f"         memory of the whole cell on one device: "
                  f"{result['cell_memory']}")
    return result


def _run_cells(arch: str, shape: str, meshes: list) -> list:
    """(A worker's job.)  ``run_cell`` on each of ``meshes``, in turn:
    ``("ok", record)`` or ``("fail", (arch, shape, multi_pod, repr),
    traceback)`` each."""
    out = []
    for mp in meshes:
        try:
            out.append(("ok", run_cell(arch, shape, mp)))
        except Exception as e:  # noqa: BLE001
            out.append(("fail", (arch, shape, mp, repr(e)),
                        traceback.format_exc()))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCHS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    jobs = []
    for arch in archs:
        shapes = [args.shape] if args.shape else cells_for(arch)
        for shape in shapes:
            if shape not in cells_for(arch):
                print(f"[dryrun] skip {arch} × {shape} (long_500k is for "
                      f"sub-quadratic archs only)")
                continue
            # a train or placed serving cell's meshes are two traces;
            # another serving cell's meshes share one (``_serve_trace``),
            # so they run together
            if SHAPES[shape].kind == "train" \
                    or get_config(arch).family in SERVE_FAMILIES:
                jobs += [(arch, shape, [mp]) for mp in meshes]
            else:
                jobs.append((arch, shape, meshes))
    # one process a job (each its own fake world), as many at once as
    # this process may use cores (a trace is single-threaded Python), the
    # longest kinds of trace started first: train cells, the gather path's
    # (whole weights and gradients, the recurrent scans' many ops: 2,000–
    # 2,500 s each on 8 busy cores) before the placed step's; results in
    # job order
    results, failures = [], []
    if jobs:
        workers = min(len(jobs), len(os.sched_getaffinity(0)))
        first = {"train": 0, "prefill": 1, "decode": 2}
        order = sorted(range(len(jobs)), key=lambda i: (
            first[SHAPES[jobs[i][1]].kind],
            get_config(jobs[i][0]).family in TP_FAMILIES))
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            futures = {i: pool.submit(_run_cells, *jobs[i]) for i in order}
            for fut in (futures[i] for i in range(len(jobs))):
                for status, *rest in fut.result():
                    if status == "ok":
                        results.append(rest[0])
                    else:
                        failures.append(rest[0])
                        print(rest[1], end="", flush=True)
    with open(args.out, "w") as f:
        json.dump({"results": results,
                   "failures": [list(x) for x in failures]}, f, indent=1)
    print(f"[dryrun] {len(results)} cells OK, {len(failures)} failed "
          f"→ {args.out}")
    if failures:
        for f_ in failures:
            print("  FAIL:", f_)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
