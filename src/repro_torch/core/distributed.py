"""Distributed Yannakakis sweep: the ring FreqJoin over a device mesh, on
``torch.distributed``.

The FreqJoin's multiplier is additive over a split of the child relation:

    mult(R, S₁ ⊎ S₂) = mult(R, S₁) + mult(R, S₂)

so with the child row-sharded over the mesh, each parent shard accumulates
exact multipliers by visiting every child shard once around a ring, like
ring attention:

    for step in range(axis_size):
        mult += local_multiplier(parent_keys, child_shard)
        child_shard = send to rank + 1, receive from rank − 1

Parent rows never move, and every shape is static.  The semi-join sweep is
the same ring in the Boolean semiring (max instead of +).  Over several
mesh axes the rings nest: the innermost axis rotates fastest, and each
outer axis turns once per full loop of the axes inside it, so a slow
(inter-pod) hop happens once per pod, not once per shard.

One process runs each rank.  ``DistributedExecutor`` subclasses
``core.executor.Executor`` and reuses its node-keyed traversal
(``_trace_plan``) as it is: the mesh path only swaps the node evaluator
(``_RingExecutor``: semi-joins and FreqJoins become ring sweeps) and stops
the traversal at the pre-aggregate root state.  Content-key memoisation,
sub-DAG dedup and ``compile_multi`` fusion therefore work unchanged: a
fused multi-query run does every shared sub-DAG's ring sweep once.

The root state's aggregated columns and its frequencies are then
all-gathered in shard order, and every rank runs the local executor's
final aggregate on the whole of them.  The sweep's integer frequencies are
exactly the local engine's, so the answers are bitwise those of one device
over the same padded capacities (``tables.table.sharded_bucket_capacity``).

On CUDA tensors each ring step without presort launches the port's
kernels through ``kernels.ops``: K2 (the FreqJoin) in ``sum`` mode and K1
(the semi-join) in ``any`` mode, each with a unit parent frequency.  On
CPU tensors the same calls run their plain versions.  The presort variant
and the dense-domain all-reduce stay plain PyTorch, as the JAX package
leaves them to XLA.

A ``"cuda"`` mesh needs NCCL; nothing falls back to ``gloo`` or to the CPU.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.executor import Executor, _State
from repro_torch.core.plan import PhysicalPlan, PlanNode, SemiJoinOp
from repro_torch.kernels import ops as kops
from repro_torch.tables.table import Schema, Table, sharded_bucket_capacity

_MODES = ("sum", "any")


def _local_multiplier(pk, ck, cf, mode: str, unit):
    """Exact multiplier of parent keys against ONE child shard: K2 (sum
    mode) or K1 (any mode) with the unit parent frequency ``unit`` (ones
    like ``pk`` in the frequencies' dtype, made once per ring) on CUDA
    tensors, their plain versions on CPU tensors.  In any mode the result
    is 1 where a live child row matches, else 0."""
    if mode == "any":
        return kops.semi_join(pk, unit, ck, cf)
    return kops.freq_join(pk, unit, ck, cf)


def presort_payload(ck, cf, mode: str, dtype: torch.dtype):
    """A child block's ring payload with presort on: its keys sorted once
    (stably) and the prefix sums of its frequencies in that order, in
    ``dtype`` (live rows counted as 1 in any mode).  The prefix sums wrap
    in an integer dtype, and their differences stay exact modulo 2^32
    (2^64 for 64-bit integers)."""
    cks, order = torch.sort(ck, stable=True)
    cfs = cf[order]
    if mode == "any":
        cfs = (cfs > 0).to(dtype)
    prefix = torch.cat([cfs.new_zeros(1),
                        torch.cumsum(cfs, 0, dtype=cfs.dtype)])
    return cks, prefix


def presort_multiplier(pk, cks, prefix, dtype: torch.dtype):
    """One presort ring step: the multiplier of parent keys against a
    visiting (sorted keys, prefix sums) payload, by two searchsorteds and
    a gather."""
    lo = torch.searchsorted(cks, pk, side="left")
    hi = torch.searchsorted(cks, pk, side="right")
    return (prefix[hi] - prefix[lo]).to(dtype)


def accumulate(mult, m, mode: str):
    """Fold one step's multiplier into the ring's running one: ``+``
    (wrapping in an integer dtype) in sum mode, ``max`` in any mode."""
    return torch.maximum(mult, m) if mode == "any" else mult + m


def _start_rotation(payload: tuple, group):
    """Send ``payload`` to the next rank of ``group``'s ring and receive the
    previous rank's into new buffers (``lax.ppermute`` with
    ``perm = [(i, i + 1 mod n)]``).  Returns (buffers, works)."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + 1) % n)
    src = dist.get_global_rank(group, (r - 1) % n)
    bufs = tuple(torch.empty_like(x) for x in payload)
    ops = [dist.P2POp(dist.isend, x, dst, group, tag)
           for tag, x in enumerate(payload)]
    ops += [dist.P2POp(dist.irecv, b, src, group, tag)
            for tag, b in enumerate(bufs)]
    return bufs, dist.batch_isend_irecv(ops)


def _finish_rotation(bufs: tuple, works) -> tuple:
    for w in works:
        w.wait()
    return bufs


def ring_schedule(sizes: Sequence[int]) -> list[list[int]]:
    """For each ring step, the axes (indices into ``sizes``, innermost
    first) whose rings turn after it: the innermost after every step, an
    outer axis after each full loop of the axes inside it.  Nothing turns
    after the last step (that turn would only bring every payload home),
    nor along an axis of size 1, whose ring is the identity."""
    total = math.prod(sizes)
    steps = []
    for c in range(1, total + 1):
        turns = []
        if c < total:
            for k in reversed(range(len(sizes))):
                if c % math.prod(sizes[k + 1:]) == 0 and sizes[k] > 1:
                    turns.append(k)
        steps.append(turns)
    return steps


def ring_freq_join(pk, pf, ck, cf, *, ring_axes: Sequence, mode: str = "sum",
                   presort: bool = False):
    """Exact FreqJoin with the child row-sharded over ``ring_axes``, the
    process group of each mesh axis (``mesh.get_group(name)``), outermost
    first; the innermost rotates fastest.  Every rank of the axes' groups
    calls it with its own blocks.  Returns the new parent frequencies of
    this rank's block.

    presort=False — each ring step joins the visiting shard: K2 or K1 with
        a unit parent frequency (``_local_multiplier``).
    presort=True  — each rank sorts its child block once and the ring
        rotates (sorted keys, prefix sums) (``presort_payload``); every
        step is then two searchsorteds and a gather
        (``presort_multiplier``).

    Each step's transfer is posted before the step's join runs, so the two
    overlap.  Multipliers accumulate with ``+`` (wrapping in the
    frequencies' dtype) in sum mode and with ``max`` in any mode."""
    if mode not in _MODES:
        raise ValueError(f"unknown freq_join mode {mode!r}")
    if presort:
        payload = presort_payload(ck, cf, mode, pf.dtype)

        def local(payload_):
            return presort_multiplier(pk, *payload_, pf.dtype)
    else:
        payload = (ck, cf)
        unit = torch.ones(pk.shape, dtype=cf.dtype, device=pk.device)

        def local(payload_):
            ck_, cf_ = payload_
            return _local_multiplier(pk, ck_, cf_, mode, unit).to(pf.dtype)

    mult = torch.zeros_like(pf)
    for turns in ring_schedule([dist.get_world_size(g) for g in ring_axes]):
        pending = _start_rotation(payload, ring_axes[turns[0]]) \
            if turns else None
        mult = accumulate(mult, local(payload), mode)
        if pending is not None:
            payload = _finish_rotation(*pending)
            for k in turns[1:]:
                payload = _finish_rotation(*_start_rotation(payload,
                                                            ring_axes[k]))
    if mode == "any":
        mult = (mult > 0).to(pf.dtype)
    return pf * mult


def allreduce_freq_join(pk, pf, ck, cf, *, ring_axes: Sequence,
                        mode: str = "sum", domain: int):
    """FreqJoin over a dense key domain: each rank scatter-adds its child
    block into a ``domain``-sized accumulator, one all-reduce over each
    ring axis's process group makes the global multiplier table, and
    parents gather from it locally.  Keys outside ``[0, domain)`` match
    nothing."""
    if mode not in _MODES:
        raise ValueError(f"unknown freq_join mode {mode!r}")
    cfx = (cf > 0).to(pf.dtype) if mode == "any" else cf.to(pf.dtype)
    live = (ck >= 0) & (ck < domain)
    acc = torch.zeros(domain, dtype=pf.dtype, device=pf.device)
    acc.index_add_(0, ck.clamp(0, domain - 1).long(),
                   torch.where(live, cfx, torch.zeros_like(cfx)))
    for g in ring_axes:
        dist.all_reduce(acc, group=g)
    mult = acc[pk.clamp(0, domain - 1).long()]
    mult = torch.where((pk >= 0) & (pk < domain), mult,
                       torch.zeros_like(mult))
    if mode == "any":
        mult = (mult > 0).to(pf.dtype)
    return pf * mult


def shard_table(table: Table, block: int, n_blocks: int, device) -> Table:
    """Row block ``block`` of ``n_blocks`` equal contiguous blocks of
    ``table`` (whose capacity they must divide), copied to ``device``."""
    if table.capacity % n_blocks:
        raise ValueError(f"capacity {table.capacity} does not split into "
                         f"{n_blocks} equal blocks")
    per = table.capacity // n_blocks
    rows = slice(block * per, (block + 1) * per)
    return Table({c: a[rows].to(device, copy=True)
                  for c, a in table.columns.items()},
                 table.freq[rows].to(device, copy=True))


class _RingExecutor(Executor):
    """Per-rank node evaluator: the ``Executor`` semantics with semi-joins
    and FreqJoins replaced by ring (or dense-domain all-reduce) sweeps over
    the mesh axes' groups.  Every other node type (scans, the content-key
    memo, selections) is inherited unchanged."""

    def __init__(self, db: dict[str, Table], schema: Schema, freq_dtype,
                 ring_groups: Sequence, presort: bool, dense_domain: bool):
        super().__init__(db, schema, freq_dtype, dense_domain=dense_domain)
        self.ring_groups = list(ring_groups)
        self.presort = presort

    def _key(self, plan, alias, st, on_vars):
        key, dom = super()._key(plan, alias, st, on_vars)
        if dom is not None and dom >= (1 << 31):
            # the all-reduce scatter-adds into a domain-sized accumulator
            # per rank: past int32 indexing range, take the ring instead
            dom = None
        return key, dom

    def _ring(self, pk, pf, ck, cf, cdom, mode: str):
        if cdom is not None:
            return allreduce_freq_join(pk, pf, ck, cf,
                                       ring_axes=self.ring_groups,
                                       mode=mode, domain=cdom)
        return ring_freq_join(pk, pf, ck, cf, ring_axes=self.ring_groups,
                              mode=mode, presort=self.presort)

    def _join(self, plan, node: PlanNode, p: _State, c: _State,
              cfgs=None) -> _State:
        # a FreqJoin's op.pregroup (pre-summing duplicate child keys) is a
        # local-engine saving; the ring sums each shard exactly anyway, so
        # it is ignored (identical integers by the semiring law) and K3
        # stays off the ring path.  No kernel config applies to a ring step.
        op = node.op
        pk, _pd = self._key(plan, op.parent, p, op.on_vars)
        ck, cdom = self._key(plan, op.child, c, op.on_vars)
        mode = "any" if isinstance(op, SemiJoinOp) else "sum"
        return _State(p.cols, self._ring(pk, p.freq, ck, c.freq, cdom, mode))

    def _final_agg(self, plan, op, st):
        raise TypeError("final aggregation must not run per shard; "
                        "DistributedExecutor aggregates the gathered root "
                        "state")


class DistributedExecutor(Executor):
    """The graph interpreter over a ``torch.distributed`` device mesh.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with
    ``mesh_dim_names`` that spans the whole world group, made after
    ``init_process_group`` (NCCL for a ``"cuda"`` mesh).  Tables are
    row-sharded over ``data_axes`` (e.g. ``("pod", "data")``): this rank
    holds the block at its row-major coordinate over those axes.  Every
    rank calls ``compile(plan)`` / ``compile_multi(plans)`` and then the
    returned function with its own ``shard_db`` tables; the sweep runs up
    to each plan's pre-aggregate root state with ``_RingExecutor`` as the
    node evaluator, and the final aggregate runs on every rank over the
    gathered root state, so every rank returns the same answers, bitwise
    those of one device over the same padded capacities."""

    def __init__(self, schema: Schema, mesh,
                 data_axes: Sequence[str] = ("data",),
                 freq_dtype: torch.dtype = torch.int32,
                 presort: bool = False, dense_domain: bool = False,
                 span_hook=None, profile_annotations: bool = False):
        super().__init__({}, schema, freq_dtype, dense_domain=dense_domain,
                         span_hook=span_hook,
                         profile_annotations=profile_annotations)
        names = mesh.mesh_dim_names
        if names is None or any(a not in names for a in data_axes):
            raise ValueError(f"data_axes {tuple(data_axes)} are not all "
                             f"named axes of the mesh ({names})")
        if not dist.is_initialized():
            raise RuntimeError("DistributedExecutor needs an initialised "
                               "default process group")
        ranks = mesh.mesh
        if ranks.numel() != dist.get_world_size():
            raise ValueError(f"the mesh holds {ranks.numel()} ranks, the "
                             f"world group {dist.get_world_size()}")
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.presort = presort
        self.ring_groups = [mesh.get_group(a) for a in self.data_axes]
        if mesh.device_type == "cuda":
            for a, g in zip(self.data_axes, self.ring_groups):
                if "nccl" not in str(dist.get_backend(g)):
                    raise RuntimeError(
                        f"a cuda mesh needs NCCL; axis {a!r} runs "
                        f"{dist.get_backend(g)}")
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)
        # each rank's block: its row-major coordinate over data_axes
        dims = [names.index(a) for a in self.data_axes]
        block_of = {}
        for coord in itertools.product(*(range(s) for s in ranks.shape)):
            b = 0
            for d in dims:
                b = b * ranks.shape[d] + coord[d]
            block_of[int(ranks[coord])] = b
        self.block = block_of[dist.get_rank()]
        # the world rank whose copy of each block the gather keeps
        self._gather_ranks = [min(r for r, b in block_of.items() if b == k)
                              for k in range(self.n_shards)]

    def jittable(self) -> "DistributedExecutor":
        return self          # never carries eager-only options

    # -- sharding helpers --------------------------------------------------
    @property
    def n_shards(self) -> int:
        return math.prod(self.mesh.mesh.shape[
            self.mesh.mesh_dim_names.index(a)] for a in self.data_axes)

    def topology(self) -> tuple[tuple[str, ...], tuple[int, ...]]:
        """(axis names, shard counts): the shape-relevant mesh identity."""
        names = self.mesh.mesh_dim_names
        return (self.data_axes,
                tuple(self.mesh.mesh.shape[names.index(a)]
                      for a in self.data_axes))

    def shard_capacity(self, n_rows: int, min_bucket: int = 8) -> int:
        """Global padded capacity for an n-row table on this mesh: each
        shard gets a power-of-two block, so within-bucket per-shard growth
        never changes any shard's shapes."""
        return sharded_bucket_capacity(n_rows, self.n_shards, min_bucket)

    def shard_db(self, db: dict[str, Table],
                 min_bucket: int = 8) -> dict[str, Table]:
        """Pad each table to its per-shard power-of-two bucket
        (``sharded_bucket_capacity``) and keep this rank's row block, on
        the mesh's device (``cuda:<current device>`` for a cuda mesh)."""
        return {name: shard_table(
                    t.pad_to(self.shard_capacity(t.capacity, min_bucket)),
                    self.block, self.n_shards, self.device)
                for name, t in db.items()}

    # -- plan execution ----------------------------------------------------
    def _inner_executor(self, db: dict[str, Table]) -> Executor:
        return _RingExecutor(db, self.schema, self.freq_dtype,
                             self.ring_groups, self.presort,
                             self.dense_domain)

    @staticmethod
    def _agg_state_node(plan: PhysicalPlan) -> PlanNode:
        """The pre-aggregate root state: where the sweep stops."""
        return plan.root.inputs[0]

    @staticmethod
    def _agg_cols(plan: PhysicalPlan) -> set[str]:
        """Root-state columns the final aggregate reads; only these (and
        the frequencies) are gathered."""
        op = plan.root.op
        need = set(op.group_by)
        for ag in op.aggregates:
            if ag.var is not None:
                need.add(ag.var)
        return need

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a row-sharded column joined with every
        other rank's, in shard order, over the world group."""
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        return torch.cat([parts[r] for r in self._gather_ranks])

    def _root_states(self, db: dict[str, Table],
                     plans: list[PhysicalPlan]) -> list[_State]:
        """Each plan's pre-aggregate root state, gathered: the aggregated
        columns and the frequencies of every shard.  The sweeps share one
        content-key memo, so a sub-DAG common to several plans runs its
        ring sweep once."""
        memo: dict = {}
        states = []
        for plan in plans:
            st = self._trace_plan(db, plan, memo, {},
                                  root=self._agg_state_node(plan))
            need = self._agg_cols(plan)
            states.append(_State({v: self._gather(c)
                                  for v, c in st.cols.items() if v in need},
                                 self._gather(st.freq)))
        return states

    def _ring_program(self, plans: list[PhysicalPlan]):
        """db → [result dict per plan]: the ring sweeps to the root states,
        then the local final aggregate on every rank."""
        def run(db: dict[str, Table]):
            return [self._final_agg(plan, plan.root.op, st)
                    for plan, st in zip(plans, self._root_states(db, plans))]

        return run

    def compile(self, plan: PhysicalPlan):
        """One plan's mesh run: this rank's shard db → aggregates."""
        self._check_jittable([plan])
        run = self._ring_program([plan])
        return self._wrap(lambda db: run(db)[0], "executor.run")

    def compile_multi(self, plans: list[PhysicalPlan]):
        """Several plans in one mesh run with shared ring sweeps: shard db
        → [aggregates], results in plan order."""
        if not plans:
            raise ValueError("compile_multi needs at least one plan")
        self._check_jittable(plans)
        return self._wrap(self._ring_program(list(plans)),
                          "executor.run_multi")
