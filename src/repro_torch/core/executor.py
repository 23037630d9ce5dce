"""Graph interpreter over the fixed-capacity columnar substrate.

Both execution surfaces interpret the plan's op DAG (``PhysicalPlan.root``
/ ``nodes``) on the device of the database's tables:

  * ``execute`` — node by node, every plan class, recording the paper's
    headline metric (live or materialised tuples per step,
    ``ExecStats.peak_tuples``, Fig. 6), which needs a device sync per
    step.  The materialising baselines (Ref, Opt) expand each join's rows
    with plain PyTorch sorts and gathers on the tables' device;
    ``oom_guard`` bounds that expansion and raises
    ``MaterialisationLimit`` (the paper's X entries) before it is
    allocated.
  * ``compile`` / ``compile_multi`` — the zero-materialisation plan classes
    (oma / opt_plus) as closures ``db → aggregates`` with no per-step
    syncs.  Materialising plans and ``oom_guard`` are refused: both need
    concrete per-step sizes.  Node results are memoised by their content
    keys (``PlanNode.key``): ``compile_multi`` shares one memo across all
    member plans, so a sub-DAG two members have in common — a filtered
    dimension scan, a semi-join chain — is computed once per call.
    PyTorch runs eagerly, so "compile" builds no program: capturing a CUDA
    graph per shape bucket is left to a later slice.

The sweep runs one kernel per join-tree edge: the semi-join (K1) in 0MA
plans, the FreqJoin (K2) in Opt⁺ plans, after a sorted group-by-SUM (K3)
that pre-groups the child when its key domain is unknown or the dense path
is off.  Opt plans with FK/PK degradation run K1 on their FK→PK edges,
and Opt's regroup sums its runs with K3.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.aggregates import grouped_aggregate, scalar_aggregate
from repro_torch.core.plan import (
    FinalAggOp,
    FreqJoinOp,
    MaterializeJoinOp,
    PhysicalPlan,
    PlanNode,
    ScanOp,
    SemiJoinOp,
)
from repro_torch.kernels import ops as kops
from repro_torch.tables.table import (
    Schema,
    Table,
    int_dtype,
    is_wide,
    pack_keys,
)


class MaterialisationLimit(RuntimeError):
    """Raised when a baseline plan exceeds the allowed intermediate size
    (the paper's 'X — out of memory' condition)."""


@dataclasses.dataclass
class ExecStats:
    peak_tuples: int = 0
    steps: list = dataclasses.field(default_factory=list)

    def record(self, opname: str, n: int):
        self.steps.append((opname, int(n)))
        self.peak_tuples = max(self.peak_tuples, int(n))


@dataclasses.dataclass
class _State:
    cols: dict[str, Any]     # var → column tensor
    freq: Any                # frequency column


def _live(freq: torch.Tensor) -> int:
    return int(torch.sum(freq > 0))


class Executor:
    """Runs plans over ``db`` on the device its tables lie on.

    ``dense_domain`` (beyond the paper) passes known key domains to the
    FreqJoin, which skips the child pre-grouping and, on the CPU, takes the
    dense scatter-add path.  ``oom_guard`` bounds the tuples one
    materialising join may produce (``execute`` only).  ``tuning`` is
    reserved for the kernel tuner of a later slice and must be None.

    The width of ``freq_dtype`` is the width of the whole run.  int32 and
    float32 frequencies are the JAX package with 64-bit types off: keys
    pack in int32 and integer aggregates wrap in int32.  int64 and float64
    frequencies (the wide setting, ``self.wide``) are the JAX package under
    ``jax.enable_x64(True)``: keys pack in int64 (an edge with no join
    variables keeps its int32 zero key, as there), integer aggregates
    accumulate in int64 and AVG and the median weights in float64, and
    K1–K3 run their 64-bit instances."""

    def __init__(self, db: dict[str, Table], schema: Schema,
                 freq_dtype: torch.dtype = torch.int32,
                 dense_domain: bool = False, tuning=None,
                 oom_guard: int | None = None):
        if tuning is not None:
            raise NotImplementedError(
                "kernel tuning is not ported yet; pass tuning=None")
        self.db = db
        self.schema = schema
        self.freq_dtype = freq_dtype
        self.wide = is_wide(freq_dtype)
        self.dense_domain = dense_domain
        self.oom_guard = oom_guard

    def jittable(self) -> "Executor":
        """Copy with eager-only options stripped — the configuration
        ``compile()`` accepts."""
        return Executor(self.db, self.schema, self.freq_dtype,
                        dense_domain=self.dense_domain)

    # ------------------------------------------------------------------
    def _domains(self, plan: PhysicalPlan, alias: str) -> dict[str, int | None]:
        atom = plan.tree.atoms[alias]
        rel = self.schema.relations[atom.rel]
        return {v: rel.columns[i].domain for i, v in enumerate(atom.vars)}

    def _scan(self, db: dict[str, Table], plan: PhysicalPlan,
              op: ScanOp) -> _State:
        tab = db[op.rel]
        atom = plan.tree.atoms[op.alias]
        rel = self.schema.relations[atom.rel]
        if op.selection is not None:
            tab = tab.select(op.selection)
        cols = {}
        for i, cname in enumerate(rel.column_names()):
            cols[atom.vars[i]] = tab.columns[cname]
        return _State(cols, tab.freq.to(self.freq_dtype))

    def _key(self, plan: PhysicalPlan, alias: str, st: _State,
             on_vars: tuple[str, ...]):
        """Packed join key (``int_dtype(self.wide)``; int32 zeros for no
        join variables) + (optional) dense key-domain size."""
        if not on_vars:
            return torch.zeros(st.freq.shape, dtype=torch.int32,
                               device=st.freq.device), 1
        doms = self._domains(plan, alias)
        dlist = [doms.get(v) for v in on_vars]
        key = pack_keys([st.cols[v] for v in on_vars], dlist,
                        int_dtype(self.wide))
        domain = None
        if self.dense_domain and all(d is not None for d in dlist):
            domain = 1
            for d in dlist:
                domain *= d
        return key.contiguous(), domain

    def _semi_join(self, plan: PhysicalPlan, op: SemiJoinOp,
                   p: _State, c: _State) -> _State:
        pk, _pd = self._key(plan, op.parent, p, op.on_vars)
        ck, cdom = self._key(plan, op.child, c, op.on_vars)
        freq = kops.semi_join(pk, p.freq, ck, c.freq, domain=cdom)
        return _State(p.cols, freq)

    def _freq_join(self, plan: PhysicalPlan, op: FreqJoinOp,
                   p: _State, c: _State) -> _State:
        pk, _pd = self._key(plan, op.parent, p, op.on_vars)
        ck, cdom = self._key(plan, op.child, c, op.on_vars)
        cf = c.freq
        if op.pregroup and cdom is None:
            ck, cf, _valid = kops.group_by_sum(ck, cf)
        freq = kops.freq_join(pk, p.freq, ck, cf, domain=cdom)
        return _State(p.cols, freq)

    # ------------------------------------------------------------------
    def execute(self, plan: PhysicalPlan, stats: ExecStats | None = None):
        """Eager DAG interpretation with per-step live-tuple stats.

        Intermediate states are dropped after their last consumer, so peak
        device memory tracks the largest live intermediate."""
        stats = stats if stats is not None else ExecStats()
        consumers: dict[int, int] = {}
        for node in plan.nodes:
            for i in node.inputs:
                consumers[id(i)] = consumers.get(id(i), 0) + 1
        vals: dict[int, Any] = {}
        results: dict[str, Any] = {}
        for node in plan.nodes:
            op = node.op
            ins = [vals[id(i)] for i in node.inputs]
            if isinstance(op, ScanOp):
                st = self._scan(self.db, plan, op)
                stats.record(f"scan({op.alias})", _live(st.freq))
            elif isinstance(op, SemiJoinOp):
                st = self._semi_join(plan, op, ins[0], ins[1])
                stats.record(f"semijoin({op.parent}⋉{op.child})",
                             _live(st.freq))
            elif isinstance(op, FreqJoinOp):
                st = self._freq_join(plan, op, ins[0], ins[1])
                stats.record(f"freqjoin({op.parent}⋉ᶠ{op.child})",
                             _live(st.freq))
            elif isinstance(op, MaterializeJoinOp):
                st = self._materialize_join(plan, op, ins[0], ins[1], stats)
            elif isinstance(op, FinalAggOp):
                st = results = self._final_agg(plan, op, ins[0])
            else:  # pragma: no cover
                raise TypeError(op)
            vals[id(node)] = st
            for i in node.inputs:
                consumers[id(i)] -= 1
                if consumers[id(i)] == 0:
                    del vals[id(i)]
        results = dict(results)
        results["__stats__"] = stats
        return results

    # ------------------------------------------------------------------
    def _materialize_join(self, plan, op: MaterializeJoinOp,
                          p: _State, c: _State, stats) -> _State:
        """Eager row-expanding join (the Ref/Opt baselines), on the tables'
        device.  Output rows come in the JAX package's order: live parent
        rows in row order, each followed by its live matches in the stable
        order of the child's keys.  An empty live side gives an empty state
        (where the JAX package's numpy expansion raises)."""
        pk = self._key(plan, op.parent, p, op.on_vars)[0]
        ck = self._key(plan, op.child, c, op.on_vars)[0]
        plive = torch.nonzero(p.freq > 0).squeeze(1)
        clive = torch.nonzero(c.freq > 0).squeeze(1)
        pk, ck = pk[plive], ck[clive]
        cks, order = torch.sort(ck, stable=True)
        lo = torch.searchsorted(cks, pk, side="left")
        counts = torch.searchsorted(cks, pk, side="right") - lo
        total = int(counts.sum())   # synced here: the guard precedes any expansion
        if self.oom_guard is not None and total > self.oom_guard:
            raise MaterialisationLimit(
                f"join {op.parent}⋈{op.child} would materialise {total} "
                f"tuples (> {self.oom_guard})")
        stats.record(f"join({op.parent}⋈{op.child})", total)
        pidx = torch.repeat_interleave(counts, output_size=total)
        # match j of parent i sits at sorted child position lo[i] + j, and
        # output row offs[i] + j, so its position is (lo - offs)[i] + row
        offs = torch.cumsum(counts, 0) - counts
        cidx = order[(lo - offs)[pidx]
                     + torch.arange(total, device=pk.device)]
        prow, crow = plive[pidx], clive[cidx]
        out_cols = {v: col[prow] for v, col in p.cols.items()}
        for v, col in c.cols.items():
            if v not in out_cols:
                out_cols[v] = col[crow]
        out_freq = p.freq[prow] * c.freq[crow]
        if not op.regroup:
            return _State(out_cols, out_freq)

        # §4.2 Opt: group straight back to the parent's attributes, sorted
        # as np.lexsort(reversed(parent_vars)): stable sorts from the last
        # parent var to the first
        parent_vars = list(p.cols)
        perm = torch.arange(total, device=pk.device)
        for v in reversed(parent_vars):
            perm = perm[torch.sort(out_cols[v][perm], stable=True).indices]
        cols = {v: out_cols[v][perm] for v in parent_vars}
        boundary = torch.zeros(total, dtype=torch.bool, device=pk.device)
        boundary[:1] = True
        for col in cols.values():
            boundary[1:] |= col[1:] != col[:-1]
        starts = torch.nonzero(boundary).squeeze(1)
        # each run's sum by the sorted group-by (K3 on the card) over int32
        # run ids: one fixed order in every dtype, so float32 and float64
        # repeat bit for bit; int32 and int64 wrap as np.add.reduceat does.
        # Ids past 2^31 wrap, and adjacent runs still differ, which is all
        # K3 reads.
        run = torch.cumsum(boundary, 0, dtype=torch.int32)
        sums, ends = kops.segment_sum_sorted(run, out_freq[perm].contiguous())
        stats.record(f"regroup({op.parent})", starts.shape[0])
        return _State({v: col[starts] for v, col in cols.items()},
                      sums[ends])

    # ------------------------------------------------------------------
    def _final_agg(self, plan, op: FinalAggOp, st: _State):
        out: dict[str, Any] = {}
        if not op.group_by:
            for ag in op.aggregates:
                out[ag.name] = scalar_aggregate(ag, st.cols, st.freq,
                                                op.dedup, self.wide)
            return out
        doms = self._domains(plan, op.root) \
            if op.root in plan.tree.atoms else {}
        cols, valid = grouped_aggregate(op.group_by, op.aggregates,
                                        st.cols, st.freq, doms, op.dedup,
                                        self.wide)
        out["groups"] = cols
        out["valid"] = valid
        return out

    # ------------------------------------------------------------------
    def _check_jittable(self, plans) -> None:
        for plan in plans:
            if any(isinstance(op, MaterializeJoinOp) for op in plan.ops):
                raise ValueError(f"plan mode {plan.mode} materialises joins; "
                                 "only oma/opt_plus plans are jittable")
        if self.oom_guard is not None:
            raise ValueError(
                "oom_guard is an eager-only option: it needs concrete "
                "per-step tuple counts, which do not exist under jit "
                "tracing (and compiled oma/opt_plus plans never "
                "materialise beyond the base relations anyway). Use "
                "execute() for guarded baselines, or build the Executor "
                "without oom_guard to compile.")

    def _trace_plan(self, db: dict[str, Table], plan: PhysicalPlan,
                    memo: dict) -> Any:
        """One plan's DAG evaluation without per-step stats.

        ``memo`` maps node content keys (``PlanNode.key``) to the frequency
        vectors already computed in this call: a key hit reuses the vector
        (only the column views of the node's parent chain are rebuilt —
        free) and skips the node's kernels AND its entire child sub-DAG."""
        vals: dict[int, _State] = {}

        def ev(node: PlanNode) -> Any:
            st = vals.get(id(node))
            if st is not None:
                return st
            op = node.op
            key = node.key()
            if isinstance(op, ScanOp):
                st = self._scan(db, plan, op)
                if key is not None:
                    if key in memo:
                        st = _State(st.cols, memo[key])
                    else:
                        memo[key] = st.freq
            elif isinstance(op, (SemiJoinOp, FreqJoinOp)):
                p = ev(node.inputs[0])
                if key is not None and key in memo:
                    st = _State(p.cols, memo[key])
                else:
                    c = ev(node.inputs[1])
                    st = self._semi_join(plan, op, p, c) \
                        if isinstance(op, SemiJoinOp) \
                        else self._freq_join(plan, op, p, c)
                    if key is not None:
                        memo[key] = st.freq
            elif isinstance(op, FinalAggOp):
                st = self._final_agg(plan, op, ev(node.inputs[0]))
            else:  # pragma: no cover — _check_jittable rejects these
                raise TypeError(op)
            vals[id(node)] = st
            return st

        return ev(plan.root)

    def compile(self, plan: PhysicalPlan):
        """The static plan classes (oma / opt_plus) as ``db → aggregates``."""
        self._check_jittable([plan])

        def run(db: dict[str, Table]):
            # a fresh memo still dedups repeated sub-DAGs *within* the plan
            # (self-joins scanning one relation twice, say)
            return self._trace_plan(db, plan, memo={})

        return run

    def compile_multi(self, plans: list[PhysicalPlan]):
        """Several static plans as one ``db → [aggregates]``: the members
        share one content-key memo, so every structurally identical sub-DAG
        is computed once per call.  Results come in plan order."""
        if not plans:
            raise ValueError("compile_multi needs at least one plan")
        self._check_jittable(plans)

        def run(db: dict[str, Table]):
            memo: dict = {}
            return [self._trace_plan(db, plan, memo) for plan in plans]

        return run
