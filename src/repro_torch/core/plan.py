"""Physical plan representation: an op-graph IR.

A plan is a DAG of ``PlanNode``s, each wrapping one physical op and naming
its input nodes explicitly.  Four plan classes mirror the paper's
experimental conditions:

  ref       — materialising left-deep joins, aggregate at the end
              (baseline; what a standard engine does)
  opt       — §4.2 logical rewrite: materialise each parent⋈child pair but
              immediately re-group to the parent's attrs, SUM(c_p·c_c)
  opt_plus  — §5: the FreqJoin physical operator, zero join materialisation
  oma       — §4.1: semi-joins only (requires the 0MA conditions)

The FK/PK flag (§4.3) downgrades FreqJoins to semi-joins where sound and
skips useless pre-grouping on unique keys.

Every node has a content-addressed ``key()``: a structural hash of its
whole sub-DAG (relations, selection specs, join columns — never aliases or
variable names, which canonicalisation assigns role-sensitively).  Two
nodes with equal keys — possibly from *different* plans — compute identical
frequency vectors over the same database.  That is the unit of sharing the
multi-query executor exploits: any common sub-DAG (a shared filtered
dimension scan, a shared semi-join chain) is computed once even when the
enclosing join shapes differ, which is how partial fusion across different
join shapes works (cf. structure-guided evaluation over decompositions).

``PhysicalPlan.ops`` is a derived topological linearisation kept for the
linear alias-state interpreters (the distributed engine, reference
semantics in tests): each op payload names its aliases, and any topological
order of the DAG replays correctly through a ``state[alias]`` sweep.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

from repro_torch.core.hypergraph import JoinTree
from repro_torch.core.query import Agg


# ---------------------------------------------------------------------------
# Op payloads (the per-node physical operator descriptions)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScanOp:
    """``spec`` carries the declarative form of ``selection`` (the query's
    ``selection_specs`` entry) when one exists; node keys use it so
    structurally-equal selections from *different* query objects unify.
    Opaque selections key on callable identity instead."""

    alias: str
    rel: str
    selection: Callable | None
    spec: tuple | None = None


@dataclasses.dataclass(frozen=True)
class SemiJoinOp:
    """parent.freq ← parent.freq · [∃ live child match]  (0MA / FK-PK)."""

    parent: str
    child: str
    on_vars: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class FreqJoinOp:
    """parent.freq ← parent.freq · Σ matching child.freq  (paper §5)."""

    parent: str
    child: str
    on_vars: tuple[str, ...]
    pregroup: bool  # §4.3: group child to distinct keys first


@dataclasses.dataclass(frozen=True)
class MaterializeJoinOp:
    """parent ← parent ⋈ child (row expansion).  In `opt` mode the executor
    groups straight back to the parent attrs (SUM of freq products); in
    `ref` mode the expanded rows are kept (standard engine behaviour)."""

    parent: str
    child: str
    on_vars: tuple[str, ...]
    regroup: bool  # True in `opt` mode


@dataclasses.dataclass(frozen=True)
class FinalAggOp:
    root: str
    group_by: tuple[str, ...]
    aggregates: tuple[Agg, ...]
    dedup: bool  # oma mode: aggregate over live rows (set semantics)


PlanOp = ScanOp | SemiJoinOp | FreqJoinOp | MaterializeJoinOp | FinalAggOp


# ---------------------------------------------------------------------------
# The op-graph IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PlanNode:
    """One op in the plan DAG.

    ``inputs`` are the nodes whose produced states this op consumes — for
    join ops ``(parent_state, child_state)``, for scans ``()``, for the
    final aggregate ``(root_state,)``.  ``struct`` is the alias/var-blind
    structural descriptor of THIS op alone (``None`` marks ops whose result
    is never shareable, e.g. materialising joins with dynamic shapes);
    ``key()`` combines it with the input keys into the content address of
    the whole sub-DAG.
    """

    op: PlanOp
    inputs: tuple["PlanNode", ...]
    struct: tuple | None

    def key(self) -> tuple | None:
        """Content address of this node's sub-DAG: equal keys ⇒ identical
        frequency vectors over the same database.  ``None`` propagates
        upward from any unshareable (opaque / materialising) input."""
        cached = self.__dict__.get("_key", False)
        if cached is not False:
            return cached
        if self.struct is None:
            key = None
        else:
            in_keys = tuple(i.key() for i in self.inputs)
            key = None if any(k is None for k in in_keys) \
                else (self.struct, in_keys)
        self.__dict__["_key"] = key  # frozen dataclass: cache via __dict__
        return key

    def postorder(self) -> list["PlanNode"]:
        """Topological (inputs-first, left-to-right, deduplicated) order of
        this node's sub-DAG, this node last."""
        out: list[PlanNode] = []
        seen: set[int] = set()

        def rec(n: "PlanNode"):
            if id(n) in seen:
                return
            seen.add(id(n))
            for i in n.inputs:
                rec(i)
            out.append(n)

        rec(self)
        return out


def rewrite_dag(root: PlanNode,
                fn: Callable[[PlanNode, tuple[PlanNode, ...]], PlanNode],
                ) -> PlanNode:
    """Bottom-up structural rewrite: ``fn(node, rebuilt_inputs)`` returns
    the replacement node.  Shared sub-DAGs are rewritten once (memoised by
    object identity), so sharing is preserved."""
    memo: dict[int, PlanNode] = {}

    def rec(n: PlanNode) -> PlanNode:
        r = memo.get(id(n))
        if r is None:
            ins = tuple(rec(i) for i in n.inputs)
            memo[id(n)] = r = fn(n, ins)
        return r

    return rec(root)


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


def _short_key(node: PlanNode) -> str:
    k = node.key()
    return "-" if k is None else _digest(k)[:10]


@dataclasses.dataclass(frozen=True)
class Decision:
    """One gated planner decision: which pass, on what, applied or skipped,
    why, and the stat values the gate read.

    ``depends`` maps relation → data-version token (``Table.content_token``)
    for every table whose statistics the gate consulted: a consumer (the
    serving tier's plan cache) declares a persisted decision *stale* —
    and replans — exactly when one of those tokens no longer matches the
    live catalog."""

    pass_name: str
    target: str               # alias / edge / "" for whole-plan decisions
    applied: bool
    reason: str
    stats: tuple = ()         # sorted (name, value) pairs the gate read
    depends: tuple = ()       # sorted (relation, token) pairs

    def describe(self) -> str:
        verdict = "applied" if self.applied else "skipped"
        vals = " ".join(f"{k}={v}" for k, v in self.stats)
        tgt = f" @{self.target}" if self.target else ""
        line = f"{self.pass_name}{tgt}: {verdict} — {self.reason}"
        return f"{line} [{vals}]" if vals else line


@dataclasses.dataclass(frozen=True, eq=False)
class PhysicalPlan:
    """A rooted op DAG.  ``root`` is the FinalAgg node; ``tree`` and
    ``var_cols`` carry the query context the executor needs to resolve
    variables to schema columns and key domains.

    ``decisions`` is the planner's machine-readable decision trace (one
    :class:`Decision` per gated transform considered).  It takes no part
    in node keys or ``graph_key``: a decision only matters to plan identity
    when it changed the emitted graph, and then the op DAG itself already
    differs."""

    mode: str
    root: PlanNode
    tree: JoinTree
    var_cols: dict[str, dict[str, str]]  # alias → {var → schema column}
    decisions: tuple = ()                # tuple[Decision, ...]

    @property
    def nodes(self) -> tuple[PlanNode, ...]:
        """Deterministic topological order of the whole DAG (root last)."""
        cached = self.__dict__.get("_nodes")
        if cached is None:
            cached = tuple(self.root.postorder())
            self.__dict__["_nodes"] = cached
        return cached

    @property
    def ops(self) -> tuple[PlanOp, ...]:
        """Linear op-payload view (a valid topological replay order for
        alias-state interpreters; see module docstring)."""
        return tuple(n.op for n in self.nodes)

    def graph_key(self) -> str | None:
        """Content address of the ENTIRE plan DAG (aggregates included) —
        what the serving tier hashes into a fused program's cache identity.
        ``None`` when any node is unshareable (opaque selections,
        materialising joins)."""
        k = self.root.key()
        return None if k is None else _digest((self.mode, k))

    def subplan_keys(self) -> frozenset:
        """Content keys of this plan's *non-trivial* shareable subplans:
        join nodes and selection-carrying scans.  (A bare scan is just a
        table read — sharing it saves nothing, so it does not make two
        plans worth fusing.)  Two plans whose key sets intersect can be
        compiled into one program that computes each shared sub-DAG once.
        Materialising plans are never jittable, hence never fusable:
        empty."""
        out = set()
        if any(isinstance(n.op, MaterializeJoinOp) for n in self.nodes):
            return frozenset()
        for n in self.nodes:
            k = n.key()
            if k is None:
                continue
            op = n.op
            if isinstance(op, (SemiJoinOp, FreqJoinOp)) or (
                    isinstance(op, ScanOp)
                    and (op.selection is not None or op.spec is not None)):
                out.add(k)
        return frozenset(out)

    def describe(self) -> str:
        """Render the DAG, one node per line, with input edges and short
        content keys — the inspection surface for fusion decisions: two
        plans fuse exactly when they print a common non-trivial key."""
        lines = [f"plan[{self.mode}] root={self.tree.root}"]
        ids = {id(n): i for i, n in enumerate(self.nodes)}
        for i, n in enumerate(self.nodes):
            ins = ", ".join(f"%{ids[id(x)]}" for x in n.inputs)
            ins = f"({ins}) " if ins else ""
            lines.append(f"  %{i} = {n.op!r} {ins}key={_short_key(n)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Node builders (compute the structural descriptor for each op kind)
# ---------------------------------------------------------------------------


def make_scan_node(op: ScanOp, atom) -> PlanNode:
    # repeated variables inside one atom change which column a variable
    # resolves to downstream; capture the equality pattern positionally
    pattern = tuple(atom.vars.index(v) for v in atom.vars)
    if op.selection is not None and op.spec is None:
        sel: object = ("<opaque>", id(op.selection))
    else:
        sel = op.spec
    return PlanNode(op, (), ("scan", op.rel, pattern, sel))


def make_join_node(op: SemiJoinOp | FreqJoinOp, parent: PlanNode,
                   child: PlanNode,
                   var_cols: dict[str, dict[str, str]]) -> PlanNode:
    pcols = tuple(var_cols[op.parent][v] for v in op.on_vars)
    ccols = tuple(var_cols[op.child][v] for v in op.on_vars)
    tag = ("semi",) if isinstance(op, SemiJoinOp) else ("freq", op.pregroup)
    return PlanNode(op, (parent, child), (tag, pcols, ccols))


def make_materialize_node(op: MaterializeJoinOp, parent: PlanNode,
                          child: PlanNode) -> PlanNode:
    # dynamic output shapes: never shareable, poisons downstream keys
    return PlanNode(op, (parent, child), None)


def make_final_agg_node(op: FinalAggOp, root_state: PlanNode,
                        root_atom) -> PlanNode:
    """``root_atom`` is the join-tree atom of ``op.root`` (None when the
    root state is a materialised join result spanning several atoms).

    The struct must pin BOTH the variable names (the executed program's
    output dict is keyed by them — two plans may only share a compiled
    program if their outputs rename identically) AND the root-atom column
    *positions* each variable binds (names alone are role-coloured labels:
    SUM over s_suppkey and SUM over s_nationkey would otherwise collide).
    Any output variable we cannot position structurally makes the node
    unshareable rather than ambiguously keyed."""

    def pos(var: str | None):
        if var is None:
            return None
        if root_atom is None or var not in root_atom.vars:
            raise LookupError
        return root_atom.vars.index(var)

    try:
        aggs = tuple((a.func, a.var, pos(a.var), a.distinct, a.name)
                     for a in op.aggregates)
        groups = tuple((g, pos(g)) for g in op.group_by)
        struct = ("agg", groups, aggs, op.dedup)
    except LookupError:
        struct = None
    return PlanNode(op, (root_state,), struct)
