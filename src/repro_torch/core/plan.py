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
from repro_torch.core.query import Agg, Atom, selection_from_spec


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
    live catalog.  Purely JSON-able so the trace survives the plan store."""

    pass_name: str
    target: str               # alias / edge / "" for whole-plan decisions
    applied: bool
    reason: str
    stats: tuple = ()         # sorted (name, value) pairs the gate read
    depends: tuple = ()       # sorted (relation, token) pairs

    def to_payload(self) -> dict:
        return {"pass": self.pass_name, "target": self.target,
                "applied": self.applied, "reason": self.reason,
                "stats": [list(kv) for kv in self.stats],
                "depends": [list(kv) for kv in self.depends]}

    @classmethod
    def from_payload(cls, p: dict) -> "Decision":
        return cls(pass_name=p["pass"], target=p["target"],
                   applied=bool(p["applied"]), reason=p["reason"],
                   stats=tuple(tuple(kv) for kv in p["stats"]),
                   depends=tuple(tuple(kv) for kv in p["depends"]))

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
    :class:`Decision` per gated transform considered).  It is deliberately
    EXCLUDED from ``cache_key``: a decision only matters to plan identity
    when it changed the emitted graph, and then the op DAG itself already
    differs — two structurally identical plans are interchangeable no
    matter what the planner pondered on the way."""

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

    def cache_key(self) -> tuple:
        """Structural identity for plan caching.  Op payload tuples hash by
        field values; ``ScanOp.selection`` callables hash by object
        identity, which is exactly right — two plans sharing a selection
        object are interchangeable, two plans with distinct closures are
        only unified upstream by the query fingerprint (which compares
        declarative selection specs, not closures)."""
        return (self.mode, self.ops, self.tree.cache_key(),
                tuple(sorted((a, tuple(sorted(m.items())))
                             for a, m in self.var_cols.items())))

    def __eq__(self, other):
        return (isinstance(other, PhysicalPlan)
                and self.cache_key() == other.cache_key())

    def __hash__(self):
        return hash(self.cache_key())

    def scanned_rels(self) -> tuple[str, ...]:
        """Relations this plan reads, sorted — the serving tier passes only
        these to the compiled executable so unrelated tables can't force a
        retrace."""
        return tuple(sorted({n.op.rel for n in self.nodes
                             if isinstance(n.op, ScanOp)}))

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


# ---------------------------------------------------------------------------
# Plan segmentation (cross-fingerprint fusion support)
# ---------------------------------------------------------------------------
#
# A zero-materialisation plan is `prefix ; suffix`: the prefix (scans +
# semi-join/FreqJoin sweep) computes the root relation's frequency vector,
# the suffix (FinalAggOp) folds it into answers.  ``prefix_key`` is the
# WHOLE-prefix identity (the older fusion condition, still reported so the
# serving tier can distinguish whole-prefix fusion from the strictly more
# general subplan-overlap fusion that ``subplan_keys`` drives).


@dataclasses.dataclass(frozen=True)
class PlanSegments:
    """A plan split at the aggregate boundary.

    ``prefix_key`` is the structural identity of the root frequency vector
    the prefix computes: two plans with equal keys (and equal shape
    buckets) share their *entire* prefix.  ``None`` marks plans with no
    shareable prefix (materialising ops, whose dataflow is dynamic and
    never compiled anyway).
    """

    prefix_ops: tuple[PlanOp, ...]
    suffix_ops: tuple[PlanOp, ...]
    prefix_key: str | None


def op_result_keys(plan: "PhysicalPlan") -> list[tuple | None]:
    """Per-node structural keys for the frequency vector each op produces,
    aligned with ``plan.ops`` (``None`` for ops that produce none / are
    never shared).  Two ops with equal keys — possibly from different
    plans — compute identical vectors over the same database, which is what
    lets ``Executor.compile_multi`` deduplicate shared work across member
    plans."""
    return [n.key() if isinstance(n.op, (ScanOp, SemiJoinOp, FreqJoinOp))
            else None for n in plan.nodes]


def segment_plan(plan: "PhysicalPlan") -> PlanSegments:
    """Split `plan` into (shareable prefix, per-query suffix)."""
    prefix = tuple(op for op in plan.ops if not isinstance(op, FinalAggOp))
    suffix = tuple(op for op in plan.ops if isinstance(op, FinalAggOp))
    prefix_key: str | None = None
    if not any(isinstance(op, MaterializeJoinOp) for op in plan.ops):
        root_key = plan.root.inputs[0].key()
        if root_key is not None:
            prefix_key = _digest(root_key)
    return PlanSegments(prefix, suffix, prefix_key)


# ---------------------------------------------------------------------------
# Stable plan serialisation (cross-process plan-cache persistence)
# ---------------------------------------------------------------------------
#
# A payload is plain JSON-able data: the DAG as a topologically ordered node
# list with integer input edges, plus the query context (join tree, alias →
# var → column maps).  Deserialisation re-runs the SAME node builders the
# planner uses (``make_scan_node`` & co.), so every structural descriptor —
# and therefore ``key()``, ``graph_key()`` and ``subplan_keys()`` — is
# recomputed rather than trusted from disk: a reloaded plan is
# content-identical to one freshly planned, which is what lets a warm
# process fuse it against live plans.
#
# The one thing a payload cannot carry is an opaque selection callable;
# plans whose scans attach a selection without a declarative ``spec`` raise
# ``PlanNotSerialisable`` (their fingerprints are process-salted singletons
# anyway, so persisting them would be meaningless).  Spec-carrying
# selections are rebuilt from the spec via ``selection_from_spec`` — the
# same builder the SQL front-end uses — so reloaded scans select
# bitwise-identically.


class PlanNotSerialisable(ValueError):
    """The plan carries state that cannot survive a process boundary
    (an opaque selection callable without a declarative spec)."""


def _spec_to_jsonable(spec: tuple | None):
    if spec is None:
        return None
    return [[op, col, list(val) if op == "in" else val]
            for op, col, val in spec]


def _spec_from_jsonable(spec) -> tuple | None:
    if spec is None:
        return None
    return tuple((op, col, tuple(val) if op == "in" else val)
                 for op, col, val in spec)


def plan_to_payload(plan: "PhysicalPlan") -> dict:
    """Serialise a plan into a JSON-able payload (see section comment).

    Raises ``PlanNotSerialisable`` for plans with opaque selections."""
    nodes = plan.nodes
    index = {id(n): i for i, n in enumerate(nodes)}
    entries = []
    for n in nodes:
        op = n.op
        e: dict = {"inputs": [index[id(i)] for i in n.inputs]}
        if isinstance(op, ScanOp):
            if op.selection is not None and op.spec is None:
                raise PlanNotSerialisable(
                    f"scan of {op.rel!r} (alias {op.alias!r}) attaches an "
                    "opaque selection callable with no declarative spec; "
                    "it cannot be rebuilt in another process")
            e.update(kind="scan", alias=op.alias, rel=op.rel,
                     spec=_spec_to_jsonable(op.spec))
        elif isinstance(op, SemiJoinOp):
            e.update(kind="semi", parent=op.parent, child=op.child,
                     on_vars=list(op.on_vars))
        elif isinstance(op, FreqJoinOp):
            e.update(kind="freq", parent=op.parent, child=op.child,
                     on_vars=list(op.on_vars), pregroup=op.pregroup)
        elif isinstance(op, MaterializeJoinOp):
            e.update(kind="mat", parent=op.parent, child=op.child,
                     on_vars=list(op.on_vars), regroup=op.regroup)
        elif isinstance(op, FinalAggOp):
            e.update(kind="agg", root=op.root, group_by=list(op.group_by),
                     dedup=op.dedup,
                     aggregates=[{"func": a.func, "var": a.var,
                                  "distinct": a.distinct, "name": a.name}
                                 for a in op.aggregates])
        else:  # pragma: no cover
            raise PlanNotSerialisable(f"unknown op {op!r}")
        entries.append(e)
    tree = plan.tree
    return {
        "mode": plan.mode,
        "root": index[id(plan.root)],
        "nodes": entries,
        "tree": {
            "root": tree.root,
            "parent": dict(tree.parent),
            "atoms": {alias: {"rel": a.rel, "vars": list(a.vars)}
                      for alias, a in tree.atoms.items()},
        },
        "var_cols": {alias: dict(m) for alias, m in plan.var_cols.items()},
        "decisions": [d.to_payload() for d in plan.decisions],
    }


def plan_from_payload(payload: dict) -> "PhysicalPlan":
    """Rebuild a ``PhysicalPlan`` from ``plan_to_payload`` output.

    Node structural descriptors (hence content keys) are recomputed by the
    planner's own builders, never read from the payload."""
    tdoc = payload["tree"]
    atoms = {alias: Atom(a["rel"], alias, tuple(a["vars"]))
             for alias, a in tdoc["atoms"].items()}
    tree = JoinTree(tdoc["root"],
                    {alias: p for alias, p in tdoc["parent"].items()},
                    atoms)
    var_cols = {alias: dict(m) for alias, m in payload["var_cols"].items()}

    nodes: list[PlanNode] = []
    for e in payload["nodes"]:
        ins = tuple(nodes[i] for i in e["inputs"])
        kind = e["kind"]
        if kind == "scan":
            spec = _spec_from_jsonable(e["spec"])
            sel = selection_from_spec(spec) if spec is not None else None
            op = ScanOp(e["alias"], e["rel"], sel, spec)
            nodes.append(make_scan_node(op, atoms[e["alias"]]))
        elif kind == "semi":
            op = SemiJoinOp(e["parent"], e["child"], tuple(e["on_vars"]))
            nodes.append(make_join_node(op, ins[0], ins[1], var_cols))
        elif kind == "freq":
            op = FreqJoinOp(e["parent"], e["child"], tuple(e["on_vars"]),
                            e["pregroup"])
            nodes.append(make_join_node(op, ins[0], ins[1], var_cols))
        elif kind == "mat":
            op = MaterializeJoinOp(e["parent"], e["child"],
                                   tuple(e["on_vars"]), e["regroup"])
            nodes.append(make_materialize_node(op, ins[0], ins[1]))
        elif kind == "agg":
            op = FinalAggOp(
                e["root"], tuple(e["group_by"]),
                tuple(Agg(a["func"], a["var"], distinct=a["distinct"],
                          name=a["name"]) for a in e["aggregates"]),
                e["dedup"])
            nodes.append(make_final_agg_node(op, ins[0],
                                             atoms.get(e["root"])))
        else:
            raise ValueError(f"unknown node kind {kind!r}")
    decisions = tuple(Decision.from_payload(d)
                      for d in payload.get("decisions", ()))
    return PhysicalPlan(payload["mode"], nodes[payload["root"]], tree,
                        var_cols, decisions=decisions)
