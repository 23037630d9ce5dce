"""The planner: a pass pipeline lowering logical queries to the op-graph IR
(paper §4), with every transform *gated* and every decision *recorded*.

``plan_query`` turns an AggQuery into a ``PhysicalPlan`` by running a small
sequence of passes over a shared build state:

  1. ``_pass_classify``   — GYO → join tree; classify (acyclic / guarded /
                            set-safe / 0MA); resolve ``mode="auto"``
                            (0MA → semi-join sweep; guarded → FreqJoin
                            sweep (Opt⁺); unguarded/cyclic → materialising
                            baseline, the paper's fallback).
  2. ``_pass_reroot_guard``— re-root the join tree at the guard (§4.1);
                            join trees are freely re-rootable.
  3. ``_pass_lower``      — emit the op graph: one scan node per atom
                            (selections not yet attached), a join node per
                            tree edge (mode-generic sweep), the final
                            aggregate node.
  4. ``_pass_fkpk_degrade``— §4.3 IR rewrite: an edge whose whole child
                            subtree is FK→PK carries frequency ≡ 1, so the
                            FreqJoin/materialising join degrades to a
                            semi-join; child pre-grouping is dropped when
                            the join key is unique in the child.
  5. ``_pass_fk_join_eliminate`` — drop a semi-join against an unfiltered
                            FK→PK leaf entirely when measured statistics
                            prove it filters nothing (zero orphan
                            references); cf. Calcite's
                            FkJoinEliminationRule, made sound here by
                            *measuring* referential integrity instead of
                            trusting the declaration.
  6. ``_pass_prefilter_pushdown`` — in the materialising baseline, push a
                            selective dimension in front of the join chain
                            as a semi-join pre-filter so intermediates
                            shrink before they are expanded (the decision
                            cards' ``date_cte_isolate`` family).
  7. ``_pass_attach_selections`` — rewrite scan nodes to carry the query's
                            per-alias selections (callable + declarative
                            spec), which flows into the nodes' content keys.

Every pass follows the same discipline (the decision-card shape): a
*structural gate* (is the rewrite shape-applicable at all?), then a
*stats calibration* against the :class:`~repro_torch.core.stats.StatsCatalog`
(is it worth it / provably sound on THIS data?), then apply-or-skip — and
each considered candidate leaves a machine-readable
:class:`~repro_torch.core.plan.Decision` on the plan, which ``explain()``
renders and the serving tier uses to detect stale plans (a decision's
``depends`` tokens no longer matching the live catalog ⇒ replan).

With ``stats=None`` (the default — library callers, tests) the two
stats-calibrated passes (5 and 6) record a skip and change nothing: the
planner's output is byte-for-byte what it was before the stats layer
existed.  Modes can be forced (benchmarks compare ref / opt / opt_plus /
oma on the same query, mirroring the paper's experimental conditions).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hypergraph import build_join_tree
from repro_torch.core.oma import classify, edge_is_fk_pk, subtree_all_fk_pk
from repro_torch.core.plan import (
    Decision,
    FinalAggOp,
    FreqJoinOp,
    MaterializeJoinOp,
    PhysicalPlan,
    PlanNode,
    ScanOp,
    SemiJoinOp,
    make_final_agg_node,
    make_join_node,
    make_materialize_node,
    make_scan_node,
    rewrite_dag,
)
from repro_torch.core.query import AggQuery
from repro_torch.core.stats import (
    FK_ELIM_MAX_ORPHANS,
    PREFILTER_MAX_SELECTIVITY,
    PREFILTER_MIN_PARENT_ROWS,
)
from repro_torch.tables.table import Schema


class PlanningError(ValueError):
    """A query the planner cannot lower (cyclic, or a forced mode whose
    preconditions the query fails).  Subclasses ``ValueError`` so existing
    callers' handlers keep working; the serving tier catches it per
    request so one unplannable query never aborts its batch-mates."""


def _var_cols(query: AggQuery, schema: Schema) -> dict[str, dict[str, str]]:
    out: dict[str, dict[str, str]] = {}
    for a in query.atoms:
        cols = schema.relations[a.rel].column_names()
        m: dict[str, str] = {}
        for i, v in enumerate(a.vars):
            m.setdefault(v, cols[i])
        out[a.alias] = m
    return out


def _key_unique_in(schema: Schema, atom, on_vars, var_cols) -> bool:
    cols = [var_cols[atom.alias][v] for v in on_vars]
    return schema.relations[atom.rel].is_unique(cols)


@dataclasses.dataclass
class PlanBuild:
    """Mutable state threaded through the pass pipeline."""

    query: AggQuery
    schema: Schema
    mode: str                 # resolved after _pass_classify
    use_fkpk: bool
    stats: object = None      # StatsCatalog | None — calibration source
    tree: object = None       # JoinTree after _pass_classify
    guard: str | None = None
    var_cols: dict = dataclasses.field(default_factory=dict)
    root: PlanNode | None = None  # FinalAgg node after _pass_lower
    decisions: list = dataclasses.field(default_factory=list)

    def decide(self, pass_name: str, target: str, applied: bool,
               reason: str, stats: dict | None = None,
               rels: tuple = ()) -> bool:
        """Record one gated decision; returns ``applied`` so call sites
        read ``if st.decide(...):``.  ``rels`` names the relations whose
        catalog tokens the gate consulted (→ ``Decision.depends``)."""
        depends = []
        if self.stats is not None:
            for r in sorted(set(rels)):
                tok = self.stats.token(r)
                if tok is not None:
                    depends.append((r, tok))
        self.decisions.append(Decision(
            pass_name=pass_name, target=target, applied=applied,
            reason=reason,
            stats=tuple(sorted((stats or {}).items())),
            depends=tuple(depends)))
        return applied


def _pass_classify(st: PlanBuild) -> PlanBuild:
    cls = classify(st.query, st.schema)
    if cls.tree is None:
        raise PlanningError(
            "cyclic query: out of the paper's guarded-acyclic fragment "
            "(would need hypertree decomposition, see paper §7)")
    st.tree = cls.tree
    st.guard = cls.guard
    st.var_cols = _var_cols(st.query, st.schema)
    if st.mode == "auto":
        if cls.is_oma:
            st.mode = "oma"
        elif cls.guarded:
            st.mode = "opt_plus"
        else:
            st.mode = "ref"
    if st.mode == "oma" and not cls.is_oma:
        raise PlanningError("query is not 0MA; cannot force oma mode")
    if st.mode in ("opt", "opt_plus") and not cls.guarded:
        raise PlanningError("query is not guarded; frequency propagation "
                            "would lose the aggregate attributes")
    st.decide("classify", "", True,
              f"mode={st.mode}",
              {"acyclic": cls.acyclic, "guarded": cls.guarded,
               "oma": cls.is_oma, "set_safe": cls.set_safe,
               "guard": cls.guard or ""})
    return st


def _pass_reroot_guard(st: PlanBuild) -> PlanBuild:
    # classify() already roots the tree at its preferred guard (it tries
    # each guard candidate for whole-tree FK/PK safety); this pass is the
    # explicit seam where an alternative rooting policy would plug in.
    if st.guard is None:
        st.decide("reroot_guard", "", False, "no guard: unguarded query")
    elif st.tree.root != st.guard:
        st.tree = st.tree.rerooted(st.guard)
        st.decide("reroot_guard", st.guard, True,
                  f"re-rooted join tree at guard {st.guard!r} (§4.1)")
    else:
        st.decide("reroot_guard", st.guard, False,
                  f"tree already rooted at guard {st.guard!r}")
    return st


def _pass_lower(st: PlanBuild) -> PlanBuild:
    """Emit the op graph: scans, the mode-generic join sweep, final agg."""
    query, tree, mode = st.query, st.tree, st.mode
    cur: dict[str, PlanNode] = {}
    for a in query.atoms:
        op = ScanOp(a.alias, a.rel, None, spec=None)
        cur[a.alias] = make_scan_node(op, a)

    if mode == "ref":
        # left-deep materialising joins in join-tree connectivity order so
        # every join has a shared key (no cross products).
        order = [u for u in reversed(tree.postorder())]  # root first
        base = order[0]
        for nxt in order[1:]:
            par = tree.parent[nxt]
            on = tree.shared_vars(par, nxt) if par is not None else ()
            op = MaterializeJoinOp(base, nxt, on, regroup=False)
            cur[base] = make_materialize_node(op, cur[base], cur[nxt])
        agg = FinalAggOp(base, query.group_by, query.aggregates,
                         dedup=False)
        st.root = make_final_agg_node(agg, cur[base], tree.atoms.get(base))
        st.decide("lower", "", True,
                  "materialising left-deep join chain (ref baseline)",
                  {"mode": mode, "atoms": len(query.atoms)})
        return st

    # bottom-up sweep over join-tree edges (children before parents)
    for parent, child in tree.edges_bottom_up():
        on = tree.shared_vars(parent, child)
        if mode == "oma":
            op = SemiJoinOp(parent, child, on)
            cur[parent] = make_join_node(op, cur[parent], cur[child],
                                         st.var_cols)
        elif mode == "opt":
            op = MaterializeJoinOp(parent, child, on, regroup=True)
            cur[parent] = make_materialize_node(op, cur[parent], cur[child])
        else:  # opt_plus
            op = FreqJoinOp(parent, child, on, pregroup=True)
            cur[parent] = make_join_node(op, cur[parent], cur[child],
                                         st.var_cols)

    agg = FinalAggOp(tree.root, query.group_by, query.aggregates,
                     dedup=(mode == "oma"))
    st.root = make_final_agg_node(agg, cur[tree.root],
                                  tree.atoms.get(tree.root))
    st.decide("lower", "", True,
              f"bottom-up {mode} sweep over join-tree edges",
              {"mode": mode, "atoms": len(query.atoms)})
    return st


def _pass_fkpk_degrade(st: PlanBuild) -> PlanBuild:
    """§4.3 as an IR rewrite over the lowered graph."""
    if not st.use_fkpk or st.mode not in ("opt", "opt_plus"):
        st.decide("fkpk_degrade", "", False,
                  "gate: use_fkpk off" if not st.use_fkpk
                  else f"gate: mode {st.mode!r} has no freq joins to "
                       "degrade")
        return st
    tree, schema, var_cols = st.tree, st.schema, st.var_cols

    def rw(node: PlanNode, ins: tuple[PlanNode, ...]) -> PlanNode:
        op = node.op
        if isinstance(op, (FreqJoinOp, MaterializeJoinOp)) \
                and tree.parent.get(op.child) == op.parent:
            edge = f"{op.parent}⋈{op.child}"
            fkpk = edge_is_fk_pk(tree, schema, op.parent, op.child) \
                and subtree_all_fk_pk(tree, schema, op.child)
            if fkpk:
                # child freq ≡ 1 and ≤1 partner: the join degenerates to a
                # semi-join (§4.3) — skip the grouping machinery entirely.
                st.decide("fkpk_degrade", edge, True,
                          "whole child subtree is FK→PK: freq ≡ 1, join "
                          "degrades to semi-join (§4.3)")
                semi = SemiJoinOp(op.parent, op.child, op.on_vars)
                return make_join_node(semi, ins[0], ins[1], var_cols)
            st.decide("fkpk_degrade", edge, False,
                      "child subtree not FK→PK throughout")
            if isinstance(op, FreqJoinOp):
                pregroup = not _key_unique_in(
                    schema, tree.atoms[op.child], op.on_vars, var_cols)
                if pregroup != op.pregroup:
                    rep = dataclasses.replace(op, pregroup=pregroup)
                    return make_join_node(rep, ins[0], ins[1], var_cols)
        return _rebuild(node, ins, st)

    st.root = rewrite_dag(st.root, rw)
    return st


def _fk_edge_cols(st: PlanBuild, parent: str, child: str,
                  on_vars) -> tuple[str, str, str, str] | None:
    """(src_rel, src_col, dst_rel, dst_col) of the declared FK behind an
    FK→PK tree edge, or None."""
    if len(on_vars) != 1:
        return None
    v = on_vars[0]
    src_rel = st.tree.atoms[parent].rel
    dst_rel = st.tree.atoms[child].rel
    src_col = st.var_cols[parent].get(v)
    dst_col = st.var_cols[child].get(v)
    if src_col is None or dst_col is None:
        return None
    return src_rel, src_col, dst_rel, dst_col


def _pass_fk_join_eliminate(st: PlanBuild) -> PlanBuild:
    """Drop semi-joins that provably filter nothing.

    Structural gate: a ``SemiJoinOp`` on a tree edge whose child input is
    a bare leaf scan, the edge is a declared FK→PK, the child carries no
    selection, and no child-exclusive variable feeds the output.  Under
    those conditions the semi-join can only remove parent rows whose FK
    value has no live partner — *orphans*.

    Stats calibration: measured orphan count for that FK must be
    ``<= FK_ELIM_MAX_ORPHANS`` (i.e. zero).  Referential integrity is
    never assumed from the declaration alone: the catalog counted it on
    this exact data version, and the decision's ``depends`` tokens pin
    both tables so any later change invalidates the plan."""
    if st.mode not in ("oma", "opt", "opt_plus"):
        st.decide("fk_join_eliminate", "", False,
                  "gate: materialising baseline emits no semi-joins")
        return st
    query, needed = st.query, set(st.query.output_vars())

    def rw(node: PlanNode, ins: tuple[PlanNode, ...]) -> PlanNode:
        op = node.op
        if not (isinstance(op, SemiJoinOp)
                and isinstance(ins[1].op, ScanOp)
                and st.tree.parent.get(op.child) == op.parent):
            return _rebuild(node, ins, st)
        edge = f"{op.parent}⋉{op.child}"
        if op.child in query.selections or op.child in query.selection_specs:
            st.decide("fk_join_eliminate", edge, False,
                      "child carries a selection: the semi-join filters")
            return _rebuild(node, ins, st)
        extra = set(st.tree.atoms[op.child].vars) - set(op.on_vars)
        if extra & needed:
            st.decide("fk_join_eliminate", edge, False,
                      f"child vars {sorted(extra & needed)} feed the "
                      "output")
            return _rebuild(node, ins, st)
        fk = _fk_edge_cols(st, op.parent, op.child, op.on_vars)
        if fk is None or not st.schema.fk_edge(*fk) \
                or not edge_is_fk_pk(st.tree, st.schema, op.parent,
                                     op.child):
            st.decide("fk_join_eliminate", edge, False,
                      "edge is not a declared FK→PK")
            return _rebuild(node, ins, st)
        if st.stats is None:
            st.decide("fk_join_eliminate", edge, False,
                      "no stats catalog: orphan count unverifiable")
            return _rebuild(node, ins, st)
        src_rel, src_col, dst_rel, dst_col = fk
        tstats = st.stats.get(src_rel)
        orphans = None if tstats is None else \
            tstats.fk_orphans.get(f"{src_col}->{dst_rel}.{dst_col}")
        if orphans is None:
            st.decide("fk_join_eliminate", edge, False,
                      f"no orphan statistics for {src_rel}.{src_col}",
                      rels=(src_rel, dst_rel))
            return _rebuild(node, ins, st)
        if orphans > FK_ELIM_MAX_ORPHANS:
            st.decide("fk_join_eliminate", edge, False,
                      f"{orphans} orphaned {src_rel}.{src_col} refs: "
                      "the semi-join filters them",
                      {"orphans": orphans,
                       "max_orphans": FK_ELIM_MAX_ORPHANS},
                      rels=(src_rel, dst_rel))
            return _rebuild(node, ins, st)
        st.decide("fk_join_eliminate", edge, True,
                  "FK→PK with zero measured orphans: the semi-join is an "
                  "identity on live rows — eliminated",
                  {"orphans": orphans,
                   "max_orphans": FK_ELIM_MAX_ORPHANS},
                  rels=(src_rel, dst_rel))
        return ins[0]

    st.root = rewrite_dag(st.root, rw)
    return st


def _pass_prefilter_pushdown(st: PlanBuild) -> PlanBuild:
    """Selective-dimension pre-filter pushdown for the materialising
    baseline.

    Structural gate: ``mode == "ref"`` (sweep modes already filter every
    edge bottom-up — a pre-filter would duplicate work the static-shape
    sweep does anyway), and a join-tree edge (parent, child) where the
    child carries a *declarative* selection spec.

    Stats calibration: the child's estimated selectivity must be
    ``<= PREFILTER_MAX_SELECTIVITY`` and the parent big enough
    (``>= PREFILTER_MIN_PARENT_ROWS``) that shrinking the materialised
    intermediates pays for an extra semi-join.

    Apply: the parent's scan is wrapped in a semi-join against the
    (soon-to-be-filtered) child scan, so parent rows that would join to
    nothing are dead *before* the row-expanding joins run.  Answer-
    preserving: a parent row with no surviving child partner contributes
    no tuple to the join result either way."""
    if st.mode != "ref":
        st.decide("prefilter_pushdown", "", False,
                  f"gate: {st.mode} sweeps already semi-filter every edge")
        return st
    if st.stats is None:
        st.decide("prefilter_pushdown", "", False,
                  "no stats catalog: selectivity unverifiable")
        return st

    query = st.query
    # candidate pre-filters, grouped by the parent alias whose scan they
    # wrap (a parent with several selective children gets nested filters)
    wraps: dict[str, list] = {}
    for parent, child in st.tree.edges_bottom_up():
        spec = query.selection_specs.get(child)
        if spec is None:
            continue
        edge = f"{parent}⋉{child}"
        child_rel = st.tree.atoms[child].rel
        parent_rel = st.tree.atoms[parent].rel
        sel = st.stats.estimate_selectivity(child_rel, spec)
        pstats = st.stats.get(parent_rel)
        prows = pstats.rows if pstats is not None else None
        if sel is None or prows is None:
            st.decide("prefilter_pushdown", edge, False,
                      f"no statistics for {child_rel}/{parent_rel}",
                      rels=(child_rel, parent_rel))
            continue
        gate = {"selectivity": round(sel, 4),
                "max_selectivity": PREFILTER_MAX_SELECTIVITY,
                "parent_rows": prows,
                "min_parent_rows": PREFILTER_MIN_PARENT_ROWS}
        if sel > PREFILTER_MAX_SELECTIVITY:
            st.decide("prefilter_pushdown", edge, False,
                      f"child {child_rel} not selective enough",
                      gate, rels=(child_rel, parent_rel))
            continue
        if prows < PREFILTER_MIN_PARENT_ROWS:
            st.decide("prefilter_pushdown", edge, False,
                      f"parent {parent_rel} too small: semi-join overhead "
                      "exceeds the materialisation saved",
                      gate, rels=(child_rel, parent_rel))
            continue
        st.decide("prefilter_pushdown", edge, True,
                  f"selective {child_rel} pre-filters {parent_rel} before "
                  "the materialising chain",
                  gate, rels=(child_rel, parent_rel))
        on = st.tree.shared_vars(parent, child)
        wraps.setdefault(parent, []).append((child, on))
    if not wraps:
        return st

    # locate the shared child scan nodes so the inserted semi-joins reuse
    # the very nodes the join chain reads (selections attach once, later)
    scans = {n.op.alias: n for n in st.root.postorder()
             if isinstance(n.op, ScanOp)}

    def rw(node: PlanNode, ins: tuple[PlanNode, ...]) -> PlanNode:
        op = node.op
        if isinstance(op, ScanOp) and op.alias in wraps:
            out = node
            for child, on in wraps[op.alias]:
                semi = SemiJoinOp(op.alias, child, on)
                out = make_join_node(semi, out, scans[child], st.var_cols)
            return out
        return _rebuild(node, ins, st)

    st.root = rewrite_dag(st.root, rw)
    return st


def _pass_attach_selections(st: PlanBuild) -> PlanBuild:
    """Attach the query's per-alias selections to the scan nodes."""
    query = st.query
    if not query.selections:
        return st

    def rw(node: PlanNode, ins: tuple[PlanNode, ...]) -> PlanNode:
        op = node.op
        if isinstance(op, ScanOp) and op.alias in query.selections:
            rep = dataclasses.replace(
                op, selection=query.selections[op.alias],
                spec=query.selection_specs.get(op.alias))
            return make_scan_node(rep, query.atom(op.alias))
        return _rebuild(node, ins, st)

    st.root = rewrite_dag(st.root, rw)
    return st


def _rebuild(node: PlanNode, ins: tuple[PlanNode, ...],
             st: PlanBuild) -> PlanNode:
    """Re-create `node` over rewritten inputs (identity when unchanged)."""
    if ins == node.inputs:
        return node
    op = node.op
    if isinstance(op, (SemiJoinOp, FreqJoinOp)):
        return make_join_node(op, ins[0], ins[1], st.var_cols)
    if isinstance(op, MaterializeJoinOp):
        return make_materialize_node(op, ins[0], ins[1])
    if isinstance(op, FinalAggOp):
        return make_final_agg_node(op, ins[0],
                                   st.tree.atoms.get(op.root))
    return PlanNode(op, ins, node.struct)  # pragma: no cover


PASSES = (
    _pass_classify,
    _pass_reroot_guard,
    _pass_lower,
    _pass_fkpk_degrade,
    _pass_fk_join_eliminate,
    _pass_prefilter_pushdown,
    _pass_attach_selections,
)


def plan_query(query: AggQuery, schema: Schema, mode: str = "auto",
               use_fkpk: bool = False, stats=None) -> PhysicalPlan:
    """Plan ``query``.  ``stats`` is an optional
    :class:`~repro_torch.core.stats.StatsCatalog`: with it, the stats-calibrated
    passes (FK-join elimination, pre-filter pushdown) may fire; without
    it they record a skip and the output matches the stats-free planner
    exactly.  Raises :class:`PlanningError` for unplannable queries."""
    st = PlanBuild(query, schema, mode, use_fkpk, stats=stats)
    for p in PASSES:
        st = p(st)
    return PhysicalPlan(st.mode, st.root, st.tree, st.var_cols,
                        decisions=tuple(st.decisions))


__all__ = ["plan_query", "classify", "build_join_tree", "PASSES",
           "PlanBuild", "PlanningError"]
