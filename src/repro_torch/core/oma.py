"""Query classification: guardedness, set-safety, 0MA (paper §3, §4.1).

A query of the paper's Eq.-1 form is

  * guarded       — all grouping + aggregate vars occur in ONE atom (the
                    guard).  COUNT(*) is trivially guarded (empty var set).
  * set-safe      — duplicate elimination on π_U does not change the result:
                    MIN/MAX always; any aggregate with DISTINCT; and
                    schema-derived safety (below).
  * 0MA           — acyclic + guarded + set-safe: evaluable with semi-joins
                    only (the first bottom-up Yannakakis pass).

Schema-derived set-safety: we implement the sound criterion that every join
tree edge below the guard runs along a declared FK(parent) → PK/unique(child)
edge, in which case every guard tuple has at most one extension through the
whole join, so π_U carries no duplicates and *any* aggregate is set-safe.
(This is the same schema knowledge that powers the §4.3 optimisations.)
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hypergraph import JoinTree, build_join_tree
from repro_torch.core.query import SET_SAFE_FUNCS, AggQuery
from repro_torch.tables.table import Schema


@dataclasses.dataclass(frozen=True)
class Classification:
    acyclic: bool
    guarded: bool
    guard: str | None          # alias of a guard atom (if guarded)
    set_safe: bool
    tree: JoinTree | None      # rooted at guard when guarded

    @property
    def is_oma(self) -> bool:
        return self.acyclic and self.guarded and self.set_safe


def find_guards(query: AggQuery) -> list[str]:
    """All atoms containing every output var (candidates for the root)."""
    out = set(query.output_vars())
    return [a.alias for a in query.atoms if out <= set(a.vars)]


def edge_is_fk_pk(tree: JoinTree, schema: Schema, parent: str,
                  child: str) -> bool:
    """True if the (parent, child) join runs along a single declared
    FK(parent column) → unique(child column) edge — then each parent tuple
    has at most one child partner (paper §4.3)."""
    shared = tree.shared_vars(parent, child)
    if len(shared) != 1:
        return False
    var = shared[0]
    pa, ca = tree.atoms[parent], tree.atoms[child]
    p_cols = [schema.relations[pa.rel].columns[i].name
              for i, v in enumerate(pa.vars) if v == var]
    c_cols = [schema.relations[ca.rel].columns[i].name
              for i, v in enumerate(ca.vars) if v == var]
    for pc in p_cols:
        for cc in c_cols:
            if schema.fk_edge(pa.rel, pc, ca.rel, cc):
                if schema.relations[ca.rel].meta(cc).unique:
                    return True
    return False


def subtree_all_fk_pk(tree: JoinTree, schema: Schema, node: str) -> bool:
    """Every edge in the subtree rooted at `node` is FK→PK: frequencies in
    the whole subtree stay identically 1 (paper §4.3, Example 4.2)."""
    for c in tree.children(node):
        if not edge_is_fk_pk(tree, schema, node, c):
            return False
        if not subtree_all_fk_pk(tree, schema, c):
            return False
    return True


def _schema_set_safe(tree: JoinTree, schema: Schema, guard: str) -> bool:
    return subtree_all_fk_pk(tree, schema, guard)


def classify(query: AggQuery, schema: Schema) -> Classification:
    tree = build_join_tree(query.atoms)
    if tree is None:
        return Classification(False, False, None, False, None)
    guards = find_guards(query)
    if not guards:
        return Classification(True, False, None, False, tree)
    # prefer a guard that makes the whole tree FK/PK-safe, else the first
    guard = guards[0]
    for g in guards:
        if _schema_set_safe(tree.rerooted(g), schema, g):
            guard = g
            break
    tree = tree.rerooted(guard)

    def agg_set_safe(ag) -> bool:
        return ag.func in SET_SAFE_FUNCS or ag.distinct

    set_safe = (all(agg_set_safe(ag) for ag in query.aggregates)
                or _schema_set_safe(tree, schema, guard))
    return Classification(True, True, guard, set_safe, tree)
