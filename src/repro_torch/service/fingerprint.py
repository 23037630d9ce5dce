"""Query fingerprinting: canonicalise an AggQuery into a stable identity.

Two SQL texts that differ only in alias names, alias order, WHERE-clause
order, SELECT-list order, or the variable names a front-end invented must
hit the same plan-cache entry — the whole point of serving guarded
aggregate plans is that the (classify → re-root → rewrite → compile) pipeline
runs once per query *structure*, not once per request string.

Canonicalisation:

  1. Colour query variables by a Weisfeiler–Leman-style refinement over
     their occurrences (relation, column position, selection specs of the
     host atom, colours of co-occurring variables) seeded with their
     aggregate/grouping roles.  Variables are renamed ``v0, v1, ...`` in
     colour order; atoms are sorted by (relation, renamed vars, selection
     spec) and re-aliased ``t0, t1, ...``; aggregates and GROUP BY keys are
     sorted canonically with positional back-maps to the caller's names.
  2. The fingerprint is the SHA-256 of the canonical structure.

Colour ties between non-symmetric variables can at worst split one
structure over two fingerprints (a spurious cache miss, never a spurious
hit): a fingerprint *collision* requires identical canonical structures,
which by construction describe the same query up to renaming.

Queries carrying opaque selection callables without declarative
``selection_specs`` cannot be proven equivalent to anything, so their
fingerprints are salted with a process-unique nonce: they cache as
singletons (repeat submissions of the *same object* still hit).

Besides the full fingerprint, canonicalisation exposes a **prefix
fingerprint**: the identity of the scan/join structure alone, computed
with aggregate/GROUP BY roles excluded from the colouring.  Two queries
with different fingerprints but equal prefix fingerprints read the same
relations through the same join shape with the same selections.  (Since
the op-graph IR, fusion *grouping* is plan-level — subplan-key overlap on
the plan DAG, which also admits partially overlapping join shapes; the
prefix fingerprint remains the query-level whole-prefix identity, used for
diagnostics such as the ``partial_fusions`` counter.)
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import weakref

from repro_torch.core.query import Agg, AggQuery, Atom

_OPAQUE_NONCE = itertools.count()
# query object → its salted fingerprint, so re-submitting the SAME object
# re-uses its singleton cache entry (weak: dropping the query drops it)
_OPAQUE_FPS: "weakref.WeakKeyDictionary[AggQuery, str]" = \
    weakref.WeakKeyDictionary()


def _h(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class CanonicalQuery:
    """A canonicalised query plus the maps back to the request's names.

    ``query``        — the canonical AggQuery (plan and compile against
                       this; structurally identical requests share it).
    ``fingerprint``  — stable hex identity (plan-cache key).
    ``prefix_fingerprint`` — identity of the query's scan/join structure
                       alone (atoms + selections, aggregate- and
                       GROUP-BY-blind).  Two *different* fingerprints with
                       equal prefix fingerprints read the same relations
                       through the same join shape and are candidates for
                       fused cross-fingerprint batching (the exact test is
                       plan-level: ``repro_torch.core.plan.segment_plan``, which
                       also accounts for guard rooting).
    ``shareable``    — False when opaque selections forced a singleton.
    ``agg_names``    — requested output name per canonical aggregate
                       (canonical aggregate i is named ``agg{i}``).
    ``group_names``  — requested variable name per canonical GROUP BY key.
    """

    query: AggQuery
    fingerprint: str
    prefix_fingerprint: str
    shareable: bool
    agg_names: tuple[str, ...]
    group_names: tuple[str, ...]

    def rename_results(self, results: dict) -> dict:
        """Map a canonical result dict back to the request's names.

        Only answer keys survive: executor bookkeeping such as the
        ``__stats__`` sentinel never reaches ``QueryResult.values`` (eager
        stats travel via ``ServeStats.exec_stats``)."""
        out = {}
        for i, name in enumerate(self.agg_names):
            key = f"agg{i}"
            if key in results:
                out[name] = results[key]
        if "groups" in results:
            cols = {}
            canon_groups = self.query.group_by
            back = dict(zip(canon_groups, self.group_names))
            for k, v in results["groups"].items():
                cols[back.get(k, k)] = v
            # grouped aggregate columns keyed agg{i} live inside "groups"
            for i, name in enumerate(self.agg_names):
                key = f"agg{i}"
                if key in cols:
                    cols[name] = cols.pop(key)
            out["groups"] = cols
            out["valid"] = results["valid"]
        return out


def _canon_spec(spec: tuple) -> tuple:
    """Order-independent form of one alias's selection terms."""
    terms = []
    for op, col, val in spec:
        if op == "in":
            val = tuple(sorted(val, key=repr))
        terms.append((op, col, val))
    return tuple(sorted(terms, key=repr))


def _canonical_atom_entries(query: AggQuery, specs: dict[str, tuple],
                            seed_roles: bool, occ=None):
    """WL-colour variables and return sorted canonical atom entries.

    ``seed_roles=True`` seeds colours with aggregate/GROUP BY roles — the
    full-query canonical form.  ``seed_roles=False`` colours by occurrence
    structure alone, so two queries differing only in which aggregates they
    compute over the same join produce identical entries: the basis of the
    prefix fingerprint.  ``occ`` lets the caller share one occurrence map
    across both colourings."""
    if occ is None:
        occ = {}
        for a in query.atoms:
            for i, v in enumerate(a.vars):
                occ.setdefault(v, []).append((a.rel, i, a.alias))
    roles: dict[str, list] = {}
    if seed_roles:
        for ag in query.aggregates:
            if ag.var is not None:
                roles.setdefault(ag.var, []).append((ag.func, ag.distinct))
    color = {}
    for v, sites in occ.items():
        color[v] = _h((sorted((r, i) for r, i, _ in sites),
                       seed_roles and v in query.group_by,
                       sorted(roles.get(v, ()))))
    for _ in range(len(color)):
        new = {}
        for v, sites in occ.items():
            ctx = []
            for rel, i, alias in sites:
                at = query.atom(alias)
                ctx.append((rel, i, specs.get(alias, ()),
                            tuple(color[w] for w in at.vars)))
            new[v] = _h((color[v], sorted(ctx, key=repr)))
        if new == color:
            break
        color = new

    # ties keep first-occurrence order (sorted() is stable) — symmetric
    # variables are interchangeable, non-symmetric WL ties only risk a
    # spurious miss (see module docstring)
    vmap = {v: f"v{i}"
            for i, v in enumerate(sorted(occ, key=lambda v: color[v]))}

    entries = sorted(
        ((a.rel, tuple(vmap[v] for v in a.vars), specs.get(a.alias, ()),
          a.alias) for a in query.atoms),
        key=lambda e: (e[0], e[1], repr(e[2])))
    return entries, vmap


def canonicalize(query: AggQuery) -> CanonicalQuery:
    # --- declarative selection specs (or opaque markers) per alias -------
    specs: dict[str, tuple] = {}
    shareable = True
    for alias in query.selections:
        spec = query.selection_specs.get(alias)
        if spec is None:
            shareable = False
            specs[alias] = ("<opaque>",)
        else:
            specs[alias] = _canon_spec(spec)

    occ: dict[str, list[tuple[str, int, str]]] = {}
    for a in query.atoms:
        for i, v in enumerate(a.vars):
            occ.setdefault(v, []).append((a.rel, i, a.alias))
    entries, vmap = _canonical_atom_entries(query, specs, seed_roles=True,
                                            occ=occ)
    amap = {alias: f"t{i}" for i, (_, _, _, alias) in enumerate(entries)}
    catoms = tuple(Atom(rel, amap[alias], vars_)
                   for rel, vars_, _, alias in entries)

    # --- canonical aggregates (sorted; positional name back-map) ---------
    agg_entries = sorted(
        ((ag.func, vmap[ag.var] if ag.var is not None else "",
          ag.distinct, idx) for idx, ag in enumerate(query.aggregates)))
    caggs = tuple(Agg(func, var or None, distinct=distinct, name=f"agg{i}")
                  for i, (func, var, distinct, _) in enumerate(agg_entries))
    agg_names = tuple(query.aggregates[idx].name
                      for _, _, _, idx in agg_entries)

    # --- canonical GROUP BY (sorted; name back-map) ----------------------
    g_entries = sorted((vmap[g], g) for g in query.group_by)
    cgroup = tuple(cv for cv, _ in g_entries)
    group_names = tuple(g for _, g in g_entries)

    csel = {amap[alias]: fn for alias, fn in query.selections.items()}
    cspecs = {amap[alias]: specs[alias] for alias in query.selections
              if query.selection_specs.get(alias) is not None}
    cquery = AggQuery(atoms=catoms, aggregates=caggs, group_by=cgroup,
                      selections=csel, selection_specs=cspecs)

    payload = (tuple((rel, vars_, spec) for rel, vars_, spec, _ in entries),
               tuple((f, v, d) for f, v, d, _ in agg_entries),
               cgroup,
               tuple(sorted((amap[a], s) for a, s in specs.items())))
    fp = _h(payload)

    # --- prefix fingerprint: the scan/join structure, role-blind ---------
    # when the query has no variable roles at all (COUNT(*), no GROUP BY)
    # the seeded colouring already IS role-blind — skip the second pass
    if not query.group_by and all(ag.var is None for ag in query.aggregates):
        p_entries = entries
    else:
        p_entries, _ = _canonical_atom_entries(query, specs,
                                               seed_roles=False, occ=occ)
    prefix_fp = _h(tuple((rel, vars_, spec)
                         for rel, vars_, spec, _ in p_entries))

    if not shareable:
        salted = _OPAQUE_FPS.get(query)
        if salted is None:
            salted = f"{fp}:opaque{next(_OPAQUE_NONCE)}"
            _OPAQUE_FPS[query] = salted
        fp = salted
        # an opaque selection can't be proven equal to anything, so the
        # prefix can't fuse across objects either: salt it identically
        prefix_fp = f"{prefix_fp}:{salted.rsplit(':', 1)[1]}"
    return CanonicalQuery(cquery, fp, prefix_fp, shareable,
                          agg_names, group_names)


def fingerprint(query: AggQuery) -> str:
    """Convenience: the stable identity alone."""
    return canonicalize(query).fingerprint


def prefix_fingerprint(query: AggQuery) -> str:
    """Convenience: the aggregate-blind scan/join-structure identity."""
    return canonicalize(query).prefix_fingerprint
