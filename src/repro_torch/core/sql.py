"""A small SQL front-end for the guarded-aggregate engine.

Parses the fragment the paper targets — SELECT <aggs> FROM <tables>
WHERE <equi-joins ∧ local predicates> [GROUP BY <cols>] — into an
``AggQuery``, so the engine plugs into systems that speak SQL (the paper's
point: these optimisations belong in ordinary RDBMS planners).

Supported grammar (case-insensitive keywords):

    SELECT  agg(col) [AS name] [, ...] | agg(*) | DISTINCT inside agg
    FROM    rel [alias] [, ...]
    WHERE   a.col = b.col            -- equi-join (any number, AND-ed)
          | a.col <op> <literal>     -- local selection (=, <, >, <=, >=, !=)
          | a.col IN (v1, v2, ...)
    GROUP BY a.col [, ...]

Example (the paper's Fig. 1):

    SELECT MIN(s.s_acctbal), MAX(s.s_acctbal)
    FROM region r, nation n, supplier s, partsupp ps, part p
    WHERE r.r_regionkey = n.n_regionkey AND n.n_nationkey = s.s_nationkey
      AND s.s_suppkey = ps.ps_suppkey AND ps.ps_partkey = p.p_partkey
      AND r.r_name IN (2, 3) AND p.p_price > 1200.0
"""

from __future__ import annotations

import re

from repro_torch.core.query import Agg, AggQuery, Atom, selection_from_spec
from repro_torch.tables.table import Schema

_AGG_RE = re.compile(
    r"(count|sum|avg|min|max|median)\s*\(\s*(distinct\s+)?"
    r"(\*|[a-z_][\w.]*)\s*\)(?:\s+as\s+(\w+))?", re.I)
_JOIN_RE = re.compile(r"^(\w+)\.(\w+)\s*=\s*(\w+)\.(\w+)$")
_SEL_RE = re.compile(r"^(\w+)\.(\w+)\s*(=|!=|<=|>=|<|>)\s*([-\w.']+)$")
_IN_RE = re.compile(r"^(\w+)\.(\w+)\s+in\s*\(([^)]*)\)$", re.I)


class SqlError(ValueError):
    pass


def _split_top(s: str, sep: str) -> list[str]:
    """Split on `sep` at parenthesis depth 0."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if depth == 0 and ch == sep:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur).strip())
    return [x for x in out if x]


def _literal(tok: str):
    tok = tok.strip().strip("'")
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok


def parse_sql(sql: str, schema: Schema) -> AggQuery:
    """Parse the supported fragment into an AggQuery (natural-join form:
    equi-joined columns are renamed to shared variables)."""
    s = re.sub(r"\s+", " ", sql.strip().rstrip(";"))
    m = re.match(r"select (.*?) from (.*?)(?: where (.*?))?"
                 r"(?: group by (.*?))?$", s, re.I)
    if not m:
        raise SqlError(f"unparsable query: {sql!r}")
    sel_s, from_s, where_s, group_s = m.groups()

    # FROM: aliases
    alias2rel: dict[str, str] = {}
    for part in _split_top(from_s, ","):
        toks = part.split()
        if len(toks) == 1:
            alias2rel[toks[0]] = toks[0]
        elif len(toks) == 2:
            alias2rel[toks[1]] = toks[0]
        else:
            raise SqlError(f"bad FROM item: {part!r}")
    for rel in alias2rel.values():
        if rel not in schema.relations:
            raise SqlError(f"unknown relation {rel!r}")

    # variable names: start as alias.col, merged by equi-joins (union-find)
    var: dict[tuple[str, str], str] = {}
    parent: dict[str, str] = {}

    def find(x: str) -> str:
        while parent.get(x, x) != x:
            x = parent[x]
        return x

    def union(a: str, b: str):
        parent[find(a)] = find(b)

    def var_of(alias: str, col: str) -> str:
        if alias not in alias2rel:
            raise SqlError(f"unknown alias {alias!r}")
        if col not in schema.relations[alias2rel[alias]].column_names():
            raise SqlError(f"unknown column {alias}.{col}")
        return var.setdefault((alias, col), f"{alias}.{col}")

    selections: dict[str, list] = {}
    if where_s:
        for cond in re.split(r"\s+and\s+", where_s, flags=re.I):
            cond = cond.strip()
            if (jm := _JOIN_RE.match(cond)):
                a, ca, b, cb = jm.groups()
                union(var_of(a, ca), var_of(b, cb))
            elif (im := _IN_RE.match(cond)):
                a, col, vals = im.groups()
                values = tuple(_literal(v) for v in vals.split(","))
                var_of(a, col)
                selections.setdefault(a, []).append(
                    ("in", col, values))
            elif (sm := _SEL_RE.match(cond)):
                a, col, op, lit = sm.groups()
                if (lm := re.match(r"^(\w+)\.(\w+)$", lit)) \
                        and lm.group(1) in alias2rel:
                    raise SqlError(
                        f"non-equi join term {cond!r}: only equi-joins "
                        "between relations are supported (θ-joins fall "
                        "outside the paper's fragment)")
                var_of(a, col)
                selections.setdefault(a, []).append(
                    (op, col, _literal(lit)))
            else:
                raise SqlError(f"unsupported WHERE term: {cond!r}")

    # atoms with canonical (union-find root) variable names
    atoms = []
    for alias, rel in alias2rel.items():
        vars_ = tuple(
            find(var.get((alias, c), f"{alias}.{c}"))
            for c in schema.relations[rel].column_names())
        atoms.append(Atom(rel, alias, vars_))

    # selections → predicate closures over schema column names, plus the
    # declarative specs the serving tier fingerprints (see query.py)
    sel_fns = {}
    sel_specs = {}
    for alias, conds in selections.items():
        sel_specs[alias] = tuple(conds)
        sel_fns[alias] = selection_from_spec(conds)

    # aggregates
    aggs = []
    for am in _AGG_RE.finditer(sel_s):
        func, distinct, arg, name = am.groups()
        if arg == "*":
            v = None
        else:
            if "." not in arg:
                raise SqlError(f"qualify the column: {arg!r}")
            a, c = arg.split(".", 1)
            v = find(var_of(a, c))
        aggs.append(Agg(func.lower(), v, distinct=bool(distinct),
                        name=(name or "").strip() or
                        f"{func.lower()}({'distinct ' if distinct else ''}"
                        f"{arg})"))
    if not aggs:
        raise SqlError("no aggregate in SELECT (the engine targets "
                       "aggregate queries)")

    group_by = ()
    if group_s:
        gs = []
        for g in group_s.split(","):
            a, c = g.strip().split(".", 1)
            gs.append(find(var_of(a, c)))
        group_by = tuple(gs)

    return AggQuery(atoms=tuple(atoms), aggregates=tuple(aggs),
                    group_by=group_by, selections=sel_fns,
                    selection_specs=sel_specs)
