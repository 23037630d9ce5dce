"""Query IR: aggregate queries over acyclic conjunctive queries.

A query is (paper Eq. 1):

    Q = γ_{g1..gk, A1(a1)..Am(am)} ( π_U ( R1 ⋈ ... ⋈ Rn ) )

We represent the join part datalog-style: each ``Atom`` names a schema
relation and binds every column positionally to a query variable; atoms
sharing a variable are natural-joined on it (the paper's post-renaming
normal form).  Arbitrary single-relation selections attach to atoms as
callables over the column dict — matching the paper's "local selections may
be arbitrary" generalisation (§3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

AGG_FUNCS = ("count", "sum", "avg", "min", "max", "median")
SET_SAFE_FUNCS = ("min", "max")


def selection_from_spec(spec) -> Callable:
    """Compile a declarative selection spec — a tuple of ``(op, column,
    literal)`` terms, AND-ed, with ``op="in"`` holding a tuple of literals —
    into the torch predicate closure the executor applies at scan time.

    This is the single builder shared by the SQL front-end (which derives
    specs from WHERE terms) and plan deserialisation (which must rebuild
    the *same* callable from a persisted spec so a reloaded plan selects
    bitwise-identically to the plan that was stored)."""
    terms = tuple((op, col, tuple(val) if op == "in" else val)
                  for op, col, val in spec)

    def pred(cols):
        mask = None
        for op, col, val in terms:
            c = cols[col]
            if op == "in":
                m_ = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
                for v in val:
                    m_ = m_ | (c == v)
            else:
                m_ = {"=": c == val, "!=": c != val,
                      "<": c < val, ">": c > val,
                      "<=": c <= val, ">=": c >= val}[op]
            mask = m_ if mask is None else (mask & m_)
        return mask

    return pred


@dataclasses.dataclass(frozen=True)
class Atom:
    """One occurrence of a relation in the join; ``vars`` binds columns
    positionally (len(vars) == len(schema columns))."""

    rel: str
    alias: str
    vars: tuple[str, ...]

    def var_of(self, col_idx: int) -> str:
        return self.vars[col_idx]


@dataclasses.dataclass(frozen=True)
class Agg:
    """One aggregate expression A(a). ``var=None`` means COUNT(*)."""

    func: str
    var: str | None = None
    distinct: bool = False
    name: str = ""

    def __post_init__(self):
        if self.func not in AGG_FUNCS:
            raise ValueError(f"unknown aggregate {self.func}")
        if self.func == "count" and self.var is None and self.distinct:
            raise ValueError("COUNT(DISTINCT *) is not a thing")
        if self.func != "count" and self.var is None:
            raise ValueError(f"{self.func} needs an argument variable")
        if not self.name:
            d = "distinct " if self.distinct else ""
            object.__setattr__(
                self, "name", f"{self.func}({d}{self.var or '*'})")


@dataclasses.dataclass(frozen=True, eq=False)
class AggQuery:
    """γ over an ACQ. ``selections[alias]`` is σ applied at scan time.

    ``selection_specs[alias]`` optionally carries the *declarative* form of
    the same predicates — a tuple of ``(op, column, literal)`` terms (with
    ``op="in"`` holding a tuple of literals) — so the serving tier can
    fingerprint queries structurally.  Queries whose selections exist only
    as opaque callables are still executable but never share a plan-cache
    entry (the fingerprinter cannot prove them equivalent).
    """

    atoms: tuple[Atom, ...]
    aggregates: tuple[Agg, ...]
    group_by: tuple[str, ...] = ()
    selections: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    selection_specs: Mapping[str, tuple] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        aliases = [a.alias for a in self.atoms]
        if len(set(aliases)) != len(aliases):
            raise ValueError("atom aliases must be unique")
        for alias in self.selections:
            if alias not in aliases:
                raise ValueError(f"selection on unknown alias {alias}")
        for alias in self.selection_specs:
            if alias not in self.selections:
                raise ValueError(
                    f"selection_specs for {alias!r} without a matching "
                    "selection callable")

    def atom(self, alias: str) -> Atom:
        for a in self.atoms:
            if a.alias == alias:
                return a
        raise KeyError(alias)

    def output_vars(self) -> tuple[str, ...]:
        """Grouping vars + every var referenced by an aggregate."""
        out = list(self.group_by)
        for ag in self.aggregates:
            if ag.var is not None and ag.var not in out:
                out.append(ag.var)
        return tuple(out)

    def all_vars(self) -> tuple[str, ...]:
        seen: list[str] = []
        for a in self.atoms:
            for v in a.vars:
                if v not in seen:
                    seen.append(v)
        return tuple(seen)
