"""Planner statistics: per-table/per-column stats and the thresholds the
stats-gated rewrite passes read.

  * ``TableStats`` / ``ColumnStats`` — cheap per-relation summaries (live
    row counts, distinct counts, min/max, FK orphan counts) computed on the
    host from each table's columns.  Each carries the table's content
    ``token`` so a consumer can tell which data version a decision was
    calibrated against.
  * ``StatsCatalog`` — the registry the planner reads: table stats and
    selectivity estimates for declarative selection specs.

Decision-dependency validation, the cost model and serve-time feedback
arrive with the serving tier in a later slice.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.tables.table import Schema, Table

#: FK-join elimination only fires on a verified-clean FK edge: the child
#: must have zero orphan references or dropping the join changes answers.
FK_ELIM_MAX_ORPHANS = 0

#: Pre-filter pushdown wants a genuinely selective dimension…
PREFILTER_MAX_SELECTIVITY = 0.25
#: …feeding a parent big enough that shrinking the materialised
#: intermediate is worth an extra semi-join (tiny tables: overhead wins).
PREFILTER_MIN_PARENT_ROWS = 64


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Summary of one column over the *live* (freq > 0) rows."""

    distinct: int
    lo: float | None = None
    hi: float | None = None


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Summary of one relation at one data version (``token``)."""

    relation: str
    rows: int                  # live tuples (freq > 0)
    capacity: int              # padded physical capacity
    token: str                 # Table.content_token() of the data version
    columns: dict[str, ColumnStats]
    #: orphan reference counts per declared outgoing FK, keyed
    #: "src_col->dst.dst_col" — 0 means every live src value has a live
    #: unique partner in dst (the soundness condition for FK-join
    #: elimination; referential integrity is measured, never assumed).
    fk_orphans: dict[str, int]


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def compute_table_stats(name: str, table: Table, schema: Schema,
                        db: dict[str, Table]) -> TableStats:
    """One full pass over a table's live rows on the host: O(rows)."""
    live = _host(table.freq) > 0
    rows = int(live.sum())
    columns: dict[str, ColumnStats] = {}
    for col in table.column_names:
        vals = _host(table.columns[col])[live]
        if vals.size == 0:
            columns[col] = ColumnStats(distinct=0)
            continue
        distinct = int(np.unique(vals).size)
        lo = hi = None
        if np.issubdtype(vals.dtype, np.number):
            lo, hi = float(vals.min()), float(vals.max())
        columns[col] = ColumnStats(distinct=distinct, lo=lo, hi=hi)

    fk_orphans: dict[str, int] = {}
    for fk in schema.foreign_keys:
        if fk.src != name or fk.dst not in db:
            continue
        dst = db[fk.dst]
        src_vals = _host(table.columns[fk.src_col])[live]
        dst_vals = _host(dst.columns[fk.dst_col])[_host(dst.freq) > 0]
        orphans = int((~np.isin(src_vals, dst_vals)).sum())
        fk_orphans[f"{fk.src_col}->{fk.dst}.{fk.dst_col}"] = orphans

    return TableStats(relation=name, rows=rows, capacity=table.capacity,
                      token=table.content_token(), columns=columns,
                      fk_orphans=fk_orphans)


class StatsCatalog:
    """Live statistics registry.  Thread-safe; every method takes the
    internal lock."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._tables: dict[str, TableStats] = {}
        self._lock = threading.Lock()

    def refresh(self, name: str, table: Table,
                db: dict[str, Table]) -> TableStats:
        st = compute_table_stats(name, table, self.schema, db)
        with self._lock:
            self._tables[name] = st
        return st

    def get(self, name: str) -> TableStats | None:
        with self._lock:
            return self._tables.get(name)

    def token(self, name: str) -> str | None:
        st = self.get(name)
        return st.token if st is not None else None

    def estimate_selectivity(self, rel: str, spec) -> float | None:
        """Estimated live-row fraction passing a declarative selection
        spec (AND-ed ``(op, col, literal)`` terms).  ``None`` when the
        relation has no stats — callers must treat that as "gate fails",
        never as "assume selective"."""
        st = self.get(rel)
        if st is None or spec is None:
            return None
        frac = 1.0
        for op, col, val in spec:
            cs = st.columns.get(col)
            if cs is None or cs.distinct <= 0:
                return None
            if op == "=":
                f = 1.0 / cs.distinct
            elif op == "in":
                f = min(len(tuple(val)) / cs.distinct, 1.0)
            elif op == "!=":
                f = 1.0 - 1.0 / cs.distinct
            elif op in ("<", ">", "<=", ">="):
                if cs.lo is None or cs.hi is None or cs.hi <= cs.lo:
                    f = 0.5
                else:
                    span = cs.hi - cs.lo
                    if op in ("<", "<="):
                        f = (float(val) - cs.lo) / span
                    else:
                        f = (cs.hi - float(val)) / span
            else:
                return None
            frac *= min(max(f, 0.0), 1.0)
        return frac


__all__ = [
    "ColumnStats",
    "TableStats",
    "StatsCatalog",
    "compute_table_stats",
    "FK_ELIM_MAX_ORPHANS",
    "PREFILTER_MAX_SELECTIVITY",
    "PREFILTER_MIN_PARENT_ROWS",
]
