"""Planner statistics: per-table/per-column stats, cost model, feedback.

This module is the port's single home for every cardinality/selectivity
policy constant the planner and serving tier consult; their values are the
JAX package's (``repro.core.stats``), copied.  The shape
mirrors the decision cards in SNIPPETS.md: each rewrite/fusion decision is
a structural gate followed by a *calibration* against numbers kept here.

Three layers:

  * ``TableStats`` / ``ColumnStats`` — cheap per-relation summaries (live
    row counts, distinct estimates, min/max, FK orphan counts) computed
    once per table load/update on the host from each table's columns.
    Each carries the table's content ``token`` so a consumer can tell
    exactly which data version a decision was calibrated against.
  * ``StatsCatalog`` — the live registry the planner reads: selectivity
    estimation for declarative selection specs, a padded-shape cost model
    for fusion admission, and decision-dependency validation (a recorded
    decision is stale iff a table it consulted changed token).
  * serve-time feedback — EWMA solo vs. fused serve times per
    (fingerprint, fusion-group signature); a fusion that consistently
    regresses a member vs. its solo baseline is *demoted* and the grouper
    stops forming it.

Grounded in Memory-Efficient Group-by Aggregates over Multi-Way Joins
(PAPERS.md, 1906.05745): statistics sized by the *relations*, never the
join.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core.plan import (
    FinalAggOp,
    FreqJoinOp,
    MaterializeJoinOp,
    PhysicalPlan,
    ScanOp,
    SemiJoinOp,
)
from repro_torch.tables.table import Schema, Table

STATS_VERSION = 1

# ---------------------------------------------------------------------------
# Policy constants (the ONLY allowed home for these — see scripts/lint.py).
# ---------------------------------------------------------------------------

#: FK-join elimination only fires on a verified-clean FK edge: the child
#: must have zero orphan references or dropping the join changes answers.
FK_ELIM_MAX_ORPHANS = 0

#: Pre-filter pushdown wants a genuinely selective dimension…
PREFILTER_MAX_SELECTIVITY = 0.25
#: …feeding a parent big enough that shrinking the materialised
#: intermediate is worth an extra semi-join (tiny tables: overhead wins).
PREFILTER_MIN_PARENT_ROWS = 64

#: Fusion admission: a plan never joins a fusion group whose maximum
#: estimated (padded-shape) cost is ≥ this multiple of its own.
FUSION_COST_DISPARITY = 8.0

#: Feedback demotion: a fusion is demoted for a member once observed at
#: least this many times fused AND its fused EWMA serve time exceeds the
#: solo baseline by this factor.
DEMOTION_MIN_OBSERVATIONS = 2
DEMOTION_REGRESSION_FACTOR = 1.5

#: Smoothing for observed serve times (newest observation's weight).
SERVE_EWMA_ALPHA = 0.5


# ---------------------------------------------------------------------------
# Per-table statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Summary of one column over the *live* (freq > 0) rows."""

    distinct: int
    lo: float | None = None
    hi: float | None = None

    def to_payload(self) -> dict:
        return {"distinct": self.distinct, "lo": self.lo, "hi": self.hi}

    @classmethod
    def from_payload(cls, p: dict) -> "ColumnStats":
        return cls(distinct=int(p["distinct"]),
                   lo=p.get("lo"), hi=p.get("hi"))


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

    def to_payload(self) -> dict:
        return {
            "version": STATS_VERSION,
            "relation": self.relation,
            "rows": self.rows,
            "capacity": self.capacity,
            "token": self.token,
            "columns": {c: s.to_payload() for c, s in self.columns.items()},
            "fk_orphans": dict(self.fk_orphans),
        }

    @classmethod
    def from_payload(cls, p: dict) -> "TableStats":
        if p.get("version") != STATS_VERSION:
            raise ValueError(f"stats version {p.get('version')!r} != "
                             f"{STATS_VERSION}")
        return cls(
            relation=p["relation"], rows=int(p["rows"]),
            capacity=int(p["capacity"]), token=p["token"],
            columns={c: ColumnStats.from_payload(s)
                     for c, s in p["columns"].items()},
            fk_orphans={k: int(v) for k, v in p["fk_orphans"].items()},
        )


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


# ---------------------------------------------------------------------------
# Serve-time feedback
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FeedbackRecord:
    """EWMA serve times for one (fingerprint, fusion-group signature).

    ``signature == ""`` is the solo baseline for the fingerprint."""

    ewma_s: float = 0.0
    count: int = 0

    def observe(self, serve_s: float) -> None:
        if self.count == 0:
            self.ewma_s = serve_s
        else:
            a = SERVE_EWMA_ALPHA
            self.ewma_s = a * serve_s + (1.0 - a) * self.ewma_s
        self.count += 1

    def to_payload(self) -> dict:
        return {"ewma_s": self.ewma_s, "count": self.count}

    @classmethod
    def from_payload(cls, p: dict) -> "FeedbackRecord":
        return cls(ewma_s=float(p["ewma_s"]), count=int(p["count"]))


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------

class StatsCatalog:
    """Live statistics registry: tables, cost model, serve-time feedback.

    Thread-safe; every method takes the internal lock.  Table entries are
    installed either by :meth:`refresh` (a full compute — the caller's
    ``stat_refreshes`` counter should track these) or :meth:`install`
    (e.g. loaded from a warm :class:`~repro_torch.service.stats_store.StatsStore`
    after a token match — no compute, no refresh counted).
    """

    def __init__(self, schema: Schema):
        self.schema = schema
        self._tables: dict[str, TableStats] = {}
        self._feedback: dict[tuple[str, str], FeedbackRecord] = {}
        self._lock = threading.Lock()

    # -- table stats ------------------------------------------------------

    def refresh(self, name: str, table: Table,
                db: dict[str, Table]) -> TableStats:
        st = compute_table_stats(name, table, self.schema, db)
        with self._lock:
            self._tables[name] = st
        return st

    def install(self, stats: TableStats) -> None:
        with self._lock:
            self._tables[stats.relation] = stats

    def get(self, name: str) -> TableStats | None:
        with self._lock:
            return self._tables.get(name)

    def token(self, name: str) -> str | None:
        st = self.get(name)
        return st.token if st is not None else None

    def tables(self) -> dict[str, TableStats]:
        with self._lock:
            return dict(self._tables)

    # -- decision-dependency validation -----------------------------------

    def validate_depends(self, depends: dict[str, str]) -> bool:
        """True iff every (relation → token) a decision recorded still
        matches the catalog — i.e. the decision's inputs are current."""
        with self._lock:
            return all(
                (st := self._tables.get(rel)) is not None
                and st.token == tok
                for rel, tok in depends.items())

    # -- selectivity estimation -------------------------------------------

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

    # -- cost model --------------------------------------------------------

    def estimate_plan_cost(self, plan: PhysicalPlan,
                           rows: dict[str, int] | None = None) -> float:
        """Estimated work for one execution of ``plan``.

        The engine is static-shape: sweeps run over *padded* capacities
        regardless of live counts or selections, so the honest unit of
        work per node is the padded rows it touches.  Pass ``rows``
        mapping relation → padded bucket capacity for serve-time costs;
        falls back to catalog live row counts (planner-side estimates).
        """
        sizes: dict[int, float] = {}
        cost = 0.0
        for node in plan.root.postorder():
            op = node.op
            if isinstance(op, ScanOp):
                if rows is not None and op.rel in rows:
                    r = float(rows[op.rel])
                else:
                    st = self.get(op.rel)
                    r = float(st.rows) if st is not None else 1.0
                sizes[id(node)] = r
                cost += r
            elif isinstance(op, (SemiJoinOp, FreqJoinOp)):
                p = sizes[id(node.inputs[0])]
                c = sizes[id(node.inputs[1])]
                sizes[id(node)] = p       # sweeps keep the parent's shape
                cost += p + c
            elif isinstance(op, MaterializeJoinOp):
                p = sizes[id(node.inputs[0])]
                c = sizes[id(node.inputs[1])]
                sizes[id(node)] = p * max(c, 1.0) ** 0.5  # growth, damped
                cost += p + c + sizes[id(node)]
            elif isinstance(op, FinalAggOp):
                r = sizes[id(node.inputs[0])]
                sizes[id(node)] = r
                cost += r
        return cost

    # -- serve-time feedback ----------------------------------------------

    def observe_serve(self, fingerprint: str, signature: str,
                      serve_s: float) -> None:
        """Record an observed serve time.  ``signature`` is the fusion
        group signature the request ran under ("" = served solo)."""
        with self._lock:
            rec = self._feedback.setdefault((fingerprint, signature),
                                            FeedbackRecord())
            rec.observe(serve_s)

    def is_demoted(self, fingerprint: str, signature: str) -> bool:
        """True iff this fusion has been observed regressing this member
        vs. its solo baseline — the grouper must not re-form it."""
        with self._lock:
            fused = self._feedback.get((fingerprint, signature))
            solo = self._feedback.get((fingerprint, ""))
            if fused is None or solo is None or solo.count == 0:
                return False
            return (fused.count >= DEMOTION_MIN_OBSERVATIONS
                    and fused.ewma_s
                    > DEMOTION_REGRESSION_FACTOR * solo.ewma_s)

    def demotions(self) -> list[dict]:
        """Currently-demoted (fingerprint, signature) pairs with numbers."""
        with self._lock:
            keys = list(self._feedback)
        out = []
        for fp, sig in keys:
            if sig and self.is_demoted(fp, sig):
                with self._lock:
                    fused = self._feedback[(fp, sig)]
                    solo = self._feedback.get((fp, ""), FeedbackRecord())
                out.append({"fingerprint": fp, "signature": sig,
                            "fused_ewma_s": fused.ewma_s,
                            "solo_ewma_s": solo.ewma_s})
        return out

    def feedback_payload(self) -> dict:
        """JSON-able snapshot of the feedback table (for the store)."""
        with self._lock:
            return {
                "version": STATS_VERSION,
                "records": [
                    {"fingerprint": fp, "signature": sig,
                     **rec.to_payload()}
                    for (fp, sig), rec in sorted(self._feedback.items())
                ],
            }

    def load_feedback(self, payload: dict) -> int:
        """Install a persisted feedback snapshot; returns records loaded.
        Existing in-memory records win (they are newer)."""
        if payload.get("version") != STATS_VERSION:
            return 0
        n = 0
        with self._lock:
            for r in payload.get("records", ()):
                key = (r["fingerprint"], r["signature"])
                if key not in self._feedback:
                    self._feedback[key] = FeedbackRecord.from_payload(r)
                    n += 1
        return n

    def feedback_len(self) -> int:
        with self._lock:
            return len(self._feedback)


__all__ = [
    "ColumnStats",
    "TableStats",
    "FeedbackRecord",
    "StatsCatalog",
    "compute_table_stats",
    "FK_ELIM_MAX_ORPHANS",
    "PREFILTER_MAX_SELECTIVITY",
    "PREFILTER_MIN_PARENT_ROWS",
    "FUSION_COST_DISPARITY",
    "DEMOTION_MIN_OBSERVATIONS",
    "DEMOTION_REGRESSION_FACTOR",
    "SERVE_EWMA_ALPHA",
    "STATS_VERSION",
]
