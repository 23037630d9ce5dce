"""Serving tier: plan cache, shape-bucketed reuse of compiled plans, SQL
front door — the port of the JAX package's ``repro.service``.

Guarded aggregate plans are static-dataflow programs — plan and compile
once, serve many.  This package owns everything between "SQL arrives" and
"the compiled plan runs on the tables' device": query fingerprinting
(``fingerprint``), the multi-level plan cache (``plan_cache``), the
persistent cross-process plan store (``plan_store``), the concurrent
micro-batching engine (``engine``), the async cross-caller batch former
(``scheduler``), the persistent statistics store behind cost-calibrated
planning (``stats_store``), the persistent store of the kernel tuner's
winners (``tune_store``), and the tracing + metrics registry every request
reports into (``observability``).  The JAX compilation cache has no
counterpart here.
"""

from repro_torch.service.engine import (
    AdmissionError,
    QueryResult,
    QueryService,
    ServeStats,
    ServiceClosedError,
    TenantAdmissionError,
)
from repro_torch.service.fingerprint import (
    CanonicalQuery,
    canonicalize,
    fingerprint,
    prefix_fingerprint,
)
from repro_torch.service.observability import (
    DEFAULT_TENANT,
    Histogram,
    Observability,
    TraceSpan,
)
from repro_torch.service.plan_cache import LRUCache, PlanCache
from repro_torch.service.plan_store import (
    PlanStore,
    schema_fingerprint,
    store_fingerprint,
)
from repro_torch.service.scheduler import AsyncScheduler, TenantPolicy
from repro_torch.service.stats_store import StatsStore
from repro_torch.service.tune_store import TuneStore

__all__ = [
    "AdmissionError",
    "AsyncScheduler",
    "DEFAULT_TENANT",
    "CanonicalQuery",
    "canonicalize",
    "fingerprint",
    "prefix_fingerprint",
    "Histogram",
    "LRUCache",
    "Observability",
    "PlanCache",
    "TraceSpan",
    "PlanStore",
    "QueryResult",
    "QueryService",
    "ServeStats",
    "ServiceClosedError",
    "StatsStore",
    "TenantAdmissionError",
    "TenantPolicy",
    "TuneStore",
    "schema_fingerprint",
    "store_fingerprint",
]
