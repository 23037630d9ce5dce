"""Plan cache: fingerprint → plan, (fingerprint, bucket) → compiled
closure, and a level for fused multi-query closures.

Level 1 amortises the front half of the pipeline (GYO classification,
guard re-rooting, rule rewrites): one ``PhysicalPlan`` per query structure.
Level 2 holds one compiled closure (``Executor.compile``) per (structure,
shape bucket), keyed as the JAX package keys its compiled programs.
Buckets are tuples of ``(relation, padded_capacity)`` over the relations
the plan scans, with capacities rounded up to powers of two
(``bucket_capacity``) — so tables growing inside their bucket re-use the
compiled closure bit-for-bit.  Level 3 caches *fused* closures — one
``compile_multi`` closure answering several distinct fingerprints whose plan DAGs overlap on shared subplans — keyed
by (merged-graph signature, bucket), so a repeating dashboard workload
recompiles nothing.  The signature hashes the sorted member graph keys
(``PhysicalPlan.graph_key``), so any request order for the same query set
hits the same compiled closure.

A fourth, data-plane level caches the bucket-padded table *views*
(``Table.pad_to`` output) per relation, entries tagged with their source
table so a view is never served against swapped-in data: ``update_table``
calls ``drop_padded`` and the engine re-validates the tag on every read.
Padding is device work, so bounding this level (LRU) keeps a service that
has touched many relations from pinning every padded copy forever.

Below all the LRU levels sits an optional PERSISTENT level
(``repro_torch.service.plan_store.PlanStore``): a plan that misses the in-memory
``plans`` LRU is looked up on disk before being re-planned, and freshly
built plans are written back — so plan structures survive process
restarts.  The store is strictly a lower level: it never affects LRU
bookkeeping, its failures degrade to memory-only caching, and its
``persist_*`` counters ride along in ``metrics()``.

All levels are bounded LRU with hit/miss/eviction counters; ``metrics()``
flattens them into the dict the serving engine exposes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Hashable

ShapeBucket = tuple[tuple[str, int], ...]


class LRUCache:
    """Ordered-dict LRU with counters.  Single-threaded by design: the
    serving engine serialises cache access (JAX dispatch is where the
    concurrency lives, not the Python bookkeeping)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._d: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def get(self, key, default=None):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return default

    def peek(self, key, default=None):
        """Read without touching counters or LRU order — for callers that
        must validate the entry before deciding whether this was really a
        hit (see the serving engine's ``_get_or_build``)."""
        return self._d.get(key, default)

    def note_hit(self, key) -> None:
        """Record the hit a prior ``peek`` deferred: one counter bump and
        an LRU refresh."""
        self._d.move_to_end(key)
        self.hits += 1

    def put(self, key, value) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def get_or_create(self, key, factory: Callable[[], Any]):
        """Return (value, hit) — counting exactly one hit or miss."""
        if key in self._d:
            return self.get(key), True
        value = factory()
        self.misses += 1
        self.put(key, value)
        return value, False

    def items(self) -> list[tuple[Hashable, Any]]:
        """Snapshot of (key, value) pairs, LRU-oldest first — for cache
        export; no counters touched."""
        return list(self._d.items())

    def invalidate_if(self, pred: Callable[[Hashable], bool]) -> int:
        """Drop entries whose key matches; returns the count (not counted
        as evictions — these are correctness invalidations, not pressure)."""
        doomed = [k for k in self._d if pred(k)]
        for k in doomed:
            del self._d[k]
        return len(doomed)

    def invalidate_items(self,
                         pred: Callable[[Hashable, Any], bool]) -> int:
        """Like ``invalidate_if`` but the predicate sees the VALUE too —
        for invalidations keyed on entry content (e.g. a cached plan whose
        decision trace consulted statistics that have since changed)."""
        doomed = [k for k, v in self._d.items() if pred(k, v)]
        for k in doomed:
            del self._d[k]
        return len(doomed)

    def counters(self) -> dict[str, int]:
        return {"size": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


class PlanCache:
    """Four levels:

    * ``plans`` — fingerprint → PhysicalPlan;
    * ``execs`` — (fingerprint, topology, ShapeBucket) → single-query
      executable, where topology is ``(axis_names, shard_counts)`` for a
      mesh-lowered program and ``()`` locally;
    * ``fused`` — (merged-graph signature, topology, ShapeBucket) → fused
      multi-query executable.  The signature content-addresses the whole
      member set (sorted graph keys), so it is order-invariant and safe
      across structurally-identical query sets;
    * ``padded`` — relation name → (source Table, bucket-padded view).
      The source-table tag is the consistency check: readers compare it
      against their own database snapshot and ignore (then overwrite)
      entries padded from data that has since been swapped out.

    Plus the optional persistent level under ``plans``: ``store`` (a
    ``PlanStore`` or None), consulted via ``load_persistent`` /
    ``save_persistent`` when the in-memory level misses.
    """

    def __init__(self, plan_capacity: int = 256, exec_capacity: int = 512,
                 fused_capacity: int = 128, padded_capacity: int = 64,
                 store=None):
        self.plans = LRUCache(plan_capacity)
        self.execs = LRUCache(exec_capacity)
        self.fused = LRUCache(fused_capacity)
        self.padded = LRUCache(padded_capacity)
        self.store = store

    def load_persistent(self, fingerprint: str):
        """Disk-level plan lookup (None without a store / on any miss).
        Corrupt entries are skipped and evicted by the store itself."""
        if self.store is None:
            return None
        return self.store.load(fingerprint)

    def save_persistent(self, fingerprint: str, plan) -> bool:
        """Best-effort disk write-back of a freshly built plan."""
        if self.store is None:
            return False
        return self.store.save(fingerprint, plan)

    # single source of the executable-cache key shapes: the serving engine
    # accesses the LRUs directly (to keep builds outside its lock) but
    # builds its keys here, and ``invalidate_relation`` relies on the
    # bucket sitting last.  ``topo`` is the shard topology the executable
    # was lowered for — ``(axis_names, shard_counts)`` on a mesh service,
    # ``()`` on a single device: the same fingerprint served at the same
    # bucket compiles to a DIFFERENT program per mesh shape (ring length,
    # collective layout), so topologies must occupy distinct entries.
    @staticmethod
    def exec_key(fingerprint: str, bucket: ShapeBucket,
                 topo: tuple = ()) -> tuple:
        return (fingerprint, topo, bucket)

    @staticmethod
    def fused_key(signature: str, bucket: ShapeBucket,
                  topo: tuple = ()) -> tuple:
        return (signature, topo, bucket)

    def get_executable(self, fingerprint: str, bucket: ShapeBucket,
                       factory: Callable[[], Callable],
                       topo: tuple = ()) -> tuple[Callable, bool]:
        return self.execs.get_or_create(
            self.exec_key(fingerprint, bucket, topo), factory)

    def invalidate_relation(self, rel: str) -> int:
        """Drop executables whose bucket pins `rel` to a now-stale capacity.
        Called when a table's data outgrows its bucket; plans (shape-free)
        survive.  Both key builders above place the bucket last."""
        def stale(key) -> bool:
            bucket = key[-1]
            return any(r == rel for r, _ in bucket)

        return (self.execs.invalidate_if(stale)
                + self.fused.invalidate_if(stale))

    def drop_padded(self, rel: str) -> None:
        """Forget the padded view for `rel` (its source table was swapped).
        Not an eviction: the entry is simply stale."""
        self.padded.invalidate_if(lambda k: k == rel)

    def describe(self, fingerprint: str, bucket: ShapeBucket | None = None,
                 signature: str | None = None,
                 topo: tuple = ()) -> dict[str, bool]:
        """Hit-level attribution for one fingerprint — which cache levels
        could answer it RIGHT NOW.  Counter-free and LRU-order-free
        (``peek`` semantics): this is an inspection surface for
        ``QueryService.explain``, not a lookup."""
        out = {
            "plan_in_memory": fingerprint in self.plans,
            "plan_on_disk": (self.store.has(fingerprint)
                             if self.store is not None else False),
        }
        if bucket is not None:
            out["exec_in_memory"] = \
                self.exec_key(fingerprint, bucket, topo) in self.execs
            if signature is not None:
                out["fused_in_memory"] = \
                    self.fused_key(signature, bucket, topo) in self.fused
        return out

    def metrics(self) -> dict[str, int]:
        """The LRU levels' counters.  The persistent level reports via
        ``persist_metrics()`` — kept separate because it touches the disk
        (entry count) and synchronises on the store's own lock, so callers
        holding a hot-path lock (the serving engine) can collect it
        outside."""
        out = {}
        for level, cache in (("plan", self.plans), ("exec", self.execs),
                             ("fused", self.fused), ("padded", self.padded)):
            for k, v in cache.counters().items():
                out[f"{level}_{k}"] = v
        return out

    def persist_metrics(self) -> dict[str, int]:
        from repro_torch.service.plan_store import PERSIST_ZEROS

        return (self.store.metrics() if self.store is not None
                else dict(PERSIST_ZEROS))
