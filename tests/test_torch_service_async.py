"""The port's async serving tier: per-request futures, cross-caller batch
formation, backpressure, drain-on-close, tenant admission (token-bucket
quotas, per-tenant queue bounds, priority lanes and deficit-round-robin
batch formation), the span lifecycle on every scheduler exit path, and the
threaded stress tests — the JAX package's ``tests/test_async_scheduler.py``
and ``tests/test_multitenant.py`` run against ``repro_torch.service`` on
CPU tables, with the same injectable fake clock.  Cross-caller batches
are also held against the JAX package's ``QueryService`` answering the
same statements serially.
"""

import threading
import time
from collections import Counter

import jax
import numpy as np
import pytest

import repro.data.relational as jrel
import repro.service as jsvc
from repro_torch.data import make_tpch_db
from repro_torch.service import (
    AdmissionError,
    QueryService,
    ServiceClosedError,
    TenantAdmissionError,
    TenantPolicy,
)
from repro_torch.service.observability import Observability
from repro_torch.service.scheduler import (
    _drr_claim,
    _Pending,
    _TenantState,
    _TokenBucket,
)
from repro_torch.tables.table import Table, bucket_capacity, db_from_numpy

jax.config.update("jax_platform_name", "cpu")

FIG1 = """
SELECT MIN(s.s_acctbal), MAX(s.s_acctbal)
FROM region r, nation n, supplier s, partsupp ps, part p
WHERE r.r_regionkey = n.n_regionkey AND n.n_nationkey = s.s_nationkey
  AND s.s_suppkey = ps.ps_suppkey AND ps.ps_partkey = p.p_partkey
  AND r.r_name IN (2, 3) AND p.p_price > 1200.0
"""
_SUPP_DIMS = """FROM supplier s, nation n, region r
WHERE s.s_nationkey = n.n_nationkey AND n.n_regionkey = r.r_regionkey
  AND r.r_name IN (2, 3)"""
_PART_DIMS = """FROM partsupp ps, part p
WHERE ps.ps_partkey = p.p_partkey AND p.p_price > 1500.0"""
# the benchmark's dashboard: two subplan-overlap fusion sets
# ({supplier-dims family ∪ FIG1}, {partsupp-dims family})
DASHBOARD = [
    f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {_SUPP_DIMS}",
    f"SELECT SUM(s.s_acctbal) {_SUPP_DIMS}",
    f"SELECT COUNT(*) AS n, AVG(s.s_acctbal) AS avg {_SUPP_DIMS} "
    "GROUP BY s.s_nationkey",
    f"SELECT MEDIAN(s.s_acctbal) {_SUPP_DIMS}",
    f"SELECT SUM(ps.ps_supplycost), COUNT(*) {_PART_DIMS}",
    f"SELECT AVG(ps.ps_supplycost) AS avg_cost {_PART_DIMS} "
    "GROUP BY ps.ps_suppkey",
    FIG1,
]
# duplication-invariant queries (MIN/MAX only) for the stress test: the
# updater grows tables by RESAMPLING existing rows, which never changes a
# MIN/MAX answer — so every interleaving must match the serial baseline
MINMAX_QUERIES = [
    FIG1,
    f"SELECT MIN(s.s_acctbal) {_SUPP_DIMS}",
    """SELECT MIN(s.s_acctbal), MAX(s.s_acctbal)
FROM supplier s, nation n, region r, partsupp ps
WHERE s.s_nationkey = n.n_nationkey AND n.n_regionkey = r.r_regionkey
  AND s.s_suppkey = ps.ps_suppkey AND r.r_name IN (2, 3)""",
]


def _assert_values_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k, va in a.items():
        vb = b[k]
        if k == "groups":
            assert set(va) == set(vb)
            for c in va:
                np.testing.assert_array_equal(np.asarray(va[c]),
                                              np.asarray(vb[c]))
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_async_single_caller_roundtrip():
    db, schema = make_tpch_db(scale=30, seed=3, device="cpu")
    svc = QueryService(db, schema)
    try:
        fut = svc.submit_async(FIG1)
        res = fut.result(60)
        assert res.error is None
        _assert_values_equal(res.values, svc.submit(FIG1).values)
        m = svc.metrics()
        assert m["async_requests"] == 1
        assert m["async_batches"] >= 1
        assert m["queue_depth_peak"] >= 1
        assert m["rejected"] == 0
    finally:
        svc.close()


def test_async_cross_caller_batch_formation():
    """N independent callers each submitting ONE query land in one
    batching window and fuse like a single submit_many: fewer compiles
    than requests/fingerprints, answers bitwise-identical to serial."""
    db, schema = make_tpch_db(scale=30, seed=4, device="cpu")
    threads_n = 8
    work = [DASHBOARD[i % len(DASHBOARD)] for i in range(threads_n)]

    serial_svc = QueryService(db, schema)
    serial = [serial_svc.submit(sql) for sql in work]

    svc = QueryService(db, schema, async_max_wait_ms=500,
                       async_max_batch=64)
    try:
        barrier = threading.Barrier(threads_n)
        futs: list = [None] * threads_n

        def caller(i):
            barrier.wait()
            futs[i] = svc.submit_async(work[i])

        workers = [threading.Thread(target=caller, args=(i,))
                   for i in range(threads_n)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        results = [f.result(120) for f in futs]
        for got, want in zip(results, serial):
            assert got.error is None
            _assert_values_equal(got.values, want.values)
        m = svc.metrics()
        assert m["async_requests"] == threads_n
        assert m["async_batches"] >= 1
        distinct = len(set(work))
        assert m["fused_compiles"] < distinct
        assert m["compiles"] < threads_n
        # cross-caller fusion happened — all but FIG1, whose heavy
        # 5-relation plan the fusion cost gate bands away from the cheap
        # supplier-dims family (it serves solo by design)
        assert m["fused_queries"] >= distinct - 1
        assert m["fusion_cost_rejects"] >= 1
    finally:
        svc.close()


def test_async_bad_batchmate_isolated():
    """A malformed query in the same batching window fails only its own
    future; co-batched valid requests still get answers."""
    db, schema = make_tpch_db(scale=30, seed=5, device="cpu")
    svc = QueryService(db, schema, async_max_wait_ms=500,
                       async_max_batch=64)
    try:
        before = svc.metrics()["async_batches"]
        good1 = svc.submit_async(FIG1)
        bad = svc.submit_async("SELECT MIN(x.nope) FROM nowhere x")
        good2 = svc.submit_async(DASHBOARD[1])
        r1, r2 = good1.result(120), good2.result(120)
        assert r1.error is None and r1.values
        assert r2.error is None and r2.values
        with pytest.raises(Exception, match="nowhere"):
            bad.result(120)
        m = svc.metrics()
        # one window → one batch: the bad request really was co-batched
        assert m["async_batches"] - before == 1
        assert m["request_errors"] >= 1
    finally:
        svc.close()


def test_async_backpressure_rejects_on_full_queue():
    db, schema = make_tpch_db(scale=20, seed=6, device="cpu")
    svc = QueryService(db, schema, async_max_queue=2, async_max_wait_ms=1)
    entered, release = threading.Event(), threading.Event()
    orig = svc.submit_many

    def blocking(queries):
        entered.set()
        assert release.wait(60), "test orchestration stalled"
        return orig(queries)

    svc.submit_many = blocking
    try:
        inflight = svc.submit_async(FIG1)
        assert entered.wait(60)          # batcher holds the first request
        queued = [svc.submit_async(FIG1) for _ in range(2)]
        with pytest.raises(AdmissionError, match="queue full"):
            svc.submit_async(FIG1)
        assert svc.metrics()["rejected"] == 1
        assert svc.metrics()["queue_depth_peak"] == 2
        release.set()
        assert inflight.result(120).error is None
        for f in queued:
            assert f.result(120).error is None
    finally:
        release.set()
        svc.close()


def test_async_close_drains_pending_requests():
    db, schema = make_tpch_db(scale=20, seed=7, device="cpu")
    # a window far longer than the test: only close() can flush it
    svc = QueryService(db, schema, async_max_wait_ms=60_000)
    futs = [svc.submit_async(q) for q in (FIG1, DASHBOARD[1])]
    svc.close(timeout=120)
    for f in futs:
        assert f.result(1).error is None
    # typed close-time rejection: an AdmissionError subclass (so retry
    # loops written against backpressure survive shutdown) that is ALSO
    # a RuntimeError (the pre-typed contract), counted apart from
    # backpressure rejections
    with pytest.raises(ServiceClosedError, match="closed"):
        svc.submit_async(FIG1)
    with pytest.raises(AdmissionError):
        svc.submit_async(FIG1)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_async(FIG1)
    m = svc.metrics()
    assert m["rejected_closed"] == 3
    assert m["rejected"] == 0
    # sync serving still works after close
    assert svc.submit(FIG1).values


def test_dropped_service_is_collectable_without_close():
    """Regression: the batcher thread holds the service only weakly (plus
    a pin while requests are pending), so a dropped QueryService — tables,
    caches, executables and all — is garbage-collected and its batcher
    thread exits even when close() was never called."""
    import gc
    import weakref

    db, schema = make_tpch_db(scale=20, seed=9, device="cpu")
    svc = QueryService(db, schema)
    assert svc.submit_async(FIG1).result(120).error is None
    thread = svc._scheduler._thread
    ref = weakref.ref(svc)
    del svc
    deadline = time.monotonic() + 10
    while ref() is not None and time.monotonic() < deadline:
        gc.collect()                # the batcher unpins just after serving
        time.sleep(0.05)
    assert ref() is None, "idle QueryService still pinned by its batcher"
    thread.join(5)                  # heartbeat notices the dead weakref
    assert not thread.is_alive()


def _grow_cross_bucket(tab: Table, seed: int) -> Table:
    """Resampled-row copy of `tab` grown one row past its shape bucket.
    Resampling keeps every MIN/MAX answer identical."""
    cap = tab.capacity
    extra = bucket_capacity(cap) + 1 - cap
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cap, extra)
    cols = {name: np.concatenate([np.asarray(col), np.asarray(col)[idx]])
            for name, col in tab.columns.items()}
    return Table.from_numpy(cols, device="cpu")


def test_stress_submissions_race_bucket_crossing_updates():
    """Threaded submit/submit_async interleaved with bucket-crossing
    update_table calls: every answer must equal the serial baseline
    bitwise, and no (cache key, bucket) may compile twice — the only
    tolerated rebuilds are invalidated stale-bucket keys."""
    db, schema = make_tpch_db(scale=40, seed=8, device="cpu")
    serial_svc = QueryService(db, schema)
    baseline = {sql: serial_svc.submit(sql).values for sql in MINMAX_QUERIES}

    svc = QueryService(db, schema, async_max_wait_ms=5)
    grow_rels = ("supplier", "partsupp")
    old_buckets = {(rel, bucket_capacity(db[rel].capacity))
                   for rel in grow_rels}

    built: list = []
    orig_gob = svc._get_or_build

    def spy(cache, key, build, **kwargs):
        def counted():
            if cache is not svc.cache.padded:
                # padded views legitimately re-pad after a table swap;
                # the no-duplicate claim is about plans and compiles
                built.append((id(cache), key))
            return build()
        return orig_gob(cache, key, counted, **kwargs)

    svc._get_or_build = spy

    errors: list = []
    mismatches: list = []

    def check(sql, res):
        try:
            _assert_values_equal(res.values, baseline[sql])
        except AssertionError as e:
            mismatches.append((sql, str(e)))

    def sync_worker(offset):
        try:
            for i in range(6):
                sql = MINMAX_QUERIES[(offset + i) % len(MINMAX_QUERIES)]
                check(sql, svc.submit(sql))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def async_worker(offset):
        try:
            for i in range(4):
                sql = MINMAX_QUERIES[(offset + i) % len(MINMAX_QUERIES)]
                check(sql, svc.submit_async(sql).result(120))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def updater():
        try:
            # wait for the first compiled executable so the bucket
            # crossing demonstrably invalidates cached programs, then
            # race the remaining submissions
            deadline = time.monotonic() + 60
            while (svc.metrics()["compiles"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            for j, rel in enumerate(grow_rels):
                svc.update_table(rel, _grow_cross_bucket(db[rel], seed=j))
                time.sleep(0.05)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    workers = ([threading.Thread(target=sync_worker, args=(i,))
                for i in range(4)]
               + [threading.Thread(target=async_worker, args=(i,))
                  for i in range(2)]
               + [threading.Thread(target=updater)])
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    svc.close()

    assert not errors, errors
    assert not mismatches, mismatches[:3]
    m = svc.metrics()
    assert m["request_errors"] == 0
    assert m["bucket_invalidations"] >= 1   # the updates really crossed

    # compile hygiene: duplicates are legal only for keys invalidated by
    # the bucket crossings (a request that snapshotted just before the
    # update rebuilds the stale key once); every live (key, bucket) pair
    # compiled at most once
    dupes = [key for key, n in Counter(built).items() if n > 1]
    for _, key in dupes:
        assert isinstance(key, tuple), f"plan rebuilt: {key!r}"
        bucket = key[-1]
        assert any((rel, cap) in old_buckets for rel, cap in bucket), \
            f"duplicate compile for non-invalidated key {key!r}"


MINMAX = f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {_SUPP_DIMS}"
TOTAL = f"SELECT SUM(s.s_acctbal) {_SUPP_DIMS}"


@pytest.fixture(scope="module")
def tpch():
    return make_tpch_db(scale=20, seed=11, device="cpu")


class _Tick:
    """Manually-advanced clock for quota-refill tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# token bucket (unit)
# ---------------------------------------------------------------------------
def test_token_bucket_burst_refill_and_cap():
    tick = _Tick()
    b = _TokenBucket(rate=2.0, burst=4.0, clock=tick)
    # a fresh bucket admits its full burst, then rejects
    assert [b.try_take() for _ in range(5)] == [True] * 4 + [False]
    # 1 s at 2/s refills exactly two tokens
    tick.t += 1.0
    assert b.try_take() and b.try_take() and not b.try_take()
    # refill caps at burst no matter how long the tenant idles
    tick.t += 1e6
    assert [b.try_take() for _ in range(5)] == [True] * 4 + [False]


def test_tenant_policy_validation():
    with pytest.raises(ValueError, match="rate"):
        TenantPolicy(rate=0.0)
    with pytest.raises(ValueError, match="weight"):
        TenantPolicy(weight=0.0)
    with pytest.raises(ValueError, match="max_queue"):
        TenantPolicy(max_queue=0)


# ---------------------------------------------------------------------------
# deficit round-robin (unit)
# ---------------------------------------------------------------------------
def _state(name, n, **pol):
    st = _TenantState(name, TenantPolicy(**pol))
    st.queue.extend(
        _Pending(f"{name}:{i}", None, None, None, name) for i in range(n))
    return st


def test_drr_weights_split_the_batch_proportionally():
    a, b = _state("a", 30, weight=2.0), _state("b", 30, weight=1.0)
    batch = _drr_claim([a, b], 9)
    assert Counter(p.tenant for p in batch) == {"a": 6, "b": 3}
    # and the claim interleaves (round-robin), not a-then-b
    assert [p.tenant for p in batch[:3]] == ["a", "a", "b"]


def test_drr_priority_lane_claims_first():
    hi = _state("hi", 4, priority=0)
    lo = _state("lo", 50, priority=1)
    batch = _drr_claim([lo, hi], 8)  # listed order must not matter
    assert [p.tenant for p in batch] == ["hi"] * 4 + ["lo"] * 4


def test_drr_deficit_carries_when_cut_off_and_resets_when_drained():
    c = _state("c", 2, weight=5.0)
    assert len(_drr_claim([c], 1)) == 1
    # cut off by the full batch: unused credit carries to the next window
    assert c.deficit == pytest.approx(4.0)
    assert len(_drr_claim([c], 10)) == 1
    # queue drained: leftover credit is forfeited (no hoarding)
    assert c.deficit == 0.0


def test_drr_fractional_weight_serves_every_other_round():
    d = _state("d", 5, weight=0.5)
    full = _state("e", 100, weight=1.0)
    batch = _drr_claim([d, full], 6)
    # per round: e serves 1, d accrues 0.5 — so d lands every 2nd round
    assert Counter(p.tenant for p in batch) == {"e": 4, "d": 2}


# ---------------------------------------------------------------------------
# tenant admission through the service (integration)
# ---------------------------------------------------------------------------
def test_rate_and_depth_rejections_are_typed_and_counted(tpch):
    db, schema = tpch
    svc = QueryService(
        db, schema, async_max_wait_ms=60_000,
        tenants={"q": TenantPolicy(rate=1e-9, burst=2, max_queue=1)})
    try:
        # depth first: burst allows 2 but the queue holds only 1
        f1 = svc.submit_async(MINMAX, tenant="q")
        with pytest.raises(TenantAdmissionError, match="queue full") as ei:
            svc.submit_async(MINMAX, tenant="q")
        assert (ei.value.tenant, ei.value.kind) == ("q", "depth")
        # draining on close still serves the admitted request
        svc.close(timeout=120)
        assert f1.result(1).error is None
    finally:
        svc.close(timeout=10)
    # rate next: a one-token bucket that never refills
    svc2 = QueryService(
        db, schema, async_max_wait_ms=1,
        tenants={"q": TenantPolicy(rate=1e-9, burst=1)})
    try:
        f2 = svc2.submit_async(MINMAX, tenant="q")
        with pytest.raises(TenantAdmissionError, match="rate") as ei:
            svc2.submit_async(MINMAX, tenant="q")
        assert (ei.value.tenant, ei.value.kind) == ("q", "rate")
        assert isinstance(ei.value, AdmissionError)
        assert f2.result(120).error is None
        t = svc2.metrics_v2()["tenants"]["q"]
        assert t["rejected_rate"] == 1 and t["rejected"] == 1
        assert t["requests"] == 1
    finally:
        svc2.close(timeout=10)


def test_default_tenant_unlimited_and_rolled_up(tpch):
    db, schema = tpch
    svc = QueryService(db, schema)
    try:
        assert svc.submit_async(MINMAX).result(120).error is None
        v2 = svc.metrics_v2()
        t = v2["tenants"]["default"]
        assert t["requests"] == 1 and t["rejected"] == 0
        assert t["count"] == 1 and t["p50_s"] <= t["p99_s"]
        assert v2["gauges"]["open_requests"] == 0
    finally:
        svc.close(timeout=10)


# ---------------------------------------------------------------------------
# satellite regressions: span lifecycle on every scheduler exit path
# ---------------------------------------------------------------------------
def test_close_drain_timeout_ends_roots_and_raises_typed(tpch):
    """Regression (span leak + untyped close): a request still queued
    when close()'s join times out must resolve with ServiceClosedError
    AND have its root span ended — latency histograms and trace
    retention must see the failed request, not leak it open."""
    db, schema = tpch
    svc = QueryService(db, schema, async_max_wait_ms=1)
    release, entered = threading.Event(), threading.Event()
    inner = svc.submit_many

    def blocked(queries, **kw):
        entered.set()
        release.wait(60)
        return inner(queries, **kw)

    svc.submit_many = blocked
    f1 = svc.submit_async(MINMAX)               # claimed, stuck in serve
    assert entered.wait(30)
    f2 = svc.submit_async(TOTAL, tenant="late")  # still queued
    svc.close(timeout=0.2)                       # join times out
    with pytest.raises(ServiceClosedError, match="closed"):
        f2.result(10)
    # f2's root was ended (error-annotated) — only f1's is still open
    assert svc.obs.open_requests() == 1
    t = svc.metrics_v2()["tenants"]["late"]
    assert t["rejected_closed"] == 1 and t["count"] == 1
    release.set()
    assert f1.result(120).error is None
    svc._scheduler._thread.join(30)
    assert svc.obs.open_requests() == 0


def test_whole_batch_engine_failure_ends_roots(tpch):
    """Regression (span leak): when submit_many itself raises, every
    member's future gets the error AND every root span is ended."""
    db, schema = tpch
    svc = QueryService(db, schema, async_max_wait_ms=1)
    try:
        boom = RuntimeError("engine exploded")

        def exploding(queries, **kw):
            raise boom

        svc.submit_many = exploding
        futs = [svc.submit_async(q) for q in (MINMAX, TOTAL)]
        for f in futs:
            with pytest.raises(RuntimeError, match="engine exploded"):
                f.result(60)
        deadline = time.monotonic() + 10
        while svc.obs.open_requests() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.obs.open_requests() == 0
        # the failed requests landed in the latency histogram
        assert svc.metrics_v2()["histograms"]["request"]["count"] == 2
    finally:
        svc.close(timeout=10)


def test_note_on_closed_span_is_loud_under_tests():
    """Regression (note-after-close): annotating a closed span raises
    under tests instead of silently racing the trace export."""
    obs = Observability()
    root = obs.begin_request()
    sp = obs.open_span(root, "stage")
    sp.note(early=True)                      # open: fine
    obs.close_span(sp)
    with pytest.raises(RuntimeError, match="closed span"):
        sp.note(late=True)
    obs.end_request(root)
    with pytest.raises(RuntimeError, match="closed span"):
        root.note(late=True)


def test_batch_form_claimed_lands_in_chrome_export(tpch, tmp_path):
    """The batch_form span's ``claimed``/``tenants`` annotations must be
    applied before close (a closed span rejects notes under tests, so on
    the buggy ordering this roundtrip dies in the batcher)."""
    import json

    db, schema = tpch
    svc = QueryService(db, schema, async_max_wait_ms=1)
    try:
        assert svc.submit_async(MINMAX).result(120).error is None
        out = tmp_path / "trace.json"
        svc.export_trace(out)
        ev = [e for e in json.loads(out.read_text())["traceEvents"]
              if e["name"] == "batch_form"]
        assert ev and ev[0]["args"]["claimed"] >= 1
        assert ev[0]["args"]["tenants"] >= 1
    finally:
        svc.close(timeout=10)


# ---------------------------------------------------------------------------
# close() racing submit_async across tenants (stress)
# ---------------------------------------------------------------------------
def test_close_races_submissions_across_tenants(tpch):
    """Every future resolves (answer or typed error), no root span stays
    open, and per-tenant accounting balances: everything a tenant got
    admitted is either served under its name or close-drained — nothing
    is lost and nothing is served beyond what admission granted."""
    db, schema = tpch
    svc = QueryService(
        db, schema, async_max_wait_ms=1,
        tenants={"a": TenantPolicy(weight=2.0),
                 "b": TenantPolicy(priority=0),
                 "c": TenantPolicy()})
    svc.submit(MINMAX)  # warm the plan so serves are quick
    futs: dict[str, list] = {"a": [], "b": [], "c": []}
    # submit-after-close rejections, counted client-side so the
    # rejected_closed metric can be split into "future drained" vs
    # "never admitted" below
    turned_away = Counter()
    lock = threading.Lock()
    stop = threading.Event()

    def pound(tenant):
        while not stop.is_set():
            try:
                f = svc.submit_async(MINMAX, tenant=tenant)
            except ServiceClosedError:
                with lock:
                    turned_away[tenant] += 1
                return
            except AdmissionError:
                continue
            with lock:
                futs[tenant].append(f)
            time.sleep(0.001)

    threads = [threading.Thread(target=pound, args=(t,))
               for t in futs for _ in range(2)]
    for th in threads:
        th.start()
    time.sleep(0.25)
    svc.close(timeout=30)
    stop.set()
    for th in threads:
        th.join(30)
    outcomes = Counter()
    for tenant, fs in futs.items():
        for f in fs:
            try:
                res = f.result(60)        # resolves — nothing hangs
                assert res.error is None
                outcomes[tenant, "ok"] += 1
            except ServiceClosedError:
                outcomes[tenant, "drained"] += 1
    assert svc.obs.open_requests() == 0   # no span leaked anywhere
    tm = svc.metrics_v2()["tenants"]
    for tenant, fs in futs.items():
        served = tm.get(tenant, {}).get("requests", 0)
        closed = tm.get(tenant, {}).get("rejected_closed", 0)
        drained = closed - turned_away[tenant]
        # fair-share accounting: every admitted request was either served
        # under its tenant's name or close-drained — nothing lost, and
        # nothing served beyond what admission granted
        assert len(fs) == served + drained
        assert outcomes[tenant, "ok"] == served
        assert outcomes[tenant, "drained"] == drained


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
FLOAT_RTOL = 1e-6       # float SUM/AVG: the packages add in other orders


def _assert_matches_reference(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_matches_reference(got[k], w)
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype.kind == "f" and ("sum" in k or "avg" in k):
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_async_callers_match_reference_serial():
    """Independent callers, one dashboard query each, batched and fused by
    the port's scheduler, answer as the JAX package's service does for the
    same statements one at a time."""
    jdb, jschema = jrel.make_tpch_db(scale=30, seed=4)
    tdb = db_from_numpy(
        {r: {**{c: np.asarray(v) for c, v in t.columns.items()},
             "freq": np.asarray(t.freq)} for r, t in jdb.items()},
        device="cpu")
    tschema = make_tpch_db(scale=30, seed=4, device="cpu")[1]
    jserial = jsvc.QueryService(jdb, jschema)
    want = [jserial.submit(q).values for q in DASHBOARD]

    svc = QueryService(tdb, tschema, async_max_wait_ms=500)
    try:
        barrier = threading.Barrier(len(DASHBOARD))
        futs: list = [None] * len(DASHBOARD)

        def caller(i):
            barrier.wait()
            futs[i] = svc.submit_async(DASHBOARD[i])

        workers = [threading.Thread(target=caller, args=(i,))
                   for i in range(len(DASHBOARD))]
        for t in workers:
            t.start()
        for t in workers:
            t.join(60)
        assert not any(t.is_alive() for t in workers)
        for fut, w in zip(futs, want):
            res = fut.result(120)
            assert res.error is None
            _assert_matches_reference(res.values, w)
        m = svc.metrics()
        assert m["async_requests"] == len(DASHBOARD)
        assert m["async_batches"] < m["async_requests"]
        assert m["fused_queries"] >= 2
    finally:
        svc.close()
