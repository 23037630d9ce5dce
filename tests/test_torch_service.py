"""The serving tier: the port's ``QueryService`` against the JAX package's.

One query stream goes through both services over the same data (the JAX
package's tables carried into the port with ``db_from_numpy``, on the CPU):
cold, warm, renamed aliases, ``submit_many`` with cost-banded fusion and
with ``fusion_disparity=inf``, ``update_table`` within and across a shape
bucket, eager Ref/Opt requests, a small graph submitted as ``AggQuery``s,
warm starts from ``cache_dir``, 64-bit frequencies and the kernel tuner
(``autotune()`` cold, warm-restarted, repeated, and carried by
``export_cache``/``import_cache``).  Integer answers and MIN/MAX/MEDIAN
must be bitwise equal, float SUM/AVG within rtol 1e-6 (the packages add in
other orders); each request's ``ServeStats`` flags (cache levels, fusion
membership, bucket, mode), ``explain()``, the ``autotune()`` summaries and
every counter and gauge of ``metrics()``, the tuner's included, must be
equal.  The comparison reads ``compile_s_total``, a sum of seconds, as
positive exactly when both have compiled.  No mesh gauge appears without a
mesh.

Last, the serving tier's two disciplines, which ``scripts/lint.py`` checks
only under a path part named ``repro``: no ``perf_counter`` outside
``observability.py``, and no ``Future.set_result``/``set_exception``
outside ``scheduler._resolve``.
"""

import ast
import json
import re
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.relational as jrel
import repro.service as jsvc
import repro.tables.table as jtab
import repro_torch.data.relational as trel
import repro_torch.service as tsvc
import repro_torch.tables.table as ttab
from repro_torch.core import Executor, parse_sql, plan_query
from repro_torch.tables.table import db_from_numpy

jax.config.update("jax_platform_name", "cpu")

SERVICE_DIR = Path(__file__).resolve().parents[1] / "src/repro_torch/service"
FLOAT_RTOL = 1e-6
STATS_FIELDS = ("fingerprint", "mode", "plan_cache_hit", "exec_cache_hit",
                "shared_execution", "fused", "fused_group_size", "bucket",
                "plan_source", "exec_source")

FIVE = """FROM region r, nation n, supplier s, partsupp ps, part p
    WHERE r.r_regionkey = n.n_regionkey
      AND n.n_nationkey = s.s_nationkey
      AND s.s_suppkey = ps.ps_suppkey
      AND ps.ps_partkey = p.p_partkey
      AND r.r_name IN (2, 3) AND p.p_price > 1200.0"""
FIG1 = f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {FIVE}"
FIG1_RENAMED = """
    SELECT MAX(su.s_acctbal), MIN(su.s_acctbal)
    FROM part pa, supplier su, region re, partsupp pp, nation na
    WHERE pa.p_price > 1200.0
      AND na.n_nationkey = su.s_nationkey
      AND re.r_regionkey = na.n_regionkey
      AND pp.ps_partkey = pa.p_partkey
      AND su.s_suppkey = pp.ps_suppkey
      AND re.r_name IN (3, 2)
"""
COUNT = f"SELECT COUNT(*) {FIVE}"
MEDIAN = f"SELECT MEDIAN(s.s_acctbal) {FIVE}"
DIMS = """FROM supplier s, nation n, region r
    WHERE s.s_nationkey = n.n_nationkey
      AND n.n_regionkey = r.r_regionkey AND r.r_name IN (2, 3)"""
DASHBOARD = [
    f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {DIMS}",
    f"SELECT SUM(s.s_acctbal) {DIMS}",
    f"SELECT COUNT(*) AS cnt, AVG(s.s_acctbal) AS avg {DIMS} "
    "GROUP BY s.s_nationkey",
    FIG1,
]
COSTLY_PARTS = """SELECT SUM(ps.ps_supplycost), COUNT(*)
    FROM partsupp ps, part p
    WHERE ps.ps_partkey = p.p_partkey AND p.p_price > 1500.0"""


def _carry(jdb):
    return db_from_numpy(
        {r: {**{c: np.asarray(v) for c, v in t.columns.items()},
             "freq": np.asarray(t.freq)} for r, t in jdb.items()},
        device="cpu")


@pytest.fixture(scope="module")
def tpch():
    jdb, jschema = jrel.make_tpch_db(scale=150, seed=1)
    tschema = trel.make_tpch_db(scale=150, seed=1, device="cpu")[1]
    return jdb, jschema, _carry(jdb), tschema


def _pair(tpch, **kw):
    jdb, jschema, tdb, tschema = tpch
    return (jsvc.QueryService(jdb, jschema, **kw),
            tsvc.QueryService(tdb, tschema, **kw))


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_values(got: dict, want: dict, ctx=""):
    assert set(got) == set(want), ctx
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_values(got[k], w, ctx)
            continue
        g, w = _host(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (ctx, k)
        if g.dtype.kind == "f" and ("sum" in k or "avg" in k):
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx} {k}")


def _assert_results(tres, jres, ctx=""):
    assert (tres.error is None) == (jres.error is None), ctx
    if jres.error is not None:
        assert type(tres.error).__name__ == type(jres.error).__name__
        assert str(tres.error) == str(jres.error)
        return
    _assert_values(tres.values, jres.values, ctx)
    for f in STATS_FIELDS:
        assert getattr(tres.stats, f) == getattr(jres.stats, f), (ctx, f)
    if jres.stats.exec_stats is not None:
        assert tres.stats.exec_stats.steps == jres.stats.exec_stats.steps
        assert tres.stats.exec_stats.peak_tuples \
            == jres.stats.exec_stats.peak_tuples


def _assert_metrics(t, j):
    tm, jm = t.metrics(), j.metrics()
    assert set(tm) == set(jm)
    for k in tm:
        if k == "compile_s_total":
            assert (tm[k] > 0) == (jm[k] > 0) == (jm["compiles"] > 0)
        else:
            assert tm[k] == jm[k], k
    return tm


def _both(j, t, queries, many=False, ctx=""):
    if many:
        jr, tr = j.submit_many(queries), t.submit_many(queries)
    else:
        jr = [j.submit_many([q])[0] for q in queries]
        tr = [t.submit_many([q])[0] for q in queries]
    for i, (a, b) in enumerate(zip(tr, jr)):
        _assert_results(a, b, f"{ctx}[{i}]")
    return tr


def _resampled(tab, n_rows: int, seed: int, module, **kw):
    """``tab`` grown to ``n_rows`` by appending resampled rows."""
    cols = {c: np.asarray(v) for c, v in tab.columns.items()}
    idx = np.random.default_rng(seed).integers(0, tab.capacity,
                                               n_rows - tab.capacity)
    return module.Table.from_numpy(
        {c: np.concatenate([v, v[idx]]) for c, v in cols.items()}, **kw)


# ---------------------------------------------------------------------------
# one query stream through both services
# ---------------------------------------------------------------------------
def test_stream_matches_reference(tpch):
    j, t = _pair(tpch)
    cold = _both(j, t, [FIG1, FIG1_RENAMED, COUNT, MEDIAN, MEDIAN], ctx="solo")
    assert not cold[0].stats.exec_cache_hit and cold[1].stats.exec_cache_hit
    assert cold[1].stats.plan_cache_hit and cold[4].stats.exec_cache_hit
    _assert_metrics(t, j)
    # a batch with duplicates and cost-banded fusion
    batch = DASHBOARD + [FIG1_RENAMED, DASHBOARD[1], COSTLY_PARTS]
    res = _both(j, t, batch, many=True, ctx="batch")
    assert [r.stats.shared_execution for r in res].count(True) == 2
    m = _assert_metrics(t, j)
    assert m["fusion_cost_rejects"] >= 1 and m["dedup_saved"] == 2
    # the same batch again: every program from the caches
    res = _both(j, t, batch, many=True, ctx="batch again")
    assert all(r.stats.plan_cache_hit for r in res)
    _assert_metrics(t, j)
    _both(j, t, ["SELECT MIN(x.oops) FROM no_such_table x", "garbage",
                 f"SELECT COUNT(*) {DIMS} AND s.s_acctbal < r.r_name"],
          ctx="errors")
    assert _assert_metrics(t, j)["request_errors"] == 3


def test_fusion_without_cost_gate_matches_reference(tpch):
    j, t = _pair(tpch, fusion_disparity=float("inf"))
    res = _both(j, t, DASHBOARD, many=True, ctx="fused")
    assert all(r.stats.fused and r.stats.fused_group_size == 4 for r in res)
    m = _assert_metrics(t, j)
    assert m["fused_batches"] == 1 and m["fused_queries"] == 4
    assert m["partial_fusions"] == 1 and m["subplan_saved"] > 0
    assert m["fusion_cost_rejects"] == 0
    res = _both(j, t, DASHBOARD, many=True, ctx="fused warm")
    assert all(r.stats.exec_source == "fused_cache" for r in res)
    # fused answers equal the solo answers
    solo = tsvc.QueryService(tpch[2], tpch[3])
    for q, r in zip(DASHBOARD, res):
        _assert_values(r.values, solo.submit(q).values, q)
    _assert_metrics(t, j)


def test_explain_matches_reference(tpch):
    j, t = _pair(tpch)
    j.submit_many(DASHBOARD)
    t.submit_many(DASHBOARD)
    for q in (DASHBOARD[0], FIG1_RENAMED, COSTLY_PARTS):
        je, te = j.explain(q), t.explain(q)
        for k in set(je) - {"timings_s", "text", "subplan_keys"}:
            assert te[k] == je[k], k
        assert repr(te["subplan_keys"]) == repr(je["subplan_keys"])
        assert te["text"].splitlines()[:-1] == je["text"].splitlines()[:-1]
        assert set(te["timings_s"]) == set(je["timings_s"])
    _assert_metrics(t, j)


@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_eager_requests_match_reference(tpch, mode):
    j, t = _pair(tpch, mode=mode)
    res = _both(j, t, [FIG1, COUNT, MEDIAN, FIG1_RENAMED], ctx=mode)
    assert all(r.stats.exec_source == "eager" for r in res)
    assert res[0].stats.exec_stats.peak_tuples > 0
    m = _assert_metrics(t, j)
    assert m["eager_requests"] == 4 and m["compiles"] == 0


def test_update_table_within_and_across_bucket(tpch):
    jdb, jschema, tdb, tschema = tpch
    j, t = _pair(tpch)
    queries = [FIG1, COUNT, MEDIAN, COSTLY_PARTS]
    _both(j, t, queries, ctx="before")
    ps = jdb["partsupp"]
    bucket = jtab.bucket_capacity(ps.capacity)
    assert ps.capacity + 1000 < bucket
    for n_rows, seed, ctx in ((ps.capacity + 1000, 1, "within"),
                              (bucket + 1, 2, "across")):
        jt = _resampled(ps, n_rows, seed, jtab)
        tt = _resampled(ps, n_rows, seed, ttab, device="cpu")
        compiles = t.metrics()["compiles"]
        j.update_table("partsupp", jt)
        t.update_table("partsupp", tt)
        res = _both(j, t, queries, ctx=ctx)
        m = _assert_metrics(t, j)
        # answers on the grown data: a fresh service over it
        fresh = tsvc.QueryService({**tdb, "partsupp": tt}, tschema)
        for q, r in zip(queries, res):
            _assert_values(r.values, fresh.submit(q).values, ctx)
        recompiles = m["compiles"] - compiles
        if ctx == "within":
            assert recompiles == 0 and m["bucket_invalidations"] == 0
        else:
            assert recompiles == len(queries)
            assert m["bucket_invalidations"] >= len(queries)
    with pytest.raises(ValueError, match="dtype"):
        t.update_table("partsupp", tt.with_freq(tt.freq.to(torch.int64)))
    elsewhere = ttab.Table({c: v.to("meta") for c, v in tt.columns.items()},
                           tt.freq.to("meta"))
    with pytest.raises(ValueError, match="device"):
        t.update_table("partsupp", elsewhere)


def test_graph_aggquery_stream_matches_reference():
    jdb, jschema = jrel.make_graph_db(40, 160, seed=1)
    tdb = _carry(jdb)
    tschema = trel.make_graph_db(40, 160, seed=1, device="cpu")[1]
    j = jsvc.QueryService(jdb, jschema)
    t = tsvc.QueryService(tdb, tschema)
    for k in (2, 3, 4):
        res = [(t.submit(trel.path_query(k)), j.submit(jrel.path_query(k)))
               for _ in range(2)]
        for a, b in res:
            _assert_results(a, b, f"path-{k}")
        assert res[1][0].stats.exec_cache_hit
    jt = [j.submit(jrel.tree_query(v)) for v in (1, 2)]
    tt = [t.submit(trel.tree_query(v)) for v in (1, 2)]
    for a, b in zip(tt, jt):
        _assert_results(a, b, "tree")
    _assert_metrics(t, j)


def test_warm_start_and_cache_export_match_reference(tpch, tmp_path):
    jdb, jschema, tdb, tschema = tpch
    queries = [FIG1, COUNT, MEDIAN, COSTLY_PARTS]
    for name, mk in (("j", lambda d: jsvc.QueryService(jdb, jschema,
                                                       cache_dir=d)),
                     ("t", lambda d: tsvc.QueryService(tdb, tschema,
                                                       cache_dir=d))):
        d = str(tmp_path / name)
        first = mk(d)
        for q in queries:
            first.submit(q)
        assert first.metrics()["plan_builds"] == 4
        second = mk(d)
        for q in queries + [FIG1_RENAMED]:
            second.submit(q)
        m = second.metrics()
        assert m["plan_builds"] == 0 and m["persist_hits"] == 4
        assert m["stat_refreshes"] == 0
        assert first.export_cache(tmp_path / f"{name}-export") == 4
    t1 = tsvc.QueryService(tdb, tschema, cache_dir=str(tmp_path / "t2"))
    j1 = jsvc.QueryService(jdb, jschema, cache_dir=str(tmp_path / "j2"))
    assert t1.import_cache(tmp_path / "j-export") == 4
    assert j1.import_cache(tmp_path / "t-export") == 4
    _both(j1, t1, queries, ctx="imported")
    m = _assert_metrics(t1, j1)
    assert m["plan_builds"] == 0 and m["persist_writes"] == 4
    # the two exports hold the same entries, byte for byte
    te = sorted((tmp_path / "t-export").rglob("*.json"))
    je = sorted((tmp_path / "j-export").rglob("*.json"))
    assert [p.name for p in te] == [p.name for p in je]
    for a, b in zip(te, je):
        assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_x64_matches_reference(tpch):
    jdb, jschema, tdb, tschema = tpch
    t = tsvc.QueryService(tdb, tschema, freq_dtype=torch.int64)
    queries = [FIG1, COUNT, MEDIAN, DASHBOARD[2], COSTLY_PARTS]
    tr = t.submit_many(queries)
    with jax.enable_x64(True):
        j = jsvc.QueryService(jdb, jschema, freq_dtype=jnp.int64)
        jr = j.submit_many(queries)
        for jres in jr:
            jres.values.update(jax.tree_util.tree_map(np.asarray,
                                                      jres.values))
    for i, (a, b) in enumerate(zip(tr, jr)):
        _assert_results(a, b, f"x64[{i}]")
    assert tr[1].values["count(*)"].dtype == torch.int64
    _assert_metrics(t, j)


def test_autotune_stream_matches_reference(tmp_path):
    """The kernel tuner through both services (the port's on CPU tables,
    backend ``"plain"``; the JAX package's ``"xla"``): equal summaries and
    counters cold, after a warm restart (``searches == 0``), on a repeat,
    and after ``export_cache``/``import_cache``.  Winners are timings and
    are not compared; tuned answers are."""
    jdb, jschema = jrel.make_tpch_db(scale=20, seed=5)
    tdb = _carry(jdb)
    tschema = trel.make_tpch_db(scale=20, seed=5, device="cpu")[1]
    kernels = ("freq_join", "segment_sum")

    def pair(tag):
        return (jsvc.QueryService(jdb, jschema,
                                  cache_dir=str(tmp_path / f"j{tag}")),
                tsvc.QueryService(tdb, tschema,
                                  cache_dir=str(tmp_path / f"t{tag}")))

    j, t = pair("")
    _both(j, t, [MEDIAN, COSTLY_PARTS], ctx="untuned")
    jr, tr = j.autotune(kernels), t.autotune(kernels)
    assert tr == jr and tr["searches"] > 0 and tr["gate_rejects"] == 0
    assert tr["invalidated_executables"] == 2
    assert t.tuner.backend == "plain"
    _both(j, t, [MEDIAN, COSTLY_PARTS], ctx="tuned")
    _assert_metrics(t, j)
    assert t.autotune(kernels) == j.autotune(kernels)    # a repeat: no-op
    _assert_metrics(t, j)
    jw, tw = pair("")
    jr, tr = jw.autotune(kernels), tw.autotune(kernels)
    assert tr == jr and tr["searches"] == 0
    assert tr["invalidated_executables"] == 0
    assert _assert_metrics(tw, jw)["tune_store_hits"] == tr["entries"]
    _both(jw, tw, [MEDIAN, COSTLY_PARTS], ctx="warm")
    assert t.export_cache(tmp_path / "t-export") \
        == j.export_cache(tmp_path / "j-export")
    ji, ti = pair("-imported")
    ti.import_cache(tmp_path / "t-export")
    ji.import_cache(tmp_path / "j-export")
    assert dict(ti.tuner.table.entries()) == dict(t.tuner.table.entries())
    assert ti.autotune(kernels) == ji.autotune(kernels)
    assert ti.metrics()["tune_searches"] == 0
    _assert_metrics(ti, ji)


# ---------------------------------------------------------------------------
# the port's own surface
# ---------------------------------------------------------------------------
def test_failing_request_leaves_batch_mates_intact(tpch):
    """A request whose serve raises carries its own error; its batch-mates
    answer, and nothing reruns it on another path."""
    _, _, tdb, tschema = tpch
    t = tsvc.QueryService(tdb, tschema, fusion_disparity=float("inf"))
    calls = []
    compile_, compile_multi = t._executor.compile, t._executor.compile_multi

    def has_median(plan):
        return any(a.func == "median" for op in plan.ops
                   for a in getattr(op, "aggregates", ()))

    def failing(plan):
        calls.append("compile")
        if has_median(plan):
            raise RuntimeError("kernel refused")
        return compile_(plan)

    def failing_multi(plans):
        calls.append("compile_multi")
        if any(map(has_median, plans)):
            raise RuntimeError("kernel refused")
        return compile_multi(plans)

    t._executor.compile = failing
    t._executor.compile_multi = failing_multi
    res = t.submit_many([FIG1, MEDIAN, COUNT])
    assert res[0].ok and res[2].ok and not res[1].ok
    assert str(res[1].error) == "kernel refused" and not res[1].values
    # the fused program failed as a whole, then each member was served
    # alone by the same executor: no other path ran
    assert calls == ["compile_multi"] + ["compile"] * 3
    assert t.metrics()["request_errors"] == 1
    with pytest.raises(RuntimeError, match="kernel refused"):
        t.submit(MEDIAN)


def test_tracing_off_and_profile_ranges_give_identical_answers(tpch):
    _, _, tdb, tschema = tpch
    on = tsvc.QueryService(tdb, tschema)
    off = tsvc.QueryService(tdb, tschema, tracing=False,
                            profile_annotations=True)
    for q in (FIG1, MEDIAN, FIG1):
        a, b = on.submit(q), off.submit(q)
        _assert_values(b.values, a.values, q)
        assert b.stats.trace is None and b.stats.run_s == 0.0
        assert a.stats.trace is not None
    names = {s.name for s in a.stats.trace.walk()}
    assert {"parse", "fingerprint", "plan", "pad", "run"} <= names
    with torch.profiler.profile() as prof:
        off.submit(COUNT)
    assert "executor.run" in {e.key for e in prof.key_averages()}


def test_metrics_v2_and_chrome_trace(tpch, tmp_path):
    _, _, tdb, tschema = tpch
    t = tsvc.QueryService(tdb, tschema)
    t.submit_many(DASHBOARD)
    for _ in range(3):
        t.submit(FIG1)
    v2 = t.metrics_v2()
    assert set(v2) >= {"counters", "gauges", "histograms", "tenants"}
    assert v2["histograms"]["run"]["count"] >= 3
    assert v2["counters"]["fused_queries"] <= v2["counters"]["requests"]
    n = t.export_trace(tmp_path / "trace.json")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert n == len(events) and {"compile", "run"} <= {e["name"]
                                                      for e in events}


def test_executor_span_hook(tpch):
    _, _, tdb, tschema = tpch
    seen = []

    @contextmanager
    def hook(name):
        seen.append(name)
        yield

    ex = Executor(tdb, tschema, span_hook=hook)
    plan = plan_query(parse_sql(FIG1, tschema), tschema)
    ex.execute(plan)
    ex.compile(plan)(tdb)
    ex.compile_multi([plan])(tdb)
    assert seen == ["executor.execute", "executor.run", "executor.run_multi"]


def test_lru_cache_counters_and_eviction():
    c = tsvc.LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1           # refresh a
    c.put("c", 3)                    # evicts b (LRU)
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    m = c.counters()
    assert m["evictions"] == 1 and m["hits"] == 3 and m["misses"] == 1


def test_plan_cache_invalidate_relation():
    pc = tsvc.PlanCache(4, 4)
    pc.get_executable("fp1", (("part", 128), ("supplier", 64)), lambda: "x")
    pc.get_executable("fp2", (("nation", 32),), lambda: "y")
    assert pc.invalidate_relation("part") == 1
    assert tsvc.PlanCache.exec_key("fp2", (("nation", 32),)) in pc.execs
    assert tsvc.PlanCache.exec_key(
        "fp1", (("part", 128), ("supplier", 64))) not in pc.execs


def test_physical_plan_hashable_and_comparable(tpch):
    tschema = tpch[3]
    q = parse_sql(FIG1, tschema)
    p1, p2 = plan_query(q, tschema), plan_query(q, tschema)
    assert p1 == p2 and hash(p1) == hash(p2)
    p_ref = plan_query(q, tschema, mode="ref")
    assert p1 != p_ref and len({p1, p2, p_ref}) == 2
    assert p1.scanned_rels() == ("nation", "part", "partsupp", "region",
                                 "supplier")


# ---------------------------------------------------------------------------
# the serving tier's disciplines
# ---------------------------------------------------------------------------
def _service_sources():
    files = sorted(SERVICE_DIR.glob("*.py"))
    assert {f.name for f in files} >= {"engine.py", "scheduler.py",
                                       "observability.py"}
    return files


def test_no_raw_perf_counter_outside_observability():
    """Every timestamp of the serving tier goes through the injectable
    ``Observability`` clock."""
    offenders = [f"{f.name}:{ln}"
                 for f in _service_sources() if f.name != "observability.py"
                 for ln, line in enumerate(f.read_text().splitlines(), 1)
                 if "perf_counter" in line.split("#")[0]]
    assert offenders == []
    assert "perf_counter" in (SERVICE_DIR / "observability.py").read_text()


def test_futures_resolve_only_in_scheduler_resolve():
    """``scheduler._resolve`` (the cancel-race guard) is the only place a
    Future is resolved."""
    offenders, resolved_in = [], []
    for f in _service_sources():
        tree = ast.parse(f.read_text(), filename=str(f))
        allowed = [(n.lineno, n.end_lineno) for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef) and n.name == "_resolve"
                   and f.name == "scheduler.py"]
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("set_result", "set_exception"):
                if any(lo <= node.lineno <= hi for lo, hi in allowed):
                    resolved_in.append(node.func.attr)
                else:
                    offenders.append(f"{f.name}:{node.lineno}")
    assert offenders == []
    assert sorted(resolved_in) == ["set_exception", "set_result"]


def test_service_imports_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    for f in _service_sources():
        assert not pat.search(f.read_text()), f.name
