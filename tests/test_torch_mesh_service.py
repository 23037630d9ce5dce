"""Mesh serving: the port's ``QueryService(mesh=...)`` against its own
local service and the JAX package's local and mesh services.

(a) The JAX package's ``tests/test_mesh_cache_keys.py`` on the port,
    in-process on a one-rank ``gloo`` mesh (a ``FileStore`` rendezvous
    under pytest's tmp dir, destroyed at teardown), and the cache keys and
    store fingerprints of both packages equal for every topology.
(b) The contract of the JAX package's ``tests/helpers/mesh_service_check.py``
    at 2 and 4 ``gloo`` ranks and at 8 as ("pod", "data") 2×4, one
    ``torch.multiprocessing`` spawn per world size over
    ``make_tpch_db(scale=50, seed=11)`` with ``min_bucket`` 8: every
    planner mode and ``auto``, ``submit_many``, solo against batch,
    ``submit_async``, the mesh gauges, ``explain()``'s placement and growth
    inside the bucket with no recompile.  The answers are held bitwise
    against the port's local service with ``min_bucket = 8·n``, and against
    the JAX package's local service on the same stream and its mesh service
    (over 8 host devices, in a subprocess of this file) on every query that
    one serves: bitwise, but float SUM/AVG within rtol 1e-6, since the two
    packages add in other orders (as ``tests/test_torch_service.py``
    holds them).  The queries the JAX mesh service cannot serve are
    recorded (the median's final aggregate over sharded arrays, fault R2)
    and held against the JAX local service only.
(c) Lockstep at 2 ranks: rank-dependent injected clocks under which rank 1
    alone would demote a fused group give equal demotions, fused batches
    and answers on both ranks; async bursts with different sleeps on each
    rank give equal batches and answers; a sync ``submit`` beside the async
    scheduler does not hang; over a shared ``cache_dir`` only rank 0 writes,
    and a warm restart builds no plan and runs no tuning search on either
    rank.

Every spawn and the JAX subprocess run under one deadline, so a hang fails
the module in bounded time.
Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_service.py``.
"""

import datetime
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
TIMEOUT_S = 420
FLOAT_RTOL = 1e-6
MIN_BUCKET = 8
TPCH = {"scale": 50, "seed": 11}
MODES = ("ref", "opt", "opt_plus", "oma", "auto")     # auto last: the deep
MESHES = [("2", (2,), ("data",)), ("4", (4,), ("data",)),  # checks use it
          ("2x4", (2, 4), ("pod", "data"))]

# tests/helpers/mesh_service_check.py's queries
FIG1 = """
SELECT MIN(s.s_acctbal), MAX(s.s_acctbal)
FROM region r, nation n, supplier s, partsupp ps, part p
WHERE r.r_regionkey = n.n_regionkey AND n.n_nationkey = s.s_nationkey
  AND s.s_suppkey = ps.ps_suppkey AND ps.ps_partkey = p.p_partkey
  AND r.r_name IN (2, 3) AND p.p_price > 1200.0
"""
MEDIAN = """
SELECT MEDIAN(s.s_acctbal)
FROM region r, nation n, supplier s, partsupp ps, part p
WHERE r.r_regionkey = n.n_regionkey AND n.n_nationkey = s.s_nationkey
  AND s.s_suppkey = ps.ps_suppkey AND ps.ps_partkey = p.p_partkey
  AND r.r_name IN (0, 1) AND p.p_price > 800.0
"""
GROUPBY = """
SELECT COUNT(*) AS suppliers, AVG(s.s_acctbal) AS avg_bal
FROM supplier s, nation n
WHERE s.s_nationkey = n.n_nationkey
GROUP BY s.s_nationkey
"""
COSTLY = """
SELECT SUM(ps.ps_supplycost), COUNT(*)
FROM partsupp ps, part p
WHERE ps.ps_partkey = p.p_partkey AND p.p_price > 1500.0
"""
QUERIES = [("fig1", FIG1), ("median", MEDIAN), ("groupby", GROUPBY),
           ("costly", COSTLY)]
# two queries sharing a subplan, fused when served together
DIMS = """FROM supplier s, nation n, region r
    WHERE s.s_nationkey = n.n_nationkey
      AND n.n_regionkey = r.r_regionkey AND r.r_name IN (2, 3)"""
DASH = [f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {DIMS}",
        f"SELECT SUM(s.s_acctbal) {DIMS}"]


def _tokens(db) -> str:
    return "".join(f"{r}:{db[r].content_token()};" for r in sorted(db))


def _put(out: dict, prefix: str, values: dict) -> None:
    """Flatten an answer dict (``groups`` nested) into ``out``."""
    for k, v in values.items():
        if isinstance(v, dict):
            _put(out, f"{prefix}|{k}", v)
        else:
            out[f"{prefix}|{k}"] = np.asarray(v)


def _record(out: dict, prefix: str, res) -> None:
    if res.error is not None:
        out[f"{prefix}|error"] = np.asarray(type(res.error).__name__)
    else:
        _put(out, prefix, res.values)


def _grown_columns(db, n_shards: int) -> dict:
    """partsupp with 3 rows a shard appended (copies of its first rows):
    growth inside every shard's bucket."""
    extra = 3 * n_shards
    return {c: np.concatenate([np.asarray(a), np.asarray(a)[:extra]])
            for c, a in db["partsupp"].columns.items()}


def _stream(out: dict, prefix: str, make, grown) -> None:
    """mesh_service_check.py's request stream through ``make(mode)``'s
    services (either package), every answer and outcome recorded."""
    svc = None
    for mode in MODES:
        svc = make(mode)
        batch = svc.submit_many([q for _, q in QUERIES])
        for (name, q), r in zip(QUERIES, batch):
            _record(out, f"{prefix}|{mode}|{name}|batch", r)
            if r.error is None:
                _put(out, f"{prefix}|{mode}|{name}|solo",
                      svc.submit(q).values)
    fut = svc.submit_async(FIG1)
    _put(out, f"{prefix}|async", fut.result(timeout=TIMEOUT_S).values)
    svc.close()
    gauges = {k: v for k, v in svc.metrics_v2()["gauges"].items()
              if k.startswith("mesh_")}
    exp = svc.explain(FIG1)
    out[f"{prefix}|explain"] = np.asarray(json.dumps({
        "gauges": gauges, "topology": exp["topology"],
        "sharding": exp["sharding"],
        "text": [ln for ln in exp["text"].splitlines() if "sharding" in ln]},
        sort_keys=True))
    before = svc.metrics()
    svc.update_table("partsupp", grown)
    mid = svc.metrics()
    res = svc.submit(COSTLY)
    after = svc.metrics()
    _put(out, f"{prefix}|growth", res.values)
    out[f"{prefix}|growth_counts"] = np.asarray(
        [mid["bucket_invalidations"] - before["bucket_invalidations"],
         after["compiles"] - before["compiles"],
         int(res.stats.exec_cache_hit)])


# ---------------------------------------------------------------------------
# the JAX side (run as ``python tests/test_torch_mesh_service.py jax OUT``)
# ---------------------------------------------------------------------------
def _jax_side(out_path: str) -> None:
    import jax
    from jax.sharding import Mesh

    import repro.service as jsvc
    from repro.data.relational import make_tpch_db
    from repro.tables.table import Table

    assert jax.device_count() == 8, jax.device_count()
    db, schema = make_tpch_db(**TPCH)
    out: dict = {"tokens": np.asarray(_tokens(db))}
    for tag, shape, names in MESHES:
        n = math.prod(shape)
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
        grown = Table.from_numpy(_grown_columns(db, n))
        for side, kw in (("jmesh", {"mesh": mesh, "min_bucket": MIN_BUCKET}),
                         ("jlocal", {"min_bucket": MIN_BUCKET * n})):
            _stream(out, f"{tag}|{side}",
                    lambda mode, kw=kw: jsvc.QueryService(db, schema,
                                                          mode=mode, **kw),
                    grown)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port side: one spawn per world size
# ---------------------------------------------------------------------------
def _clock(rank: int):
    """(clock, go_fused): a fake clock ticking 1 ms a read on rank 0; on
    rank 1, 0.1 ms a read until ``go_fused()``, then 1 s a read, so rank 1's
    own fused serve times regress 10^4-fold against its solo ones."""
    st = {"t": 0.0, "tick": 1e-3 if rank == 0 else 1e-4}

    def clock():
        st["t"] += st["tick"]
        return st["t"]

    def go_fused():
        if rank == 1:
            st["tick"] = 1.0

    return clock, go_fused


def _feedback_case(out, tag, svc, go_fused):
    """Solo serves of DASH's members, then four fused batches of both."""
    for _ in range(2):
        for q in DASH:
            svc.submit(q)
    go_fused()
    for i in range(4):
        for j, r in enumerate(svc.submit_many(DASH)):
            _record(out, f"clock|{tag}|{i}|{j}", r)
    m = svc.metrics()
    out[f"clock|{tag}|counts"] = np.asarray(
        [m["fusion_demotions"], m["fused_batches"]])


def _watch_writes(root: str) -> list:
    """Record every file-system write under ``root`` from here on (the
    stores' temp files, renames, unlinks and directories)."""
    import pathlib
    import tempfile
    seen: list = []

    def under(p) -> bool:
        return p is not None and str(p).startswith(root)

    def wrap(obj, name, path_of):
        orig = getattr(obj, name)

        def call(*a, **kw):
            if under(path_of(*a, **kw)):
                seen.append((name, str(path_of(*a, **kw))))
            return orig(*a, **kw)

        setattr(obj, name, call)

    wrap(tempfile, "mkstemp", lambda *a, **kw: kw.get("dir"))
    wrap(os, "replace", lambda src, dst, *a, **kw: dst)
    wrap(os, "unlink", lambda p, *a, **kw: p)
    wrap(pathlib.Path, "unlink", lambda self, *a, **kw: self)
    wrap(pathlib.Path, "mkdir", lambda self, *a, **kw: self)
    return seen


def _lockstep_cases(rank, mesh, db, schema, out_dir: Path) -> dict:
    from repro_torch.service import QueryService
    out: dict = {}

    # -- rank 0's clock decides the serve-time feedback --------------------
    clock, go_fused = _clock(rank)
    _feedback_case(out, "mesh", QueryService(
        db, schema, mesh=mesh, min_bucket=MIN_BUCKET, clock=clock), go_fused)
    clock, go_fused = _clock(rank)
    _feedback_case(out, "local", QueryService(
        db, schema, min_bucket=MIN_BUCKET * 2, clock=clock), go_fused)

    # -- rank 0's async windows, whatever each rank's pace -----------------
    svc = QueryService(db, schema, mesh=mesh, min_bucket=MIN_BUCKET,
                       async_max_wait_ms=5.0)
    futs = []
    for i in range(12):
        futs.append(svc.submit_async(QUERIES[i % 4][1]))
        time.sleep(0.003 * ((i + 1) % 2) if rank == 0 else 0.004 * (i % 3))
    for i, f in enumerate(futs):
        _record(out, f"burst|{i}", f.result(timeout=TIMEOUT_S))
    svc.close()
    m = svc.metrics()
    out["burst|counts"] = np.asarray([m["async_requests"],
                                      m["async_batches"]])

    # -- a sync caller beside the async scheduler --------------------------
    svc = QueryService(db, schema, mesh=mesh, min_bucket=MIN_BUCKET,
                       async_max_wait_ms=2.0)
    futs = []
    burst = threading.Thread(target=lambda: futs.extend(
        svc.submit_async(QUERIES[i % 4][1]) for i in range(8)))
    burst.start()
    for name, q in QUERIES[::-1]:
        _record(out, f"beside|sync|{name}", svc.submit_many([q])[0])
    burst.join(TIMEOUT_S)
    out["beside|joined"] = np.asarray(not burst.is_alive())
    for i, f in enumerate(futs):
        _record(out, f"beside|async|{i}", f.result(timeout=TIMEOUT_S))
    svc.close()

    # -- one cache_dir: rank 0 writes, every rank reads --------------------
    cache = str(out_dir / "cache")
    seen = _watch_writes(cache) if rank == 1 else []
    facts = {}
    for run in ("cold", "warm"):
        svc = QueryService(db, schema, mesh=mesh, min_bucket=MIN_BUCKET,
                           cache_dir=cache)
        for name, q in QUERIES:
            _record(out, f"cache|{run}|{name}", svc.submit_many([q])[0])
        summary = svc.autotune(kernels=("segment_sum",))
        m = svc.metrics()
        facts[run] = {"summary": summary, **{k: m[k] for k in (
            "plan_builds", "persist_hits", "persist_writes", "stat_refreshes",
            "tune_searches", "tune_entries", "tune_persist_writes",
            "stats_persist_writes")}}
        svc.close()
        del svc
    facts["writes"] = seen
    out["cache|facts"] = np.asarray(json.dumps(facts, sort_keys=True))
    return out


def _port_worker(rank: int, tag: str, shape, names, store: str,
                 out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data.relational import make_tpch_db
    from repro_torch.service import QueryService
    from repro_torch.tables.table import Table

    torch.set_num_threads(1)
    world = math.prod(shape)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        db, schema = make_tpch_db(**TPCH, device="cpu")
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
        grown = Table.from_numpy(_grown_columns(db, world), device="cpu")
        out: dict = {"tokens": np.asarray(_tokens(db))}
        _stream(out, "mesh",
                lambda mode: QueryService(db, schema, mode=mode, mesh=mesh,
                                          min_bucket=MIN_BUCKET), grown)
        if rank == 0:
            _stream(out, "local",
                    lambda mode: QueryService(db, schema, mode=mode,
                                              min_bucket=MIN_BUCKET * world),
                    grown)
        if tag == "2":
            out.update(_lockstep_cases(rank, mesh, db, schema,
                                       Path(out_dir)))
        np.savez(Path(out_dir) / f"port_{tag}_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX side, {mesh tag: [each rank's outputs]})."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_service")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    jax_run = subprocess.Popen(
        [sys.executable, __file__, "jax", str(tmp / "jax.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port: dict = {}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for tag, shape, names in MESHES:
            world = math.prod(shape)
            ctx = mp.start_processes(
                _port_worker, args=(tag, shape, names,
                                    str(tmp / f"store_{tag}"), str(tmp)),
                nprocs=world, join=False, start_method="spawn")
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    pytest.fail(f"the port's {tag} spawn timed out")
            port[tag] = [_load(tmp / f"port_{tag}_{r}.npz")
                         for r in range(world)]
        log, _ = jax_run.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
        assert jax_run.returncode == 0, f"JAX side failed:\n{log}"
        want = _load(tmp / "jax.npz")
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    return want, port


def _slice(d: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in d.items()
            if k.startswith(prefix + "|")}


def _assert_bitwise(got: dict, want: dict, ctx: str) -> None:
    assert got and sorted(got) == sorted(want), (ctx, sorted(got),
                                                 sorted(want))
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), (ctx, k, a, b)


def _assert_reference(got: dict, want: dict, ctx: str) -> None:
    """The port's answers against the JAX package's: bitwise, but float
    SUM/AVG columns within ``FLOAT_RTOL``."""
    assert got and sorted(got) == sorted(want), (ctx, sorted(got),
                                                 sorted(want))
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f" and ("sum" in k or "avg" in k):
            np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, err_msg=ctx)
        else:
            assert a.tobytes() == b.tobytes(), (ctx, k, a, b)


def _outcome(d: dict, prefix: str):
    """A request's recorded outcome: ("error", type name) or ("ok", the
    flattened answer)."""
    err = d.get(f"{prefix}|error")
    if err is not None:
        return "error", str(err)
    return "ok", _slice(d, prefix)


# ---------------------------------------------------------------------------
# (b) the service contract against the three targets
# ---------------------------------------------------------------------------
def test_inputs_are_the_same_tables(runs):
    want, port = runs
    for tag, ranks in port.items():
        for r, got in enumerate(ranks):
            assert str(got["tokens"]) == str(want["tokens"]), (tag, r)


CASES = [(tag, mode) for tag, _, _ in MESHES for mode in MODES]
IDS = [f"{tag}-{mode}" for tag, mode in CASES]


@pytest.mark.parametrize("tag,mode", CASES, ids=IDS)
def test_mesh_matches_port_local_service(runs, tag, mode):
    """Every query of the batch, bitwise the port's local service padded
    the same (error parity where a mode cannot plan it); each solo submit
    bitwise its batch answer; every rank's outputs bitwise rank 0's."""
    _, port = runs
    ranks = port[tag]
    for r in range(1, len(ranks)):
        _assert_bitwise(_slice(ranks[r], "mesh"), _slice(ranks[0], "mesh"),
                        f"{tag} rank {r}")
    got, local = ranks[0], ranks[0]
    for name, _ in QUERIES:
        p = f"{mode}|{name}|batch"
        kind, mesh = _outcome(got, f"mesh|{p}")
        lkind, loc = _outcome(local, f"local|{p}")
        assert (kind, kind == "error" and mesh) == (lkind, lkind == "error"
                                                    and loc), (tag, p)
        if kind == "ok":
            _assert_bitwise(mesh, loc, f"{tag} {p}")
            _assert_bitwise(_slice(got, f"mesh|{mode}|{name}|solo"), mesh,
                            f"{tag} {p} solo")


@pytest.mark.parametrize("tag,mode", CASES, ids=IDS)
def test_mesh_matches_jax_local_service(runs, tag, mode):
    want, port = runs
    got = port[tag][0]
    for name, _ in QUERIES:
        p = f"{mode}|{name}|batch"
        kind, mesh = _outcome(got, f"mesh|{p}")
        jkind, jloc = _outcome(want, f"{tag}|jlocal|{p}")
        assert kind == jkind, (tag, p, mesh, jloc)
        if kind == "error":
            assert mesh == jloc, (tag, p)
        else:
            _assert_reference(mesh, jloc,
                              f"{tag} {p} vs the JAX local service")


# the JAX mesh service's known failure: the median's final aggregate over
# sharded arrays (fault R2; under JAX 0.9.0 it shows on a 1-D mesh of 8
# devices, not on these meshes)
R2 = "ShardingTypeError"


@pytest.mark.parametrize("tag,mode", CASES, ids=IDS)
def test_mesh_matches_jax_mesh_service(runs, tag, mode, record_property):
    """Every query the JAX package's mesh service serves, as against the
    JAX local service; the ones it fails under R2 are recorded (the
    ``r2`` property) and left to the JAX local service's comparison."""
    want, port = runs
    got = port[tag][0]
    r2 = []
    for name, _ in QUERIES:
        p = f"{mode}|{name}|batch"
        kind, mesh = _outcome(got, f"mesh|{p}")
        jkind, jmesh = _outcome(want, f"{tag}|jmesh|{p}")
        if jkind == "error" and jmesh == R2:
            r2.append(name)
            assert kind == "ok", (tag, p)
            continue
        assert kind == jkind, (tag, p, mesh, jmesh)
        if kind == "error":
            assert mesh == jmesh, (tag, p)
        else:
            _assert_reference(mesh, jmesh,
                              f"{tag} {p} vs the JAX mesh service")
            _assert_reference(
                _slice(got, f"mesh|{mode}|{name}|solo"),
                _slice(want, f"{tag}|jmesh|{mode}|{name}|solo"),
                f"{tag} {p} solo vs the JAX mesh service")
    record_property("r2", r2)
    # R2 can hit the median alone, and only where it runs on the mesh
    # (Ref and Opt run eagerly on the unpadded tables)
    assert set(r2) <= ({"median"} if mode in ("opt_plus", "auto")
                       else set()), r2


@pytest.mark.parametrize("tag", [t for t, _, _ in MESHES])
def test_async_gauges_explain_and_growth(runs, tag):
    """The auto-mode service's async answer, mesh gauges, ``explain()``
    placement and within-bucket growth: bitwise the port's local
    service's, held against both JAX services' answers, and the report
    equal to the JAX mesh service's own."""
    want, port = runs
    got = port[tag][0]
    n = math.prod(dict((t, s) for t, s, _ in MESHES)[tag])
    for part in ("async", "growth"):
        mine = _slice(got, f"mesh|{part}")
        _assert_bitwise(mine, _slice(got, f"local|{part}"), f"{tag} {part}")
        _assert_reference(mine, _slice(want, f"{tag}|jlocal|{part}"),
                          f"{tag} {part} vs the JAX local service")
        _assert_reference(mine, _slice(want, f"{tag}|jmesh|{part}"),
                          f"{tag} {part} vs the JAX mesh service")
    # growth inside every shard's bucket: no invalidation, no recompile,
    # an exec-cache hit
    assert got["mesh|growth_counts"].tolist() == [0, 0, 1]
    assert want[f"{tag}|jmesh|growth_counts"].tolist() == [0, 0, 1]
    exp = json.loads(str(got["mesh|explain"]))
    assert exp == json.loads(str(want[f"{tag}|jmesh|explain"])), exp
    axes = exp["sharding"]["data_axes"]
    assert exp["gauges"]["mesh_devices"] == n
    assert exp["sharding"]["devices"] == n
    assert all(p.startswith(f"rows over {'×'.join(axes)} (")
               for p in exp["sharding"]["placement"].values())
    assert f"rows over {'×'.join(axes)} ({n} shards)" in exp["text"][0]
    local = json.loads(str(got["local|explain"]))
    assert local["sharding"] is None and local["gauges"] == {}


# ---------------------------------------------------------------------------
# (c) lockstep at 2 ranks
# ---------------------------------------------------------------------------
def test_feedback_is_rank_0s(runs):
    """Rank 1's own clock would demote the fused group (its local control
    service does); on the mesh both ranks take rank 0's serve times, so
    both keep fusing, with equal answers."""
    r0, r1 = runs[1]["2"]
    assert r1["clock|local|counts"][0] >= 1       # rank 1 alone demotes
    assert r0["clock|local|counts"].tolist() == [0, 4]
    assert r0["clock|mesh|counts"].tolist() == [0, 4]
    assert r1["clock|mesh|counts"].tolist() == [0, 4]
    _assert_bitwise(_slice(r1, "clock|mesh"), _slice(r0, "clock|mesh"),
                    "rank 1 vs rank 0")
    _assert_bitwise(_slice(r0, "clock|mesh"), _slice(r0, "clock|local"),
                    "mesh vs local")


def test_async_claims_are_rank_0s(runs):
    r0, r1 = runs[1]["2"]
    assert r0["burst|counts"].tolist() == r1["burst|counts"].tolist()
    assert r0["burst|counts"][0] == 12
    _assert_bitwise(_slice(r1, "burst"), _slice(r0, "burst"), "burst")
    for i in range(12):
        name = QUERIES[i % 4][0]
        kind, got = _outcome(r0, f"burst|{i}")
        assert kind == "ok", (i, got)
        _assert_bitwise(got, _slice(r0, f"local|auto|{name}|batch"),
                        f"burst {i}")


def test_sync_beside_async_does_not_hang(runs):
    r0, r1 = runs[1]["2"]
    assert bool(r0["beside|joined"]) and bool(r1["beside|joined"])
    _assert_bitwise(_slice(r1, "beside"), _slice(r0, "beside"), "beside")
    for name, _ in QUERIES:
        _assert_bitwise(_slice(r0, f"beside|sync|{name}"),
                        _slice(r0, f"local|auto|{name}|batch"), name)
    for i in range(8):
        _assert_bitwise(_slice(r0, f"beside|async|{i}"),
                        _slice(r0, f"local|auto|{QUERIES[i % 4][0]}|batch"),
                        f"async {i}")


def test_only_rank_0_writes_the_cache_dir(runs):
    r0, r1 = runs[1]["2"]
    f0 = json.loads(str(r0["cache|facts"]))
    f1 = json.loads(str(r1["cache|facts"]))
    assert f1["writes"] == []
    for run in ("cold", "warm"):
        assert f1[run]["persist_writes"] == 0
        assert f1[run]["tune_persist_writes"] == 0
        assert f1[run]["stats_persist_writes"] == 0
        # every rank holds rank 0's winners and returns its summary
        assert f1[run]["summary"] == f0[run]["summary"]
        assert f1[run]["tune_entries"] == f0[run]["tune_entries"] > 0
    assert f0["cold"]["persist_writes"] > 0
    assert f0["cold"]["tune_persist_writes"] > 0
    assert f0["cold"]["tune_searches"] > 0
    for f in (f0, f1):
        assert f["warm"]["plan_builds"] == 0, f
        assert f["warm"]["tune_searches"] == 0, f
        assert f["warm"]["stat_refreshes"] == 0, f
        assert f["warm"]["persist_hits"] > 0, f
    for run in ("cold", "warm"):
        _assert_bitwise(_slice(r1, f"cache|{run}"), _slice(r0, f"cache|{run}"),
                        run)


# ---------------------------------------------------------------------------
# (a) tests/test_mesh_cache_keys.py on the port, one gloo rank in-process
# ---------------------------------------------------------------------------
TOPO1 = (("data",), (1,))
TOPO8 = (("data",), (8,))
TOPO24 = (("pod", "data"), (2, 4))
TOPOS = [(), TOPO1, TOPO8, TOPO24]


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        yield DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tpch():
    from repro_torch.data.relational import make_tpch_db
    return make_tpch_db(scale=8, seed=7, device="cpu")


def test_exec_and_fused_keys_distinct_across_topologies():
    from repro_torch.service.plan_cache import PlanCache
    bucket = (("edge", 64), ("node", 32))
    keys = {PlanCache.exec_key("fp", bucket, topo) for topo in TOPOS}
    assert len(keys) == 4
    fkeys = {PlanCache.fused_key("sig", bucket, topo) for topo in TOPOS}
    assert len(fkeys) == 4
    # default stays the local key — pre-mesh entries keep hitting
    assert PlanCache.exec_key("fp", bucket) == ("fp", (), bucket)


def test_invalidate_relation_spans_topologies():
    """Bucket sits LAST in every key shape, so capacity invalidation hits
    local and mesh entries for the relation alike."""
    from repro_torch.service.plan_cache import PlanCache
    cache = PlanCache()
    bucket = (("edge", 64),)
    other = (("node", 32),)
    for topo in ((), TOPO8):
        cache.execs.put(PlanCache.exec_key("fp", bucket, topo), "x")
        cache.execs.put(PlanCache.exec_key("fp", other, topo), "y")
        cache.fused.put(PlanCache.fused_key("sig", bucket, topo), "z")
    assert cache.invalidate_relation("edge") == 4
    assert len(cache.execs) == 2          # the "node"-bucket entries survive
    assert len(cache.fused) == 0


def test_describe_is_topology_scoped():
    from repro_torch.service.plan_cache import PlanCache
    cache = PlanCache()
    bucket = (("edge", 64),)
    cache.execs.put(PlanCache.exec_key("fp", bucket, TOPO8), "x")
    assert cache.describe("fp", bucket, topo=TOPO8)["exec_in_memory"]
    assert not cache.describe("fp", bucket)["exec_in_memory"]
    assert not cache.describe("fp", bucket, topo=TOPO1)["exec_in_memory"]


def test_store_fingerprint_topology_sensitivity():
    from repro_torch.data.relational import make_tpch_db
    from repro_torch.service.plan_store import store_fingerprint
    _, schema = make_tpch_db(scale=2, seed=0, device="cpu")
    local = store_fingerprint(schema)
    assert local == store_fingerprint(schema, topology=())
    fps = {local, store_fingerprint(schema, topology=TOPO1),
           store_fingerprint(schema, topology=TOPO8),
           store_fingerprint(schema, topology=TOPO24)}
    assert len(fps) == 4


@pytest.mark.parametrize("topo", TOPOS, ids=["local", "1", "8", "2x4"])
def test_keys_and_store_fingerprint_equal_the_reference(topo):
    """The port's executable-cache keys and store fingerprint are the JAX
    package's, topology for topology: either reads the other's stores."""
    import repro.data.relational as jrel
    import repro.service.plan_cache as jcache
    import repro.service.plan_store as jstore
    from repro_torch.data.relational import make_tpch_db
    from repro_torch.service.plan_cache import PlanCache
    from repro_torch.service.plan_store import store_fingerprint
    bucket = (("part", 1024), ("partsupp", 4096))
    assert PlanCache.exec_key("fp", bucket, topo) \
        == jcache.PlanCache.exec_key("fp", bucket, topo)
    assert PlanCache.fused_key("sig", bucket, topo) \
        == jcache.PlanCache.fused_key("sig", bucket, topo)
    _, tschema = make_tpch_db(scale=2, seed=0, device="cpu")
    _, jschema = jrel.make_tpch_db(scale=2, seed=0)
    for mode, fkpk in (("auto", False), ("opt_plus", True)):
        assert store_fingerprint(tschema, mode, fkpk, topology=topo) \
            == jstore.store_fingerprint(jschema, mode, fkpk, topology=topo)


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_mesh_and_local_services_occupy_distinct_exec_entries(mesh1, tpch):
    from repro_torch.data.relational import tpch_v1_query
    from repro_torch.service import QueryService
    db, schema = tpch
    q = tpch_v1_query("minmax")
    mesh_svc = QueryService(db, schema, mesh=mesh1)
    local_svc = QueryService(db, schema)
    mr, lr = mesh_svc.submit(q), local_svc.submit(q)
    assert mr.error is None and lr.error is None
    for svc, topo in ((mesh_svc, TOPO1), (local_svc, ())):
        exec_keys = [k for k, _ in svc.cache.execs.items()]
        assert exec_keys and all(k[1] == topo for k in exec_keys), exec_keys
    # 1-device mesh with matching min_bucket pads identically → bitwise
    _equal(mr.values, lr.values)


def test_plan_store_is_topology_partitioned(mesh1, tpch, tmp_path):
    """A mesh service warm-starts from its OWN store partition
    (plan_builds == 0 on restart) and never reads a local service's —
    and vice versa: no topology leaks through ``cache_dir``."""
    from repro_torch.service import QueryService
    from repro_torch.service.plan_store import store_fingerprint
    db, schema = tpch
    q = """
    SELECT MIN(s.s_acctbal), MAX(s.s_acctbal)
    FROM supplier s, partsupp ps, part p
    WHERE s.s_suppkey = ps.ps_suppkey AND ps.ps_partkey = p.p_partkey
      AND p.p_price > 900.0
    """
    cache_dir = str(tmp_path / "plans")

    cold = QueryService(db, schema, mesh=mesh1, cache_dir=cache_dir)
    assert cold.submit(q).error is None
    assert cold.metrics()["plan_builds"] == 1
    assert len(cold.plan_store) == 1

    # warm mesh restart: the disk level answers, nothing is re-planned
    warm = QueryService(db, schema, mesh=mesh1, cache_dir=cache_dir)
    assert warm.submit(q).error is None
    assert warm.metrics()["plan_builds"] == 0
    assert warm.metrics()["persist_hits"] >= 1

    # a LOCAL service over the same cache_dir sees an empty partition
    local = QueryService(db, schema, cache_dir=cache_dir)
    assert len(local.plan_store) == 0
    assert local.submit(q).error is None
    assert local.metrics()["plan_builds"] == 1

    # ...and a differently-shaped mesh would get its own partition too
    assert (store_fingerprint(schema, topology=TOPO1)
            != store_fingerprint(schema, topology=TOPO8))


def test_mesh_observability_surfaces(mesh1, tpch):
    from repro_torch.data.relational import tpch_v1_query
    from repro_torch.service import QueryService
    db, schema = tpch
    q = tpch_v1_query("minmax")
    svc = QueryService(db, schema, mesh=mesh1)
    res = svc.submit(q)
    assert res.error is None

    gauges = svc.metrics_v2()["gauges"]
    assert gauges["mesh_devices"] == 1
    assert gauges["mesh_shard_count_data"] == 1

    # the run span carries a ring_sweep child annotated with the topology
    spans = list(res.stats.trace.walk())
    sweeps = [s for s in spans if s.name == "ring_sweep"]
    assert sweeps, [s.name for s in spans]
    assert sweeps[0].args["axes"] == "data"
    assert sweeps[0].args["shards"] == 1
    run = next(s for s in spans if s.name == "run")
    assert any(c.name == "ring_sweep" for c in run.children)

    exp = svc.explain(q)
    assert exp["topology"] == TOPO1
    assert exp["sharding"]["data_axes"] == ["data"]
    assert exp["sharding"]["placement"]
    assert "rows over data (1 shards)" in exp["text"]

    # a local service reports the absence explicitly
    local = QueryService(db, schema)
    lexp = local.explain(q)
    assert lexp["topology"] == ()
    assert lexp["sharding"] is None
    assert "single-device" in lexp["text"]


def test_mesh_of_another_device_type_is_refused(mesh1, tpch, monkeypatch):
    """CPU tables under a mesh of another device type raise at
    construction; nothing moves them or serves them elsewhere."""
    from types import SimpleNamespace

    import repro_torch.core.distributed as tdist
    from repro_torch.service import QueryService
    db, schema = tpch
    monkeypatch.setattr(tdist, "DistributedExecutor", lambda *a, **kw:
                        SimpleNamespace(device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="a mesh serves tables of its own "
                                         "device type"):
        QueryService(db, schema, mesh=SimpleNamespace(
            mesh_dim_names=("data",)))


def test_lockstep_runs_every_step_on_its_lane(mesh1):
    """At world size 1 the lane sends nothing but still runs every step on
    its one thread; a failing step or ring program raises to its own
    caller and the lane runs on; a closed lane takes no step."""
    from repro_torch.service.mesh_sync import Lockstep
    lane = Lockstep(torch.device("cpu"))
    names: list = []
    callers = [threading.Thread(target=lambda i=i: names.append(lane.run(
        ("step", i), lambda _: threading.current_thread().name)))
        for i in range(8)]
    for t in callers:
        t.start()
    for t in callers:
        t.join(TIMEOUT_S)
    assert names == ["mesh-lockstep"] * 8
    assert lane.run("payload", lambda p: p + 1, payload=41) == 42
    with pytest.raises(ZeroDivisionError):
        lane.run("bad", lambda _: 1 / 0)
    with pytest.raises(KeyError):
        lane.run("ring", lambda _: lane.program("k", lambda: {}["x"]))
    assert lane.run("after", lambda _: lane.share("rank 0's")) == "rank 0's"
    lane.close()
    lane._thread.join(TIMEOUT_S)
    with pytest.raises(RuntimeError, match="closed"):
        lane.run("late", lambda _: None)


def test_mesh_sync_imports_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    for name in ("mesh_sync.py", "engine.py", "scheduler.py"):
        f = SRC / "repro_torch" / "service" / name
        assert not pat.search(f.read_text()), name


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_side(sys.argv[2])
