"""The mesh ring sweep: ``repro_torch.core.distributed`` against the JAX
package's ``repro.core.distributed``, bitwise.

The JAX side runs in a subprocess per module (one more, with
``jax_enable_x64`` on, for the 64-bit cases) over 8 host devices
(``--xla_force_host_platform_device_count=8``) and writes every expected
output to an ``.npz``.  The port side runs one ``torch.multiprocessing``
spawn per world size (2, 4 and 8 ranks over ``gloo``, rendezvous through a
``FileStore``, no TCP port to pick) that writes the port's outputs the same
way.  Both sides make their inputs from the same seeds with numpy (the
tables through each package's own generators, checked equal by their
content tokens).

Held bitwise:

  * ``ring_freq_join`` at P = 2, 4 and 8 and on the nested 2×4 pod×data
    ring, sum and any mode, presort off and on, with frequencies that wrap
    in int32; ``allreduce_freq_join`` at P = 2, 4 and 8 in both modes;
  * ``DistributedExecutor`` on every case of the reference's
    ``tests/helpers/distributed_engine_check.py``, at world size 8 (2×4
    where it uses its two-axis mesh), against the JAX package's
    ``DistributedExecutor.compile``, and against the port's local
    ``Executor`` over the same padded capacities.  The V.1 median cases
    are held against the JAX package's sweep to the root state inside its
    shard_map followed by its local ``_final_agg``, since its mesh program
    fails in the median's sort of a sharded array on this JAX (fault R2);
  * the gathered pre-aggregate root state of V.1 minmax, count and median;
  * path-4 COUNT with int64 and V.1 minmax with float64 frequencies;
  * ``topology()``, ``n_shards``, ``shard_capacity`` and
    ``sharded_bucket_capacity``.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_distributed.py``.
"""

import datetime
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
TIMEOUT_S = 420

RING_SIZES = (2, 4, 8)
MODES = ("sum", "any")
DOMAIN = 28
# (name, mesh shape, axis names); the ring functions run over every axis
RING_MESHES = [(str(p), (p,), ("data",)) for p in RING_SIZES] + [
    ("2x4", (2, 4), ("pod", "data"))]
RING_CASES = [(m, mode, presort) for m in RING_MESHES for mode in MODES
              for presort in (False, True)]
ALLREDUCE_CASES = [(m, mode) for m in RING_MESHES[:3] for mode in MODES]

GRAPH = {"n_nodes": 30, "n_edges": 500, "seed": 1}
STATS = {"n_users": 64, "n_posts": 256, "n_comments": 1000, "n_votes": 600,
         "seed": 3}
TPCH = {"scale": 64, "seed": 5}
MESH1 = ((8,), ("data",))
MESH2 = ((2, 4), ("pod", "data"))
# distributed_engine_check.py's cases: (name, db, query, mode, mesh, opts)
ENGINE_CASES = [
    ("path-03/1-axis", "graph", ("path", 3), "opt_plus", MESH1, {}),
    ("tree-02/1-axis", "graph", ("tree", 2), "opt_plus", MESH1, {}),
    ("path-04/2-axis", "graph", ("path", 4), "opt_plus", MESH2, {}),
    ("stats-count/2-axis", "stats", ("stats",), "opt_plus", MESH2, {}),
    ("tpch-v1-minmax/1-axis", "tpch", ("v1", "minmax"), "oma", MESH1, {}),
    ("tpch-v1-median/1-axis", "tpch", ("v1", "median"), "opt_plus", MESH1,
     {}),
    ("tpch-v1-minmax/2-axis", "tpch", ("v1", "minmax"), "oma", MESH2, {}),
    ("tpch-v1-median/presort", "tpch", ("v1", "median"), "opt_plus", MESH1,
     {"presort": True}),
    ("tpch-v1-minmax/dense", "tpch", ("v1", "minmax"), "oma", MESH1,
     {"dense_domain": True}),
]
# the fused program: compile_multi of these two cases' plans
FUSED = ("tpch-v1-minmax/1-axis", "tpch-v1-median/1-axis")
ROOT_CASES = [("minmax", "oma"), ("count", "oma"), ("median", "opt_plus")]
# (name, db, query, mode, mesh, freq dtype)
WIDE_CASES = [("path-04-int64", "graph", ("path", 4), "opt_plus", MESH2,
               "int64"),
              ("tpch-v1-minmax-float64", "tpch", ("v1", "minmax"), "oma",
               MESH1, "float64")]
CAPACITY_ROWS = (0, 1, 7, 8, 9, 63, 64, 65, 500, 1000, 4096, 100_001)
CAPACITY_SHARDS = (1, 2, 3, 4, 6, 8)


def _ring_inputs(n_shards: int, seed: int):
    """Global parent and child columns, ``n_shards`` equal row blocks each:
    keys in [−2, 30) (−1 and misses included, some over DOMAIN), dead
    child rows, and a few frequencies near 2^29 so sums and products wrap
    in int32."""
    rng = np.random.default_rng(seed)
    n, m = 24 * n_shards, 20 * n_shards
    pk = rng.integers(-2, 30, n).astype(np.int32)
    ck = rng.integers(-2, 30, m).astype(np.int32)
    pf = rng.integers(0, 5, n).astype(np.int32)
    cf = rng.integers(0, 4, m).astype(np.int32)
    big = rng.random(m) < 0.1
    cf[big] = rng.integers(1 << 28, 1 << 30, int(big.sum()))
    pf[rng.random(n) < 0.1] = 4099
    return pk, pf, ck, cf


def _ring_seed(mesh_name: str) -> int:
    return {"2": 2, "4": 4, "8": 8, "2x4": 24}[mesh_name]


def _put(out: dict, prefix: str, answers: dict) -> None:
    """Flatten an answer dict (``groups`` nested) into ``out``."""
    for k, v in answers.items():
        if k == "__stats__":
            continue
        if isinstance(v, dict):
            _put(out, f"{prefix}|{k}", v)
        else:
            out[f"{prefix}|{k}"] = np.asarray(v.cpu() if hasattr(v, "cpu")
                                              else v)


def _tokens(db) -> str:
    return "".join(f"{r}:{db[r].content_token()};" for r in sorted(db))


# ---------------------------------------------------------------------------
# the JAX side (run as ``python tests/test_torch_distributed.py jax OUT``)
# ---------------------------------------------------------------------------
def _jax_side(out_path: str, wide: bool) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec

    import repro.core as jcore
    import repro.core.distributed as jdist
    import repro.data as jdata
    import repro.data.relational as jrel
    from repro.core.executor import _State
    from repro.tables.table import sharded_bucket_capacity

    assert jax.device_count() == 8, jax.device_count()
    dbs = {"graph": jdata.make_graph_db(**GRAPH),
           "stats": jrel.make_stats_db(**STATS),
           "tpch": jrel.make_tpch_db(**TPCH)}
    out: dict = {f"tokens|{k}": np.asarray(_tokens(db))
                 for k, (db, _) in dbs.items()}
    if wide:
        jax.config.update("jax_enable_x64", True)

    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)

    def query(q):
        if q[0] == "path":
            return jdata.path_query(q[1])
        if q[0] == "tree":
            return jdata.tree_query(q[1])
        if q[0] == "stats":
            return jrel.stats_count_query()
        return jrel.tpch_v1_query(q[1])

    def sweep_then_local(dex, sharded, plans, db, schema, **kw):
        """Each plan's mesh sweep to its root state inside one shard_map
        (one shared memo, as the mesh program of ``compile_multi`` runs
        them), then the local Executor's final aggregate (jitted) on each
        gathered state: [(cols, freq, answers)] in plan order."""
        spec = PartitionSpec(dex.data_axes)

        def sweep(d):
            memo: dict = {}
            outs = []
            for plan in plans:
                st = dex._trace_plan(d, plan, memo,
                                     root=dex._agg_state_node(plan))
                need = dex._agg_cols(plan)
                outs.append(({v: c for v, c in st.cols.items()
                              if v in need}, st.freq))
            return outs

        states = jdist._shard_map(
            sweep, mesh=dex.mesh, in_specs=(jax.tree.map(lambda _: spec,
                                                         sharded),),
            out_specs=spec)(sharded)
        ex = jcore.Executor(db, schema, **kw)
        results = []
        for plan, (cols, freq) in zip(plans, states):
            cols = {v: jnp.asarray(np.asarray(c)) for v, c in cols.items()}
            freq = jnp.asarray(np.asarray(freq))
            agg = jax.jit(lambda c, f, plan=plan: ex._final_agg(
                plan, plan.root.op, _State(c, f)))
            results.append((cols, freq, agg(cols, freq)))
        return results

    if not wide:
        for name, shape, names in RING_MESHES:
            mesh = mesh_of(shape, names)
            spec = PartitionSpec(names)
            args = [jnp.asarray(a) for a in _ring_inputs(
                int(np.prod(shape)), _ring_seed(name))]
            for mode in MODES:
                for presort in (False, True):
                    def f(pk, pf, ck, cf, mode=mode, presort=presort):
                        return jdist.ring_freq_join(
                            pk, pf, ck, cf, ring_axes=names, mode=mode,
                            presort=presort)
                    got = jax.jit(jdist._shard_map(
                        f, mesh=mesh, in_specs=(spec,) * 4,
                        out_specs=spec))(*args)
                    out[f"ring|{name}|{mode}|{presort}"] = np.asarray(got)
                if len(shape) == 1:
                    def g(pk, pf, ck, cf, mode=mode):
                        return jdist.allreduce_freq_join(
                            pk, pf, ck, cf, ring_axes=names, mode=mode,
                            domain=DOMAIN)
                    got = jax.jit(jdist._shard_map(
                        g, mesh=mesh, in_specs=(spec,) * 4,
                        out_specs=spec))(*args)
                    out[f"allreduce|{name}|{mode}"] = np.asarray(got)

        plans = {}
        for name, dbname, q, mode, (shape, names), opts in ENGINE_CASES:
            db, schema = dbs[dbname]
            dex = jdist.DistributedExecutor(schema, mesh_of(shape, names),
                                            data_axes=names, **opts)
            sharded = dex.shard_db(db)
            plan = jcore.plan_query(query(q), schema, mode=mode)
            plans[name] = (dex, sharded, plan)
            if q == ("v1", "median"):
                [(*_, res)] = sweep_then_local(
                    dex, sharded, [plan], db, schema,
                    dense_domain=opts.get("dense_domain", False))
            else:
                res = dex.compile(plan)(sharded)
            _put(out, f"engine|{name}", dict(res))
            for rel, t in sharded.items():
                out[f"capacity|{name}|{rel}"] = np.asarray(t.capacity)
        # the fused program: compile_multi would aggregate the median on
        # sharded arrays (R2), so its shared-memo sweep runs to the root
        # states and each is aggregated locally
        dex, sharded, _ = plans[FUSED[0]]
        fused = sweep_then_local(dex, sharded, [plans[n][2] for n in FUSED],
                                 *dbs["tpch"])
        for i, (*_, res) in enumerate(fused):
            _put(out, f"fused|{i}", dict(res))

        db, schema = dbs["tpch"]
        for agg, mode in ROOT_CASES:
            dex = jdist.DistributedExecutor(schema, mesh_of(*MESH1),
                                            data_axes=MESH1[1])
            plan = jcore.plan_query(jrel.tpch_v1_query(agg), schema,
                                    mode=mode)
            [(cols, freq, res)] = sweep_then_local(
                dex, dex.shard_db(db), [plan], db, schema)
            for v, c in cols.items():
                out[f"root|{agg}|col|{v}"] = np.asarray(c)
            out[f"root|{agg}|freq"] = np.asarray(freq)
            _put(out, f"root|{agg}|answer", dict(res))

        for shape, names in (MESH1, MESH2):
            dex = jdist.DistributedExecutor(schema, mesh_of(shape, names),
                                            data_axes=names)
            tag = "x".join(map(str, shape))
            out[f"topology|{tag}|names"] = np.asarray(dex.topology()[0])
            out[f"topology|{tag}|sizes"] = np.asarray(dex.topology()[1])
            out[f"topology|{tag}|n_shards"] = np.asarray(dex.n_shards)
            out[f"topology|{tag}|shard_capacity"] = np.asarray(
                [dex.shard_capacity(n, b) for n in CAPACITY_ROWS
                 for b in (1, 8, 64)])
        out["sharded_bucket_capacity"] = np.asarray(
            [sharded_bucket_capacity(n, s, b) for n in CAPACITY_ROWS
             for s in CAPACITY_SHARDS for b in (1, 8, 64)])
    else:
        for name, dbname, q, mode, (shape, names), fdt in WIDE_CASES:
            db, schema = dbs[dbname]
            dex = jdist.DistributedExecutor(schema, mesh_of(shape, names),
                                            data_axes=names,
                                            freq_dtype=getattr(jnp, fdt))
            plan = jcore.plan_query(query(q), schema, mode=mode)
            _put(out, f"wide|{name}", dict(dex.compile(plan)(
                dex.shard_db(db))))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port side: one spawn per world size
# ---------------------------------------------------------------------------
def _port_worker(rank: int, world: int, store: str, out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch.core as tcore
    import repro_torch.data as tdata
    import repro_torch.data.relational as trel
    from repro_torch.core import distributed as tdist
    from repro_torch.tables.table import sharded_bucket_capacity

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    out: dict = {}

    def mesh_of(shape, names):
        return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return torch.cat(parts).numpy()

    if world == 2:
        # a "cuda" mesh whose groups run gloo is refused, not run on gloo
        stand_in = SimpleNamespace(mesh_dim_names=("data",),
                                   device_type="cuda",
                                   mesh=torch.arange(world),
                                   get_group=lambda name: dist.group.WORLD)
        try:
            tdist.DistributedExecutor(trel.make_tpch_db(
                scale=8, device="cpu")[1], stand_in)
            out["no_fallback"] = np.asarray("constructed")
        except RuntimeError as err:
            out["no_fallback"] = np.asarray(str(err))

    for name, shape, names in RING_MESHES:
        if int(np.prod(shape)) != world:
            continue
        mesh = mesh_of(shape, names)
        groups = [mesh.get_group(a) for a in names]
        pk, pf, ck, cf = (torch.from_numpy(a).reshape(world, -1)[rank]
                          for a in _ring_inputs(world, _ring_seed(name)))
        for mode in MODES:
            for presort in (False, True):
                got = tdist.ring_freq_join(pk, pf, ck, cf, ring_axes=groups,
                                           mode=mode, presort=presort)
                out[f"ring|{name}|{mode}|{presort}"] = gather(got)
            if len(shape) == 1:
                got = tdist.allreduce_freq_join(pk, pf, ck, cf,
                                                ring_axes=groups, mode=mode,
                                                domain=DOMAIN)
                out[f"allreduce|{name}|{mode}"] = gather(got)

    if world == 8:
        dbs = {"graph": tdata.make_graph_db(**GRAPH, device="cpu"),
               "stats": trel.make_stats_db(**STATS, device="cpu"),
               "tpch": trel.make_tpch_db(**TPCH, device="cpu")}
        for k, (db, _) in dbs.items():
            out[f"tokens|{k}"] = np.asarray(_tokens(db))
        meshes = {MESH1: mesh_of(*MESH1), MESH2: mesh_of(*MESH2)}

        def query(q):
            if q[0] == "path":
                return tdata.path_query(q[1])
            if q[0] == "tree":
                return tdata.tree_query(q[1])
            if q[0] == "stats":
                return trel.stats_count_query()
            return trel.tpch_v1_query(q[1])

        def local(dex, db, schema, plan, **kw):
            """The port's local Executor over the same padded capacities."""
            host = {k: db[k].pad_to(dex.shard_capacity(db[k].capacity))
                    for k in db}
            return tcore.Executor(host, schema, **kw).compile(plan)(host)

        plans = {}
        for name, dbname, q, mode, mesh, opts in ENGINE_CASES:
            db, schema = dbs[dbname]
            dex = tdist.DistributedExecutor(schema, meshes[mesh],
                                            data_axes=mesh[1], **opts)
            sharded = dex.shard_db(db)
            plan = tcore.plan_query(query(q), schema, mode=mode)
            plans[name] = (dex, sharded, plan)
            _put(out, f"engine|{name}", dex.compile(plan)(sharded))
            _put(out, f"local|{name}", local(
                dex, db, schema, plan,
                dense_domain=opts.get("dense_domain", False)))
            for rel, t in sharded.items():
                out[f"capacity|{name}|{rel}"] = np.asarray(
                    dex.shard_capacity(db[rel].capacity))
                out[f"shard|{name}|{rel}"] = np.asarray(t.capacity)
        dex, sharded, _ = plans[FUSED[0]]
        fused = dex.compile_multi([plans[n][2] for n in FUSED])(sharded)
        for i, res in enumerate(fused):
            _put(out, f"fused|{i}", res)

        db, schema = dbs["tpch"]
        dex = tdist.DistributedExecutor(schema, meshes[MESH1],
                                        data_axes=MESH1[1])
        sharded = dex.shard_db(db)
        for agg, mode in ROOT_CASES:
            plan = tcore.plan_query(trel.tpch_v1_query(agg), schema,
                                    mode=mode)
            st = dex._root_states(sharded, [plan])[0]
            for v, c in st.cols.items():
                out[f"root|{agg}|col|{v}"] = c.numpy()
            out[f"root|{agg}|freq"] = st.freq.numpy()
            _put(out, f"root|{agg}|answer", dex.compile(plan)(sharded))

        for shape, names in (MESH1, MESH2):
            dex = tdist.DistributedExecutor(schema, meshes[(shape, names)],
                                            data_axes=names)
            tag = "x".join(map(str, shape))
            out[f"topology|{tag}|names"] = np.asarray(dex.topology()[0])
            out[f"topology|{tag}|sizes"] = np.asarray(dex.topology()[1])
            out[f"topology|{tag}|n_shards"] = np.asarray(dex.n_shards)
            out[f"topology|{tag}|shard_capacity"] = np.asarray(
                [dex.shard_capacity(n, b) for n in CAPACITY_ROWS
                 for b in (1, 8, 64)])
        out["sharded_bucket_capacity"] = np.asarray(
            [sharded_bucket_capacity(n, s, b) for n in CAPACITY_ROWS
             for s in CAPACITY_SHARDS for b in (1, 8, 64)])

        for name, dbname, q, mode, mesh, fdt in WIDE_CASES:
            db, schema = dbs[dbname]
            fdt = getattr(torch, fdt)
            dex = tdist.DistributedExecutor(schema, meshes[mesh],
                                            data_axes=mesh[1],
                                            freq_dtype=fdt)
            plan = tcore.plan_query(query(q), schema, mode=mode)
            sharded = dex.shard_db(db)
            _put(out, f"wide|{name}", dex.compile(plan)(sharded))
            _put(out, f"widelocal|{name}",
                 local(dex, db, schema, plan, freq_dtype=fdt))

    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX side, port side): every expected and every port output."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    jax_runs = {w: subprocess.Popen(
        [sys.executable, __file__, "jax", str(tmp / f"jax_{w}.npz"), w],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for w in ("x32", "x64")}
    port: dict = {}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for world in RING_SIZES:
            out = tmp / f"port_{world}.npz"
            ctx = mp.start_processes(
                _port_worker, args=(world, str(tmp / f"store_{world}"),
                                    str(out)),
                nprocs=world, join=False, start_method="spawn")
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    pytest.fail(f"the port's {world}-rank spawn timed out")
            port.update(_load(out))
        want: dict = {}
        for w, proc in jax_runs.items():
            log, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, f"JAX side ({w}) failed:\n{log}"
            want.update(_load(tmp / f"jax_{w}.npz"))
    finally:
        for proc in jax_runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return want, port


def _assert_bitwise(want: dict, got: dict, prefix: str) -> None:
    wk = sorted(k for k in want if k.startswith(prefix + "|"))
    gk = sorted(k for k in got if k.startswith(prefix + "|"))
    assert wk and wk == gk, (prefix, wk, gk)
    for k in wk:
        a, b = want[k], got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), (k, a, b)


def _swap(d: dict, old: str, new: str) -> dict:
    return {new + k[len(old):]: v for k, v in d.items()
            if k.startswith(old + "|")}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_inputs_are_the_same_tables(runs):
    want, got = runs
    for k in ("graph", "stats", "tpch"):
        assert str(want[f"tokens|{k}"]) == str(got[f"tokens|{k}"]), k


@pytest.mark.parametrize("mesh,mode,presort", RING_CASES,
                         ids=[f"{m[0]}-{mode}-{'presort' if p else 'ring'}"
                              for m, mode, p in RING_CASES])
def test_ring_freq_join_matches_reference(runs, mesh, mode, presort):
    want, got = runs
    key = f"ring|{mesh[0]}|{mode}|{presort}"
    assert want[key].dtype == got[key].dtype == np.int32
    assert want[key].tobytes() == got[key].tobytes(), (want[key], got[key])


@pytest.mark.parametrize("mesh,mode", ALLREDUCE_CASES,
                         ids=[f"{m[0]}-{mode}" for m, mode in ALLREDUCE_CASES])
def test_allreduce_freq_join_matches_reference(runs, mesh, mode):
    want, got = runs
    key = f"allreduce|{mesh[0]}|{mode}"
    assert want[key].tobytes() == got[key].tobytes(), (want[key], got[key])


def test_ring_wraps_and_matches_a_numpy_oracle(runs):
    """The 8-rank sum ring equals Σ over matching live child rows, wrapped
    in int32, computed in numpy."""
    pk, pf, ck, cf = _ring_inputs(8, _ring_seed("8"))
    mult = np.array([cf[ck == k].astype(np.int64).sum() for k in pk])
    want = (pf.astype(np.int64) * mult).astype(np.uint64).astype(np.uint32)
    assert (pf.astype(np.int64) * mult > np.iinfo(np.int32).max).any()
    got = runs[1]["ring|8|sum|False"]
    assert got.view(np.uint32).tolist() == want.tolist()


ENGINE_IDS = [c[0] for c in ENGINE_CASES]


@pytest.mark.parametrize("name", ENGINE_IDS)
def test_executor_matches_reference(runs, name):
    """``DistributedExecutor.compile`` against the JAX package's (the median
    against its sweep plus local final aggregate)."""
    want, got = runs
    _assert_bitwise(want, got, f"engine|{name}")


@pytest.mark.parametrize("name", ENGINE_IDS)
def test_executor_matches_local_executor(runs, name):
    """The mesh answers against the port's local Executor over the same
    padded capacities, and those capacities against the JAX package's."""
    want, got = runs
    _assert_bitwise(_swap(got, f"local|{name}", "x"),
                    _swap(got, f"engine|{name}", "x"), "x")
    _assert_bitwise(want, got, f"capacity|{name}")


@pytest.mark.parametrize("i", range(len(FUSED)), ids=FUSED)
def test_fused_program_matches_reference(runs, i):
    """``compile_multi`` of V.1 minmax and median (shared ring sweeps)
    against the JAX package's shared-memo sweep of both plans plus its
    local final aggregate, and against the port's solo compile."""
    want, got = runs
    _assert_bitwise(want, got, f"fused|{i}")
    _assert_bitwise(_swap(got, f"engine|{FUSED[i]}", "x"),
                    _swap(got, f"fused|{i}", "x"), "x")


def test_shard_db_keeps_power_of_two_blocks(runs):
    """Every shard of every relation holds a power-of-two block of at least
    8 rows: the global capacity over the shard count."""
    got = runs[1]
    blocks = [k for k in got if k.startswith("shard|")]
    assert {k.split("|")[1] for k in blocks} == set(ENGINE_IDS)
    for k in blocks:
        per = int(got[k])
        assert per >= 8 and per & (per - 1) == 0, k
        assert per * 8 == int(got["capacity|" + k.split("|", 1)[1]]), k


@pytest.mark.parametrize("agg", [a for a, _ in ROOT_CASES])
def test_root_state_matches_reference_sweep(runs, agg):
    """The gathered pre-aggregate root columns and frequencies, and the
    answer aggregated from them."""
    want, got = runs
    _assert_bitwise(want, got, f"root|{agg}")


@pytest.mark.parametrize("name", [c[0] for c in WIDE_CASES])
def test_64_bit_frequencies_match_reference(runs, name):
    """path-4 COUNT in int64 and V.1 minmax with float64 frequencies, the
    JAX package with ``jax_enable_x64`` on; and the port's local Executor."""
    want, got = runs
    _assert_bitwise(want, got, f"wide|{name}")
    _assert_bitwise(_swap(got, f"widelocal|{name}", "x"),
                    _swap(got, f"wide|{name}", "x"), "x")


@pytest.mark.parametrize("tag", ["8", "2x4"])
def test_topology_matches_reference(runs, tag):
    want, got = runs
    _assert_bitwise(want, got, f"topology|{tag}")


def test_sharded_bucket_capacity_matches_reference(runs):
    want, got = runs
    assert want["sharded_bucket_capacity"].tolist() == \
        got["sharded_bucket_capacity"].tolist()


def test_cuda_mesh_without_nccl_is_refused(runs):
    assert "a cuda mesh needs NCCL" in str(runs[1]["no_fallback"])


def test_ring_schedule_turns_inner_axis_fastest():
    from repro_torch.core.distributed import ring_schedule
    assert ring_schedule([4]) == [[0], [0], [0], []]
    assert ring_schedule([2, 3]) == [[1], [1], [1, 0], [1], [1], []]
    assert ring_schedule([1]) == [[]]
    assert ring_schedule([2, 1]) == [[0], []]


def test_mesh_modules_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro$|import repro\.|"
                     r"from repro(\.| ))", re.M)
    files = sorted((SRC / "repro_torch" / "core").glob("*.py")) \
        + sorted((SRC / "repro_torch" / "tables").glob("*.py"))
    assert SRC / "repro_torch" / "core" / "distributed.py" in files
    for f in files:
        assert not pat.search(f.read_text()), f


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_side(sys.argv[2], sys.argv[3] == "x64")
