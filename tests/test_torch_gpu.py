"""The port's CUDA kernels and Executor on a GPU (marked ``gpu``).

Every test skips without a CUDA device; on one, run them with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.  Each
kernel is held against its plain PyTorch version on the same card tensors
(integer-valued inputs, so float32 and float64 results are exact too), in
every instance: int32 keys with int32/float32 frequencies (the narrow
layouts) and int32 or int64 keys with int64/float64 frequencies (the wide
ones, the JAX package's x64 setting).  The slice's queries on the GPU are
held against the same queries on the CPU, the materialising Ref/Opt joins
and 64-bit frequencies included.  The LM slice: SmolLM-135M at its full
width in float32 on the card against the same weights on the CPU, and MoE
expert load (``load_stats``) through K3 against ``bincount``.  The training
slice: a float32 train step of the dense, MoE, rwkv6 and hybrid smoke
configs on the card against the same step on the CPU.  The checkpoint
slice: a train state on the card saved, stepped in place while the write
is in flight, and restored onto the card and the CPU, bitwise.  The
distributed training slice: the mesh train step on a one-rank NCCL (1, 1)
mesh, bitwise the one-device step.  Partitioned serving: SmolLM-135M at
full width on bfloat16 weights and caches placed on that mesh, bitwise the
one-device run.
"""

import contextlib
import dataclasses
import re

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.data.relational as trel
import repro_torch.models as tm
import repro_torch.training as ttr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.kernels import freq_join as tfj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_sum as tss
from repro_torch.kernels import semi_join as tsj
from repro_torch.core.executor import ExecStats
from repro_torch.core.plan import MaterializeJoinOp
from repro_torch.kernels._build import KernelLaunchError
from repro_torch.models.moe import load_stats
from repro_torch.tables.table import (
    ColumnMeta,
    RelSchema,
    Schema,
    db_from_numpy,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("np_,nc", [(1, 1), (8, 8), (1000, 37),
                                    (4096, 1000), (100_003, 7)])
@pytest.mark.parametrize("fdt", [np.int32, np.float32])
def test_joins_match_plain(cuda, np_, nc, fdt):
    rng = np.random.default_rng(np_ + nc)
    pk = torch.tensor(rng.integers(-5, 50, np_).astype(np.int32), device=cuda)
    ck = torch.tensor(rng.integers(-5, 50, nc).astype(np.int32), device=cuda)
    pf = torch.tensor(rng.integers(0, 4, np_).astype(fdt), device=cuda)
    cf = torch.tensor(rng.integers(-1, 4, nc).astype(fdt), device=cuda)
    for mode in ("sum", "any"):
        got = tops.freq_join(pk, pf, ck, cf, mode=mode)
        want = tfj.freq_join_plain(pk, pf, ck, cf, mode=mode)
        assert torch.equal(got, want)


# lengths that take each path of the hash join (freq_join.join_path)
PATH_SHAPES = {"shared": (5000, 1000), "child": (7001, 5000),
               "parent": (5000, 7001)}
I32 = np.iinfo(np.int32)


def _edge_keys(rng, np_, nc, where):
    """Keys in [-50, 50) with −1 (the table's empty marker, kept in a side
    slot) in the parent, the child, both or neither, and int32's minimum
    and maximum on both sides; child rows with key −1 are live."""
    pk = rng.integers(-50, 50, np_).astype(np.int32)
    ck = rng.integers(-50, 50, nc).astype(np.int32)
    pk[pk == -1] = 0
    ck[ck == -1] = 0
    if where in ("parent", "both"):
        pk[::97] = -1
    if where in ("child", "both"):
        ck[::89] = -1
    pk[1:3] = [I32.min, I32.max]
    ck[1:3] = [I32.max, I32.min]
    return pk, ck


def _join_on_path(cuda, side, mode, pk, pf, ck, cf):
    """The kernel's answer, after checking that the lengths take ``side``
    and that the call counted one launch of that path."""
    assert tfj.join_path(pk.shape[0], ck.shape[0]).side == side
    kernel = tsj.K1 if mode == "any" else tfj.K2
    t = [torch.tensor(a, device=cuda) for a in (pk, pf, ck, cf)]
    before = kernel.paths[side]
    got = tops.freq_join(*t, mode=mode)
    assert kernel.paths[side] == before + 1
    return got, tfj.freq_join_plain(*t, mode=mode)


@pytest.mark.parametrize("side", list(PATH_SHAPES))
@pytest.mark.parametrize("where", ["neither", "parent", "child", "both"])
@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("fdt", [np.int32, np.float32])
def test_join_paths_with_edge_keys_match_plain(cuda, side, where, mode, fdt):
    np_, nc = PATH_SHAPES[side]
    rng = np.random.default_rng([np_, nc, len(where)])
    pk, ck = _edge_keys(rng, np_, nc, where)
    pf = rng.integers(0, 4, np_).astype(fdt)
    cf = rng.integers(-2, 4, nc).astype(fdt)
    cf[ck == -1] = 2
    got, want = _join_on_path(cuda, side, mode, pk, pf, ck, cf)
    assert torch.equal(got, want)   # integer-valued: exact in float32 too
    if where == "both":
        assert bool((got[torch.tensor(pk, device=cuda) == -1] != 0).any())


@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("fdt", [np.int32, np.float32])
def test_parent_side_with_repeated_parent_keys(cuda, mode, fdt):
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 10, 3000).astype(np.int32)
    ck = rng.integers(0, 20, 7001).astype(np.int32)
    got, want = _join_on_path(cuda, "parent", mode, pk,
                              rng.integers(0, 4, 3000).astype(fdt), ck,
                              rng.integers(-2, 4, 7001).astype(fdt))
    assert torch.equal(got, want)


@pytest.mark.parametrize("side", ["child", "parent"])
def test_int32_wrap_on_both_sides(cuda, side):
    np_, nc = PATH_SHAPES[side]
    rng = np.random.default_rng(4)
    got, want = _join_on_path(
        cuda, side, "sum", rng.integers(0, 64, np_).astype(np.int32),
        rng.integers(I32.min, I32.max, np_).astype(np.int32),
        rng.integers(0, 64, nc).astype(np.int32),
        rng.integers(I32.min, I32.max, nc).astype(np.int32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("np_,nc", [(0, 100), (100, 0), (0, 0), (0, 9000)])
@pytest.mark.parametrize("mode", ["sum", "any"])
def test_empty_sides(cuda, np_, nc, mode):
    rng = np.random.default_rng(5)
    t = [torch.tensor(a, device=cuda) for a in (
        rng.integers(0, 9, np_).astype(np.int32),
        rng.integers(0, 4, np_).astype(np.int32),
        rng.integers(0, 9, nc).astype(np.int32),
        rng.integers(0, 4, nc).astype(np.int32))]
    got = tops.freq_join(*t, mode=mode)
    assert torch.equal(got, tfj.freq_join_plain(*t, mode=mode))


@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("side", ["child", "parent"])
def test_short_table_is_refused(cuda, mode, side):
    """The C entry checks the table it is handed against its own layout: a
    table one 16-byte store short raises instead of writing past its end."""
    rng = np.random.default_rng(6)
    pk, pf, ck, cf = (torch.tensor(a, device=cuda) for a in (
        rng.integers(0, 9, 5000).astype(np.int32),
        rng.integers(0, 4, 5000).astype(np.int32),
        rng.integers(0, 9, 7001).astype(np.int32),
        rng.integers(0, 4, 7001).astype(np.int32)))
    path = tfj.JoinPath(side, tfj.table_slots(5000 if side == "parent"
                                              else 7001))
    words = tfj.table_words(path, mode)
    table = torch.empty(words - 4, dtype=torch.int32, device=cuda)
    with pytest.raises(KernelLaunchError):
        tfj.launch_phases(tfj.K2, path, mode, pk, pf, ck, cf, table,
                          torch.empty_like(pf), tfj.ALL_PHASES)


@pytest.mark.parametrize("mode", ["sum", "any"])
def test_shared_table_over_budget_is_refused(cuda, mode):
    """A shared-memory table larger than a block's 48 KiB is refused by the
    C entry (the row limit lives in ``join_path`` alone): 2^14 slots are
    64 KiB even as bare keys."""
    pk = torch.zeros(100, dtype=torch.int32, device=cuda)
    ck = torch.zeros(4097, dtype=torch.int32, device=cuda)
    path = tfj.JoinPath("shared", tfj.table_slots(ck.shape[0]))
    with pytest.raises(KernelLaunchError):
        tfj.launch_phases(tfj.K2, path, mode, pk, pk, ck, ck, None,
                          torch.empty_like(pk), tfj.ALL_PHASES)


TILE = tss.TILE


@pytest.mark.parametrize("n", [1, 17, 1024, 1025, 300_001, 0, TILE - 1,
                               TILE, TILE + 1, 3 * TILE + 5, 1 << 23])
@pytest.mark.parametrize("vdt", [np.int32, np.float32])
def test_segment_sum_matches_plain(cuda, n, vdt):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(-9, max(2, n // 8), n).astype(np.int32))
    k = torch.tensor(keys, device=cuda)
    v = torch.tensor(rng.integers(-3, 5, n).astype(vdt), device=cuda)
    got = tops.segment_sum_sorted(k, v)
    want = tss.segment_sum_plain(k, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _segsum_equal(k, v):
    got = tss.segment_sum_cuda(k, v)
    want = tss.segment_sum_plain(k, v)
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("keys", ["one run", "every row a run"])
@pytest.mark.parametrize("vdt", [np.int32, np.float32])
def test_segment_sum_one_run_and_every_row_a_run(cuda, keys, vdt):
    """One key over 2^20 rows (every tile but the first walks back through
    tiles with no run start) and every row its own run (none walks back);
    integer-valued, so float32 sums are exact too."""
    n = 1 << 20
    k = (torch.full((n,), -4, dtype=torch.int32, device=cuda)
         if keys == "one run"
         else torch.arange(n, dtype=torch.int32, device=cuda))
    rng = np.random.default_rng(7)
    v = torch.tensor(rng.integers(-3, 5, n).astype(vdt), device=cuda)
    assert _segsum_equal(k, v)


@pytest.mark.parametrize("run", [1, 80, 5 * TILE])
def test_segment_sum_int32_wraps(cuda, run):
    """int32 values over the whole int32 range add in uint32 and wrap, as
    the plain version's int32 scatter-add does."""
    n = 4 * TILE * 5 + 3
    rng = np.random.default_rng(run)
    k = torch.tensor(np.arange(n, dtype=np.int32) // run, device=cuda)
    v = torch.tensor(rng.integers(I32.min, I32.max, n, endpoint=True,
                                  dtype=np.int32), device=cuda)
    assert _segsum_equal(k, v)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("which", ["keys", "values", "both"])
@pytest.mark.parametrize("n", [TILE - 1, TILE + 1, 3 * TILE + 5])
def test_segment_sum_misaligned_views(cuda, offset, which, n):
    """Views at a storage offset are not 16-byte aligned: the kernel takes
    its scalar path for them."""
    rng = np.random.default_rng([offset, n])
    kb = torch.tensor(np.sort(rng.integers(0, n // 50 + 2, n + 3))
                      .astype(np.int32), device=cuda)
    vb = torch.tensor(rng.integers(-9, 9, n + 3).astype(np.int32),
                      device=cuda)
    ko = offset if which in ("keys", "both") else 0
    vo = offset if which in ("values", "both") else 0
    k, v = kb[ko:ko + n], vb[vo:vo + n]
    assert k.is_contiguous() and v.is_contiguous()
    assert _segsum_equal(k, v)


def test_segment_sum_back_to_back_calls(cuda):
    """Two calls of different lengths queued on one stream with no sync
    between them: each clears its own scratch (counter and tile states)."""
    rng = np.random.default_rng(8)
    ins = []
    for n in (5 * TILE + 7, 3 * TILE + 1, 7 * TILE):
        k = torch.tensor(np.sort(rng.integers(0, n // 90 + 1, n))
                         .astype(np.int32), device=cuda)
        ins.append((k, torch.tensor(rng.integers(-9, 9, n).astype(np.int32),
                                    device=cuda)))
    got = [tss.segment_sum_cuda(k, v) for k, v in ins]
    for (k, v), g in zip(ins, got):
        want = tss.segment_sum_plain(k, v)
        assert all(torch.equal(a, b) for a, b in zip(g, want))


@pytest.mark.parametrize("runs", ["one run", "mixed"])
def test_segment_sum_float32_is_bitwise_repeatable(cuda, runs):
    """Real-valued float32 sums are bitwise equal over calls: the look-back
    combines the tiles' aggregates in tile order, never atomically."""
    n = 1 << 21
    rng = np.random.default_rng(9)
    keys = (np.zeros(n, np.int32) if runs == "one run"
            else np.sort(rng.integers(0, 64, n)).astype(np.int32))
    k = torch.tensor(keys, device=cuda)
    v = torch.tensor(rng.random(n, np.float32) * 2 - 1, device=cuda)
    first = tss.segment_sum_cuda(k, v)
    for _ in range(3):
        again = tss.segment_sum_cuda(k, v)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_segment_sum_short_scratch_is_refused(cuda):
    """The C entry checks the scratch against its own layout: one word short
    of ``scratch_words``, or none above one tile, raises."""
    n = 3 * TILE + 5
    k = torch.zeros(n, dtype=torch.int32, device=cuda)
    sums, valid, scratch = tss.prepare_call(k)
    assert scratch.numel() == tss.scratch_words(n)
    for short in (scratch[:-1], None):
        with pytest.raises(KernelLaunchError):
            tss.launch_call(k, k, sums, valid, short)


@pytest.mark.parametrize("agg", ["minmax", "count", "median"])
def test_v1_on_gpu_matches_cpu(cuda, agg):
    gdb, schema = trel.make_tpch_db(scale=2000, seed=1, device=cuda)
    cdb, _ = trel.make_tpch_db(scale=2000, seed=1, device="cpu")
    plan = tcore.plan_query(trel.tpch_v1_query(agg), schema)
    want = tcore.Executor(cdb, schema).execute(plan)
    ex = tcore.Executor(gdb, schema)
    for got in (ex.execute(plan), ex.compile(plan)(gdb)):
        for k, v in want.items():
            if k != "__stats__":
                assert got[k].cpu().item() == v.item()


def test_slice_launches_every_kernel(cuda):
    """The main path goes through the kernels: K1 four times per 0MA
    query, K3 and K2 four times each per Opt⁺ query."""
    db, schema = trel.make_tpch_db(scale=200, seed=2, device=cuda)
    kernels = (tsj.K1, tfj.K2, tss.K3)
    for k in kernels:
        k.launches = 0
    ex = tcore.Executor(db, schema)
    for agg in ("minmax", "median"):
        ex.execute(tcore.plan_query(trel.tpch_v1_query(agg), schema))
    assert [k.launches for k in kernels] == [4, 4, 4]


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    k = torch.arange(10, dtype=torch.int32, device=cuda)
    f = torch.ones(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tfj.freq_join_cuda(k.long(), f, k, f)
    with pytest.raises(TypeError):
        tfj.freq_join_cuda(k, f, k, f.float())
    with pytest.raises(ValueError):
        tfj.freq_join_cuda(k, f, k.cpu(), f.cpu())
    with pytest.raises(ValueError):
        tfj.freq_join_cuda(k[::2], f[::2], k, f)
    with pytest.raises(TypeError):
        tfj.freq_join_cuda(k.long(), f, k.long(), f)
    with pytest.raises(TypeError):
        tss.segment_sum_cuda(k, f.to(torch.int16))
    with pytest.raises(TypeError):
        tss.segment_sum_cuda(k.to(torch.int16), f)


def _join_inputs(db, schema, query, mode, freq_dtype=torch.int32):
    """The executor, the plan's one materialising join and its two scanned
    input states, for a query of two atoms."""
    plan = tcore.plan_query(query, schema, mode=mode)
    ex = tcore.Executor(db, schema, freq_dtype=freq_dtype)
    (node,) = [n for n in plan.nodes if isinstance(n.op, MaterializeJoinOp)]
    p, c = (ex._scan(db, plan, n.op) for n in node.inputs)
    return ex, plan, node.op, p, c


def _join_on(device, db_of, query, mode, dead=(), freq_dtype=torch.int32):
    db, schema = db_of(device)
    ex, plan, op, p, c = _join_inputs(db, schema, query, mode, freq_dtype)
    for st, side in ((p, "parent"), (c, "child")):
        if side in dead:
            st.freq = torch.zeros_like(st.freq)
    stats = ExecStats()
    return ex._materialize_join(plan, op, p, c, stats), stats


def _assert_states_equal(got, want):
    assert list(got.cols) == list(want.cols)
    for v in want.cols:
        assert got.cols[v].dtype == want.cols[v].dtype
        assert torch.equal(got.cols[v].cpu(), want.cols[v]), v
    assert got.freq.dtype == want.freq.dtype == torch.int32
    assert torch.equal(got.freq.cpu(), want.freq)


@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_materialize_join_on_gpu_matches_cpu(cuda, mode):
    """On a zipf graph, e0 ⋈ e1 expanded (Ref) and regrouped (Opt) on the
    card equals the CPU run bit for bit, int32 frequencies."""
    def db_of(device):
        return trel.make_graph_db(3000, 30_000, seed=5, device=device)
    got, gstats = _join_on(cuda, db_of, trel.path_query(1), mode)
    want, wstats = _join_on("cpu", db_of, trel.path_query(1), mode)
    _assert_states_equal(got, want)
    assert gstats.steps == wstats.steps and wstats.steps[0][1] > 30_000


def test_float32_regroup_on_gpu_repeats_and_matches_cpu(cuda):
    """Opt's regroup over real-valued float32 frequencies on a zipf graph:
    two runs on the card agree bit for bit (K3 adds each run in one fixed
    order), and each group's sum lies within 2·eps·len·sum of the CPU
    run's, len and sum being the group's rows and the sum of their
    (positive) frequencies."""
    def db_of(device, ones=False):
        db, schema = trel.make_graph_db(3000, 30_000, seed=5, device=device)
        edge = db["edge"]
        w = np.random.default_rng(9).uniform(0.5, 2.0, edge.capacity)
        freq = edge.freq.to(torch.float32) * torch.tensor(
            np.ones_like(w) if ones else w, dtype=torch.float32,
            device=device)
        return {**db, "edge": edge.with_freq(freq)}, schema
    query, f32 = trel.path_query(1), torch.float32
    first, stats = _join_on(cuda, db_of, query, "opt", freq_dtype=f32)
    again, _ = _join_on(cuda, db_of, query, "opt", freq_dtype=f32)
    want, wstats = _join_on("cpu", db_of, query, "opt", freq_dtype=f32)
    rows, _ = _join_on("cpu", lambda d: db_of(d, ones=True), query, "opt",
                       freq_dtype=f32)
    assert stats.steps == wstats.steps
    assert first.freq.dtype == want.freq.dtype == f32
    assert torch.equal(first.freq, again.freq)
    for v in want.cols:
        assert torch.equal(first.cols[v].cpu(), want.cols[v]), v
    eps = float(torch.finfo(f32).eps)
    tol = 2 * eps * rows.freq.double() * want.freq.double()
    assert ((first.freq.cpu().double() - want.freq.double()).abs()
            <= tol).all()


@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_graph_baselines_on_gpu_match_cpu(cuda, mode):
    gdb, schema = trel.make_graph_db(500, 4000, seed=8, device=cuda)
    cdb, _ = trel.make_graph_db(500, 4000, seed=8, device="cpu")
    plan = tcore.plan_query(trel.path_query(3), schema, mode=mode)
    got = tcore.Executor(gdb, schema).execute(plan)
    want = tcore.Executor(cdb, schema).execute(plan)
    assert got["count(*)"].cpu().item() == want["count(*)"].item()
    assert got["__stats__"].steps == want["__stats__"].steps


def _two_relation_db(device):
    """R(a, b) ⋈ S(b, c) on key b in [0, 4), frequencies in [0, 3] (0 is a
    dead row), c a float32 column."""
    rng = np.random.default_rng(7)
    schema = Schema(relations={
        "R": RelSchema("R", (ColumnMeta("a", domain=9),
                             ColumnMeta("b", domain=4))),
        "S": RelSchema("S", (ColumnMeta("b", domain=4), ColumnMeta("c"))),
    })
    db = db_from_numpy({
        "R": {"a": rng.integers(0, 9, 11).astype(np.int32),
              "b": rng.integers(0, 4, 11).astype(np.int32),
              "freq": rng.integers(0, 4, 11).astype(np.int32)},
        "S": {"b": rng.integers(0, 4, 13).astype(np.int32),
              "c": rng.normal(size=13).astype(np.float32),
              "freq": rng.integers(0, 4, 13).astype(np.int32)},
    }, device=device)
    return db, schema


def _two_relation_query():
    return tcore.AggQuery(atoms=(tcore.Atom("R", "r", ("a", "b")),
                                 tcore.Atom("S", "s", ("b", "c"))),
                          aggregates=(tcore.Agg("count"),))


@pytest.mark.parametrize("dead", [("parent",), ("child",),
                                  ("parent", "child")])
@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_empty_live_side_on_gpu(cuda, dead, mode):
    """Fault R1 of the JAX package: an empty live side gives an empty state
    in the input dtypes on the card, as on the CPU, and records 0."""
    query = _two_relation_query()
    got, gstats = _join_on(cuda, _two_relation_db, query, mode, dead)
    want, wstats = _join_on("cpu", _two_relation_db, query, mode, dead)
    _assert_states_equal(got, want)
    assert got.freq.shape == (0,)
    assert gstats.steps == wstats.steps and \
        {n for _, n in gstats.steps} == {0}


def test_guard_fires_before_the_expansion_is_allocated(cuda):
    """The guard raises after one count of the join's size, before the
    expansion's index (8 bytes a tuple) could be allocated."""
    db, schema = trel.make_graph_db(1000, 200_000, seed=3, device=cuda)
    ex = tcore.Executor(db, schema, oom_guard=1_000_000)
    plan = tcore.plan_query(trel.path_query(1), schema, mode="ref")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with pytest.raises(tcore.MaterialisationLimit) as err:
        ex.execute(plan)
    total = int(re.search(r"would materialise (\d+) tuples",
                          str(err.value)).group(1))
    assert total > 1_000_000
    assert torch.cuda.max_memory_allocated() - base < 8 * total


# ---------------------------------------------------------------------------
# the 64-bit instances: int64/float64 frequencies, int32 or int64 keys
# ---------------------------------------------------------------------------
I64 = np.iinfo(np.int64)
WIDE_KEY_FREQ = [(np.int32, np.int64), (np.int32, np.float64),
                 (np.int64, np.int64), (np.int64, np.float64)]
WIDE_IDS = [f"{np.dtype(k).name}-{np.dtype(f).name}"
            for k, f in WIDE_KEY_FREQ]


def _wide_edge_keys(rng, np_, nc, kdt, where):
    """As ``_edge_keys``, with the key dtype's extremes, and for int64 keys
    a third of the parent keys moved up by 2^32 and a fifth of the child
    keys by 3·2^32, so that keys equal in their low 32 bits meet."""
    info = np.iinfo(kdt)
    pk = rng.integers(-50, 50, np_).astype(kdt)
    ck = rng.integers(-50, 50, nc).astype(kdt)
    pk[pk == -1] = 0
    ck[ck == -1] = 0
    if kdt == np.int64:
        pk[::3] += np.int64(1) << 32
        ck[::5] += np.int64(3) << 32
    if where in ("parent", "both"):
        pk[::97] = -1
    if where in ("child", "both"):
        ck[::89] = -1
    pk[1:3] = [info.min, info.max]
    ck[1:3] = [info.max, info.min]
    return pk, ck


@pytest.mark.parametrize("side", list(PATH_SHAPES))
@pytest.mark.parametrize("where", ["neither", "parent", "child", "both"])
@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("kdt,fdt", WIDE_KEY_FREQ, ids=WIDE_IDS)
def test_wide_join_paths_with_edge_keys_match_plain(cuda, side, where, mode,
                                                    kdt, fdt):
    np_, nc = PATH_SHAPES[side]
    rng = np.random.default_rng([np_, nc, len(where), kdt().itemsize])
    pk, ck = _wide_edge_keys(rng, np_, nc, kdt, where)
    pf = rng.integers(0, 4, np_).astype(fdt)
    cf = rng.integers(-2, 4, nc).astype(fdt)
    cf[ck == -1] = 2
    got, want = _join_on_path(cuda, side, mode, pk, pf, ck, cf)
    assert got.dtype == want.dtype == torch.from_numpy(pf).dtype
    assert torch.equal(got, want)   # integer-valued: exact in float64 too
    if where == "both":
        assert bool((got[torch.tensor(pk, device=cuda) == -1] != 0).any())


@pytest.mark.parametrize("side", list(PATH_SHAPES))
@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("fdt", [np.int64, np.float64])
def test_keys_equal_in_low_32_bits_stay_apart(cuda, side, mode, fdt):
    """Parent keys k + 2^32 never match child keys k: a key hashed and
    compared in 32 bits would join them.  Half the parent keys are k
    itself and do match."""
    np_, nc = PATH_SHAPES[side]
    rng = np.random.default_rng([np_, nc, 32])
    ck = rng.integers(0, 100, nc).astype(np.int64)
    pk = rng.integers(0, 100, np_).astype(np.int64)
    pk[::2] += np.int64(1) << 32
    ones_p, ones_c = np.ones(np_, fdt), np.ones(nc, fdt)
    got, want = _join_on_path(cuda, side, mode, pk, ones_p, ck, ones_c)
    assert torch.equal(got, want)
    high = torch.tensor(pk >= 2**32, device=cuda)
    assert bool((got[high] == 0).all()) and bool((got[~high] != 0).any())


@pytest.mark.parametrize("side", list(PATH_SHAPES))
def test_int64_wrap_on_every_path(cuda, side):
    """Frequencies over the whole int64 range: K2's sums and products wrap
    past 2^63 in uint64, as the plain version's int64 arithmetic does."""
    np_, nc = PATH_SHAPES[side]
    rng = np.random.default_rng([np_, 64])
    got, want = _join_on_path(
        cuda, side, "sum", rng.integers(0, 64, np_).astype(np.int64),
        rng.integers(I64.min, I64.max, np_), rng.integers(0, 64, nc)
        .astype(np.int64), rng.integers(I64.min, I64.max, nc))
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("side", ["child", "parent"])
def test_narrow_table_is_refused_for_64bit_frequencies(cuda, mode, side):
    """A table sized for the 8-byte slots of 32-bit frequencies is refused
    for a call with int64 frequencies (16-byte slots); the wide table of
    ``prepare_call`` is taken."""
    rng = np.random.default_rng(16)
    pk, pf, ck, cf = (torch.tensor(a, device=cuda) for a in (
        rng.integers(0, 9, 5000), rng.integers(0, 4, 5000),
        rng.integers(0, 9, 7001), rng.integers(0, 4, 7001)))
    path = tfj.JoinPath(side, tfj.table_slots(5000 if side == "parent"
                                              else 7001))
    narrow = torch.empty(tfj.table_words(path, mode), dtype=torch.int32,
                         device=cuda)
    out = torch.empty_like(pf)
    with pytest.raises(KernelLaunchError):
        tfj.launch_phases(tfj.K2, path, mode, pk, pf, ck, cf, narrow, out,
                          tfj.ALL_PHASES)
    _, table, _ = tfj.prepare_call(pf, ck.shape[0], mode, path)
    assert table.numel() == tfj.table_words(path, mode, wide=True)
    tfj.launch_phases(tfj.K2, path, mode, pk, pf, ck, cf, table, out,
                      tfj.ALL_PHASES)
    assert torch.equal(out, tfj.freq_join_plain(pk, pf, ck, cf, mode=mode))


# K3's instances with a 64-bit key or value (the narrow ones are above)
WIDE_SEGSUM = [(k, v) for k in (np.int32, np.int64)
               for v in (np.int32, np.float32, np.int64, np.float64)
               if 8 in (np.dtype(k).itemsize, np.dtype(v).itemsize)]


@pytest.mark.parametrize("n", [1, 17, 1024, 1025, 300_001, 0, TILE - 1,
                               TILE, TILE + 1, 3 * TILE + 5, 1 << 23])
@pytest.mark.parametrize("kdt,vdt", WIDE_SEGSUM,
                         ids=[f"{np.dtype(k).name}-{np.dtype(v).name}"
                              for k, v in WIDE_SEGSUM])
def test_wide_segment_sum_matches_plain(cuda, n, kdt, vdt):
    """Every instance with a 64-bit key or value; int64 keys are multiples
    of 2^32, so runs differ only above bit 31."""
    rng = np.random.default_rng([n, kdt().itemsize, vdt().itemsize])
    keys = np.sort(rng.integers(-9, max(2, n // 8), n)).astype(kdt)
    if kdt == np.int64:
        keys <<= 32
    k = torch.tensor(keys, device=cuda)
    v = torch.tensor(rng.integers(-3, 5, n).astype(vdt), device=cuda)
    assert _segsum_equal(k, v)


@pytest.mark.parametrize("keys", ["one run", "every row a run"])
@pytest.mark.parametrize("kdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("vdt", [np.int64, np.float64])
def test_wide_segment_sum_one_run_and_every_row_a_run(cuda, keys, kdt, vdt):
    n = 1 << 20
    k = (torch.full((n,), -4, dtype=kdt, device=cuda) if keys == "one run"
         else torch.arange(n, dtype=kdt, device=cuda))
    rng = np.random.default_rng(17)
    v = torch.tensor(rng.integers(-3, 5, n).astype(vdt), device=cuda)
    assert _segsum_equal(k, v)


@pytest.mark.parametrize("run", [1, 80, 5 * TILE])
def test_segment_sum_int64_wraps(cuda, run):
    """int64 values over the whole int64 range add in uint64 and wrap, as
    the plain version's int64 scatter-add does."""
    n = 4 * TILE * 5 + 3
    rng = np.random.default_rng(run + 1)
    k = torch.tensor(np.arange(n, dtype=np.int64) // run, device=cuda)
    v = torch.tensor(rng.integers(I64.min, I64.max, n, endpoint=True,
                                  dtype=np.int64), device=cuda)
    assert _segsum_equal(k, v)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("which", ["keys", "values", "both"])
@pytest.mark.parametrize("n", [TILE - 1, TILE + 1, 3 * TILE + 5])
def test_wide_segment_sum_misaligned_views(cuda, offset, which, n):
    """8-byte elements at an odd storage offset lie 8 bytes off a 16-byte
    boundary: the scalar path."""
    rng = np.random.default_rng([offset, n, 8])
    kb = torch.tensor(np.sort(rng.integers(0, n // 50 + 2, n + 3)) << 33,
                      device=cuda)
    vb = torch.tensor(rng.integers(-9, 9, n + 3).astype(np.float64),
                      device=cuda)
    ko = offset if which in ("keys", "both") else 0
    vo = offset if which in ("values", "both") else 0
    assert _segsum_equal(kb[ko:ko + n], vb[vo:vo + n])


@pytest.mark.parametrize("runs", ["one run", "mixed"])
def test_segment_sum_float64_is_bitwise_repeatable(cuda, runs):
    n = 1 << 21
    rng = np.random.default_rng(19)
    keys = (np.zeros(n, np.int64) if runs == "one run"
            else np.sort(rng.integers(0, 64, n)) << 32)
    k = torch.tensor(keys, device=cuda)
    v = torch.tensor(rng.random(n) * 2 - 1, device=cuda)
    first = tss.segment_sum_cuda(k, v)
    for _ in range(3):
        again = tss.segment_sum_cuda(k, v)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_segment_sum_narrow_scratch_is_refused_for_64bit_values(cuda):
    """A scratch sized for 32-bit values (8-byte states) is refused for
    64-bit values, whose tiles need a status and two 8-byte values."""
    n = 3 * TILE + 5
    k = torch.zeros(n, dtype=torch.int64, device=cuda)
    sums, valid, scratch = tss.prepare_call(k)
    assert scratch.numel() == tss.scratch_words(n, wide=True)
    narrow = torch.empty(tss.scratch_words(n), dtype=torch.int32,
                         device=cuda)
    for short in (narrow, scratch[:-1]):
        with pytest.raises(KernelLaunchError):
            tss.launch_call(k, k, sums, valid, short)


@pytest.mark.parametrize("agg", ["minmax", "count", "median"])
@pytest.mark.parametrize("fdt", [torch.int64, torch.float64])
@pytest.mark.parametrize("mode", ["auto", "opt_plus", "ref", "opt"])
def test_v1_in_64_bits_on_gpu_matches_cpu(cuda, agg, fdt, mode):
    gdb, schema = trel.make_tpch_db(scale=2000, seed=1, device=cuda)
    cdb, _ = trel.make_tpch_db(scale=2000, seed=1, device="cpu")
    plan = tcore.plan_query(trel.tpch_v1_query(agg), schema, mode=mode)
    want = tcore.Executor(cdb, schema, freq_dtype=fdt).execute(plan)
    ex = tcore.Executor(gdb, schema, freq_dtype=fdt)
    runs = [ex.execute(plan)]
    if mode in ("auto", "opt_plus"):
        runs.append(ex.compile(plan)(gdb))
    for got in runs:
        for k, v in want.items():
            if k != "__stats__":
                assert got[k].dtype == v.dtype
                assert got[k].cpu().item() == v.item()
    assert runs[0]["__stats__"].steps == want["__stats__"].steps


@pytest.mark.parametrize("fdt", [torch.int64, torch.float64])
def test_wide_slice_launches_every_kernel(cuda, fdt):
    db, schema = trel.make_tpch_db(scale=200, seed=2, device=cuda)
    kernels = (tsj.K1, tfj.K2, tss.K3)
    for k in kernels:
        k.launches = 0
    ex = tcore.Executor(db, schema, freq_dtype=fdt)
    for agg in ("minmax", "median"):
        ex.execute(tcore.plan_query(trel.tpch_v1_query(agg), schema))
    assert [k.launches for k in kernels] == [4, 4, 4]


@pytest.mark.parametrize("query", ["path_3", "tree_1"])
@pytest.mark.parametrize("mode", ["ref", "opt", "opt_plus"])
def test_float64_graph_counts_on_gpu_match_cpu(cuda, query, mode):
    """The graph counting queries of the JAX package's Table 2 benchmark,
    float64 frequencies, under its guard of 20M tuples: COUNT(*) equal
    (tree-1's, 2.8e10, past 2^31 and exact in float64), steps equal, and
    Ref's tree-1 trips the guard on the card as on the CPU."""
    gdb, schema = trel.make_graph_db(500, 4000, seed=8, device=cuda)
    cdb, _ = trel.make_graph_db(500, 4000, seed=8, device="cpu")
    q = trel.path_query(3) if query == "path_3" else trel.tree_query(1)
    plan = tcore.plan_query(q, schema, mode=mode)
    f64, guard = torch.float64, 20_000_000
    runs = []
    for db in (gdb, cdb):
        try:
            runs.append(tcore.Executor(db, schema, freq_dtype=f64,
                                       oom_guard=guard).execute(plan))
        except tcore.MaterialisationLimit as err:
            runs.append(str(err))
    got, want = runs
    if isinstance(want, str):
        assert got == want and (query, mode) == ("tree_1", "ref")
        return
    assert got["count(*)"].dtype == f64
    assert got["count(*)"].cpu().item() == want["count(*)"].item()
    assert got["__stats__"].steps == want["__stats__"].steps


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------
SERVE_FIVE = """FROM region r, nation n, supplier s, partsupp ps, part p
    WHERE r.r_regionkey = n.n_regionkey AND n.n_nationkey = s.s_nationkey
      AND s.s_suppkey = ps.ps_suppkey AND ps.ps_partkey = p.p_partkey
      AND r.r_name IN (2, 3) AND p.p_price > 1200.0"""
SERVE_V1 = [f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {SERVE_FIVE}",
            f"SELECT COUNT(*) {SERVE_FIVE}",
            f"SELECT MEDIAN(s.s_acctbal) {SERVE_FIVE}"]


def _serve_pair(cuda, **kw):
    from repro_torch.service import QueryService
    gdb, schema = trel.make_tpch_db(scale=2000, seed=3, device=cuda)
    cdb, _ = trel.make_tpch_db(scale=2000, seed=3, device="cpu")
    return (QueryService(gdb, schema, **kw), QueryService(cdb, schema, **kw))


def _values_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), v), k


def test_service_on_gpu_matches_cpu(cuda):
    """V.1's three queries, solo and fused, on CUDA tables answer as the
    same service on CPU copies, and run through every kernel."""
    gsvc, csvc = _serve_pair(cuda, fusion_disparity=float("inf"))
    kernels = (tsj.K1, tfj.K2, tss.K3)
    for k in kernels:
        k.reset_counts()
    for sql in SERVE_V1 + SERVE_V1:
        _values_equal(gsvc.submit(sql).values, csvc.submit(sql).values)
    assert all(k.launches > 0 for k in kernels)
    fused = gsvc.submit_many(SERVE_V1[::-1])
    assert all(r.stats.fused for r in fused)
    for r, sql in zip(fused, SERVE_V1[::-1]):
        _values_equal(r.values, csvc.submit(sql).values)
    m = gsvc.metrics()
    assert m["exec_hits"] >= 3 and m["request_errors"] == 0


def test_async_submit_runs_on_the_tables_device(cuda):
    gsvc, csvc = _serve_pair(cuda, async_max_wait_ms=200)
    try:
        import threading
        futs = [None] * len(SERVE_V1)

        def caller(i):
            futs[i] = gsvc.submit_async(SERVE_V1[i])

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(len(SERVE_V1))]
        tsj.K1.reset_counts()
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for f, sql in zip(futs, SERVE_V1):
            _values_equal(f.result(120).values, csvc.submit(sql).values)
        assert tsj.K1.launches > 0
        m = gsvc.metrics()
        assert m["async_requests"] == 3 and m["async_batches"] <= 3
    finally:
        gsvc.close()


def test_failing_request_on_gpu_leaves_batch_mates_intact(cuda):
    """A serve failure attaches to its own request: no rerun on the CPU,
    no plain version, and its batch-mates' answers stay intact."""
    gsvc, csvc = _serve_pair(cuda)
    ex = gsvc._executor
    compile_, compile_multi = ex.compile, ex.compile_multi

    def failing(plan):
        if plan.mode == "opt_plus":
            raise RuntimeError("refused on purpose")
        return compile_(plan)

    def failing_multi(plans):
        if any(p.mode == "opt_plus" for p in plans):
            raise RuntimeError("refused on purpose")
        return compile_multi(plans)

    ex.compile, ex.compile_multi = failing, failing_multi
    res = gsvc.submit_many(SERVE_V1)
    assert [r.ok for r in res] == [True, True, False]
    assert str(res[2].error) == "refused on purpose" and not res[2].values
    for r, sql in zip(res[:2], SERVE_V1[:2]):
        _values_equal(r.values, csvc.submit(sql).values)
    assert gsvc.metrics()["request_errors"] == 1


# ---------------------------------------------------------------------------
# the kernel tuner's card candidates (kernels/autotune.py)
# ---------------------------------------------------------------------------
def _candidates(kernel, backend):
    from repro_torch.kernels.autotune import candidate_configs
    return candidate_configs(kernel, backend)


WIDTHS = {"cuda": (np.int32, (np.int32, np.float32)),
          "cuda_wide": (np.int64, (np.int64, np.float64))}


@pytest.mark.parametrize("backend", list(WIDTHS))
@pytest.mark.parametrize("kernel", ["semi_join", "freq_join"])
@pytest.mark.parametrize("nc", [512, 513, 1024, 1025, 2048, 2049])
def test_join_candidates_match_plain_at_the_cutoffs(cuda, backend, kernel,
                                                    nc):
    """Every card candidate of K1/K2, at both widths, on children at each
    candidate's shared-path cut-off and one row past it, under a longer
    and a shorter parent (so the child side, the parent side and shared
    memory all run), with key −1 and int32's extremes on both sides."""
    kd, fdts = WIDTHS[backend]
    mode = "any" if kernel == "semi_join" else "sum"
    kernel_obj = tsj.K1 if mode == "any" else tfj.K2
    for np_ in (5000, nc - 7):
        rng = np.random.default_rng([np_, nc])
        pk, ck = _edge_keys(rng, np_, nc, "both")
        for fdt in fdts:
            t = [torch.tensor(a.astype(d), device=cuda) for a, d in (
                (pk, kd), (rng.integers(0, 4, np_), fdt), (ck, kd),
                (rng.integers(-1, 4, nc), fdt))]
            want = tfj.freq_join_plain(*t, mode=mode)
            for cfg in _candidates(kernel, backend):
                side = tfj.join_path(np_, nc, cfg).side
                before = kernel_obj.paths[side]
                got = tops.freq_join(*t, mode=mode, config=cfg)
                assert kernel_obj.paths[side] == before + 1, (cfg, side)
                assert torch.equal(got, want), (cfg, np_, fdt)


@pytest.mark.parametrize("backend", list(WIDTHS))
@pytest.mark.parametrize("edge", [-1, 1])
def test_segment_sum_candidates_match_plain_at_the_tile_edges(cuda, backend,
                                                              edge):
    """Every card candidate of K3, at both widths, at its own tile ± 1 rows
    and over three tiles (so the look-back runs), integer-valued so float
    sums are exact."""
    kd, vdts = WIDTHS[backend]
    for cfg in _candidates("segment_sum", backend):
        tile = tss.tile_rows(cfg)
        for n in (tile + edge, 3 * tile + edge):
            rng = np.random.default_rng([n, cfg.seg_min_blocks])
            k = torch.tensor(np.sort(rng.integers(-9, max(2, n // 40), n))
                             .astype(kd), device=cuda)
            for vdt in vdts:
                v = torch.tensor(rng.integers(-3, 5, n).astype(vdt),
                                 device=cuda)
                got = tops.segment_sum_sorted(k, v, config=cfg)
                want = tss.segment_sum_plain(k, v)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                    (cfg, n, vdt)


def test_segment_sum_unknown_instance_is_refused(cuda):
    from repro_torch.kernels.autotune import KernelConfig
    k = torch.zeros(10_000, dtype=torch.int32, device=cuda)
    for cfg in (KernelConfig(seg_items=16, seg_min_blocks=6),
                KernelConfig(seg_items=2)):
        with pytest.raises(KernelLaunchError):
            tss.segment_sum_cuda(k, k, config=cfg)
    with pytest.raises(KernelLaunchError):
        tsj.semi_join_cuda(k, k, k, k,
                           config=KernelConfig(join_threads=384))


@pytest.mark.parametrize("freq_dtype", [torch.int32, torch.int64])
def test_service_autotune_on_gpu(cuda, tmp_path, freq_dtype):
    """``autotune()`` on CUDA tables: no gate rejects, tuned answers equal
    the CPU service's, the executables compiled before the install are
    dropped, and a warm restart measures nothing."""
    from repro_torch.service import QueryService
    gdb, schema = trel.make_tpch_db(scale=2000, seed=3, device=cuda)
    cdb, _ = trel.make_tpch_db(scale=2000, seed=3, device="cpu")
    kw = {"freq_dtype": freq_dtype}
    gsvc = QueryService(gdb, schema, cache_dir=str(tmp_path), **kw)
    csvc = QueryService(cdb, schema, **kw)
    backend = "cuda" if freq_dtype == torch.int32 else "cuda_wide"
    assert gsvc.tuner.backend == backend
    for sql in SERVE_V1:
        gsvc.submit(sql)
    r = gsvc.autotune()
    assert r["searches"] == r["installed"] > 0 and r["gate_rejects"] == 0
    assert r["invalidated_executables"] == 3
    for sql in SERVE_V1:
        _values_equal(gsvc.submit(sql).values, csvc.submit(sql).values)
    warm = QueryService(gdb, schema, cache_dir=str(tmp_path), **kw)
    r2 = warm.autotune()
    assert r2["searches"] == 0 and r2["invalidated_executables"] == 0
    assert warm.metrics()["tune_store_hits"] == r["entries"]
    for sql in SERVE_V1:
        _values_equal(warm.submit(sql).values, csvc.submit(sql).values)


# float32 logits of the full-width model, card against CPU: each side is
# about 1.2e-6 of the largest logit off a float64 run of the same weights
# (on the CPU), both matmuls in full float32 (TF32 off, PyTorch's default)
LM_F32_TOL = 1e-4


def test_lm_smollm_full_width_matches_the_cpu(cuda):
    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    model = tm.init_params(cfg, seed=0, device=cuda)
    host = tm.LM(cfg, "cpu")
    host.load_state_dict(model.state_dict())
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    sides = [[model, cuda, None], [host, "cpu", None]]
    for step in range(4):
        out = []
        for side in sides:
            m, dev, cache = side
            if step == 0:
                cache = tm.init_decode_state(cfg, 2, 68, dev)
                batch = {"tokens": torch.as_tensor(toks, device=dev)}
                logits, side[2] = tm.prefill(m, cfg, batch, cache)
            else:
                tok = torch.as_tensor(toks[:, step:step + 1], device=dev)
                logits, side[2] = tm.decode_step(m, cfg, tok, cache)
            out.append(logits.cpu().double())
        err = (out[0] - out[1]).abs().max() / out[1].abs().max()
        assert float(err) <= LM_F32_TOL, step


def test_lm_load_stats_launches_k3(cuda):
    idx = np.random.default_rng(1).integers(0, 63, (256, 6))
    tss.K3.reset_counts()
    got = load_stats(torch.as_tensor(idx, device=cuda), 64)
    torch.cuda.synchronize()
    assert tss.K3.launches == 1
    assert got.dtype == torch.int32
    assert np.array_equal(got.cpu().numpy(),
                          np.bincount(idx.ravel(), minlength=64))


def _mixer_smoke(family: str):
    base = "rwkv6-1.6b" if family == "rwkv6" else "zamba2-1.2b"
    cfg = dataclasses.replace(get_smoke_config(base), dtype="float32")
    if family == "mamba2":
        cfg = dataclasses.replace(cfg, family="mamba2", name="mamba2-smoke")
    return cfg


# the JAX package's bound between a chunked form and its recurrence
MIXER_RECURRENCE_TOL = 2e-4


@pytest.mark.parametrize("family", ["rwkv6", "mamba2", "hybrid"])
def test_lm_mixers_match_the_cpu_and_the_recurrence(cuda, family):
    """Each recurrent family's smoke config in float32: prefill and three
    decode steps on the card within ``LM_F32_TOL`` of the CPU; the chunked
    prefill's states equal those of per-token ``decode_step`` from a fresh
    state over the same prompt, on the card."""
    cfg = _mixer_smoke(family)
    assert cfg.family == family
    model = tm.init_params(cfg, seed=0, device=cuda)
    host = tm.LM(cfg, "cpu")
    host.load_state_dict(model.state_dict())
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    plen = 17
    states = {}
    for m, dev in ((model, cuda), (host, "cpu")):
        cache = tm.init_decode_state(cfg, 2, 20, dev)
        logits, cache = tm.prefill(m, cfg, {"tokens": torch.as_tensor(
            toks[:, :plen], device=dev)}, cache)
        out = [logits.cpu().double()]
        if dev == cuda:
            states = {k: v.clone() for k, v in cache.items() if k != "pos"}
        for t in range(plen, 20):
            logits, cache = tm.decode_step(m, cfg, torch.as_tensor(
                toks[:, t:t + 1], device=dev), cache)
            out.append(logits.cpu().double())
        if dev == cuda:
            card = out
    for i, (got, want) in enumerate(zip(card, out)):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= LM_F32_TOL, i
    rec = tm.init_decode_state(cfg, 2, 20, cuda)
    for t in range(plen):
        _, rec = tm.decode_step(model, cfg, torch.as_tensor(
            toks[:, t:t + 1], device=cuda), rec)
    recurrent = [k for k in states if k not in ("k", "v")]
    assert recurrent
    for k in recurrent:
        torch.testing.assert_close(states[k], rec[k],
                                   rtol=MIXER_RECURRENCE_TOL,
                                   atol=MIXER_RECURRENCE_TOL)


# float32 training, card against CPU: the CPU tests' bounds against the JAX
# package (the loss relative, each leaf's gradient against its largest |g|)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4


def _train_grads(model, cfg, batch, remat):
    state = ttr.init_train_state(model)
    loss, _ = ttr.train_loss(model, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    return float(loss.detach()), [g.cpu().double() for g in grads]


def _without_sync(fn, *args):
    """``fn(*args)`` on the card under ``torch.cuda.set_sync_debug_mode``
    "error", which raises on the synchronising calls (reads back to the
    host) it detects."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _grad_gap(got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want) if b.abs().max() > 0)


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x22b",
                                  "rwkv6-1.6b", "zamba2-1.2b"])
def test_lm_train_step_matches_the_cpu(cuda, arch):
    """A float32 smoke config (dense, MoE, rwkv6, hybrid): the loss and
    gradients under ``remat="full"`` on the card within the bounds of the
    CPU's, ``"full"`` within them of ``"none"`` and ``"dots"`` on the
    card, and one train step's loss and ``grad_norm`` on both, the card's
    step with no synchronising call."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = tm.init_params(cfg, seed=0, device=cuda)
    host = tm.LM(cfg, "cpu")
    host.load_state_dict(model.state_dict())
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=5)
    bc, bh = pipe.torch_batch(0, cuda), pipe.torch_batch(0, "cpu")
    lc, gc = _train_grads(model, cfg, bc, "full")
    lh, gh = _train_grads(host, cfg, bh, "full")
    assert abs(lc - lh) <= TRAIN_LOSS_TOL * abs(lh)
    assert _grad_gap(gc, gh) <= TRAIN_GRAD_TOL
    for remat in ("none", "dots"):
        ln, gn = _train_grads(model, cfg, bc, remat)
        assert abs(lc - ln) <= TRAIN_LOSS_TOL * abs(ln), remat
        assert _grad_gap(gc, gn) <= TRAIN_GRAD_TOL, remat
    out = []
    for m, b in ((model, bc), (host, bh)):
        step = ttr.build_train_step(cfg, base_lr=1e-2, warmup=1,
                                    total_steps=4, remat="full")
        state = ttr.init_train_state(m)
        state, metrics = (_without_sync(step, state, b)
                          if b["tokens"].is_cuda else step(state, b))
        assert metrics["loss"].device == b["tokens"].device
        assert int(state.step) == 1
        out.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})
    for k in out[1]:
        assert abs(out[0][k] - out[1][k]) <= TRAIN_LOSS_TOL * abs(out[1][k])


def _state_tensors(state):
    return [*state.model.parameters(), state.opt.step,
            *state.opt.m.values(), *state.opt.v.values(), state.step]


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        a, b = (t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
                for t in (a, b))
    return torch.equal(a, b)


def test_checkpoint_of_a_cuda_state_round_trips(cuda, tmp_path):
    """A train state on the card (bfloat16 moments) saved asynchronously,
    stepped in place while the write is in flight, then restored onto the
    card and onto the CPU: each time bitwise the state as saved."""
    from repro_torch.checkpoint import Checkpointer
    cfg = get_smoke_config("smollm-135m")
    state = ttr.init_train_state(tm.init_params(cfg, seed=0, device=cuda),
                                 opt_state_dtype=torch.bfloat16)
    step = ttr.build_train_step(cfg, base_lr=1e-2, warmup=2, total_steps=10,
                                remat="full")
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=11)
    for i in range(2):
        state, _ = step(state, pipe.torch_batch(i, cuda))
    want = [t.detach().clone() for t in _state_tensors(state)]
    ckpt = Checkpointer(tmp_path)
    ckpt.save(2, state, async_=True)
    state, _ = step(state, pipe.torch_batch(2, cuda))
    ckpt.wait()
    assert ckpt.latest_step() == 2
    for device in (cuda, torch.device("cpu")):
        got = _state_tensors(ckpt.restore(like=state, shardings=device))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.device.type == device.type and a.dtype == b.dtype
            assert _same_bits(a, b)
    assert next(ckpt.restore(like=state).model.parameters()).is_cuda


# ---------------------------------------------------------------------------
# the mesh ring sweep over NCCL at world size 1 (the card is one rank)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: NCCL runs on the card")
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("agg", ["minmax", "median"])
def test_mesh_at_world_size_1_matches_local_executor(nccl_mesh, monkeypatch,
                                                     agg):
    """V.1 through ``DistributedExecutor`` on a one-rank NCCL mesh: the
    answers bitwise the local Executor's over the same padded capacities,
    and every K1/K2 ring step equal to its plain version."""
    from repro_torch.core.distributed import DistributedExecutor
    db, schema = trel.make_tpch_db(scale=2000, seed=1, device="cuda")
    plan = tcore.plan_query(trel.tpch_v1_query(agg), schema)
    dex = DistributedExecutor(schema, nccl_mesh)
    assert dex.device == torch.device("cuda", 0)
    sharded = dex.shard_db(db)
    seen = []
    for mod, attr, name in ((tsj, "semi_join_cuda", "semi_join"),
                            (tfj, "freq_join_cuda", "freq_join")):
        def keep(*args, _wrapped=getattr(mod, attr), _name=name, **kw):
            out = _wrapped(*args, **kw)
            seen.append((_name, args, out))
            return out
        monkeypatch.setattr(mod, attr, keep)
    got = dex.compile(plan)(sharded)
    monkeypatch.undo()
    assert seen
    for name, (pk, pf, ck, cf), out in seen:
        plain = tsj.semi_join_plain if name == "semi_join" \
            else tfj.freq_join_plain
        assert torch.equal(out, plain(pk, pf, ck, cf)), name
    host = {r: db[r].pad_to(sharded[r].capacity) for r in db}
    want = tcore.Executor(host, schema).compile(plan)(host)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


def test_mesh_service_at_world_size_1_matches_local_service(nccl_mesh):
    """V.1 as SQL through ``QueryService(mesh=...)`` on a one-rank NCCL
    mesh, batched and alone: bitwise the local service's (one shard pads as
    one device does), with K1 and K2 launched in the ring programs."""
    from repro_torch.service import QueryService
    db, schema = trel.make_tpch_db(scale=2000, seed=1, device="cuda")
    msvc = QueryService(db, schema, mesh=nccl_mesh)
    lsvc = QueryService(db, schema)
    for k in (tsj.K1, tfj.K2):
        k.reset_counts()
    batch = msvc.submit_many(SERVE_V1)
    launched = (tsj.K1.launches, tfj.K2.launches)
    assert all(n > 0 for n in launched), launched
    want = lsvc.submit_many(SERVE_V1)
    for sql, got, w in zip(SERVE_V1, batch, want):
        assert got.ok and w.ok, (got.error, w.error)
        host = {k: v.cpu() for k, v in w.values.items()}
        _values_equal(got.values, host)
        _values_equal(msvc.submit(sql).values, host)
    spans = [sp.name for sp in batch[0].stats.trace.walk()]
    assert "ring_sweep" in spans, spans
    assert msvc.metrics_v2()["gauges"]["mesh_devices"] == 1


@pytest.mark.parametrize("arch,placed", [("smollm-135m", True),
                                         ("rwkv6-1.6b", False),
                                         ("mixtral-8x22b", True)])
def test_lm_mesh_step_at_world_size_1_is_the_local_step(nccl_mesh, arch,
                                                        placed):
    """The smoke config's train step on a one-rank NCCL (1, 1) host mesh,
    its state placed by the logical rules (DTensors of the whole arrays),
    bitwise the one-device step's: losses and every tensor of the state.
    A dense or MoE model computes on its placed weights (its blocks'
    recomputation runs on autograd's device thread; a MoE layer's blocks
    are the whole buffer and weights, on which it runs the one-device
    ops); rwkv6 takes the gather path (whole weights, all-reduced
    gradients)."""
    from repro_torch.distributed import use_mesh
    from repro_torch.launch.inputs import state_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.step import TP_FAMILIES
    cfg = get_smoke_config(arch)
    assert (cfg.family in TP_FAMILIES) == placed
    mesh = make_host_mesh()
    step = ttr.build_train_step(cfg, microbatches=2, base_lr=1e-2, warmup=2,
                                total_steps=10, remat="full",
                                compress_grads=True)
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=11)
    local = ttr.init_train_state(tm.init_params(cfg, seed=0, device="cuda"))
    placed = ttr.place_train_state(
        ttr.init_train_state(tm.init_params(cfg, seed=0, device="cuda")),
        state_shardings(cfg, mesh))
    for i in range(3):
        batch = pipe.torch_batch(i, "cuda")
        local, want = step(local, batch)
        with use_mesh(mesh):
            placed, got = step(placed, batch)
        assert _same_bits(got["loss"], want["loss"])
        assert _same_bits(got["grad_norm"], want["grad_norm"])
    got, want = _state_tensors(placed), _state_tensors(local)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        assert a.is_cuda and _same_bits(a, b)


def test_lm_placed_serving_at_world_size_1_is_the_local_run(nccl_mesh):
    """smollm-135m at full width, its bfloat16 weights and caches placed
    by ``serving_shardings`` on a one-rank NCCL (1, 1) host mesh: a
    prefill of 4 × 16 tokens and 3 decode steps fed the greedy tokens
    bitwise the one-device run on the same bfloat16 weights (logits,
    tokens, caches), and so are ``greedy_generate``'s tokens."""
    _placed_serving_is_the_local_run(get_config("smollm-135m"))


def test_lm_placed_moe_serving_at_world_size_1_is_the_local_run(nccl_mesh):
    """The same for Moonlight-16B-A3B at its published widths and 2 of
    its 48 layers: the placed MoE layer (64 experts, top 6, the shared
    expert) on the one-rank mesh, whose rows no batch axis cuts, bitwise
    the one-device ``moe_apply``."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=2)
    _placed_serving_is_the_local_run(cfg)


def _placed_serving_is_the_local_run(cfg) -> None:
    from repro_torch.distributed import use_mesh
    from repro_torch.launch.inputs import (
        batch_shardings,
        place_cache,
        place_params,
        serving_shardings,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm_serving import greedy_generate, greedy_tokens
    rows, max_len = 4, 24
    mesh = make_host_mesh()
    master = tm.init_params(cfg, seed=0, device="cuda")
    params, caches = serving_shardings(cfg, mesh, rows, max_len)
    placed = place_params(master, params)
    local = tm.LM(cfg, "meta")
    local.load_state_dict({n: w.to(torch.bfloat16) for n, w in
                           master.state_dict().items()}, assign=True)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (rows, 16)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device="cuda")

    def serve(model, cache, batch, scope):
        out = []
        with scope():
            logits, cache = tm.prefill(model, cfg, batch, cache)
            for _ in range(3):
                out.append((logits.full_tensor() if hasattr(
                    logits, "full_tensor") else logits, greedy_tokens(logits)))
                logits, cache = tm.decode_step(model, cfg, out[-1][1], cache)
        return out, cache

    batch = {"tokens": batch_shardings(mesh, {"tokens": tokens})[
        "tokens"].distribute(tokens)}
    got, got_cache = serve(
        placed, place_cache(tm.init_decode_state(cfg, rows, max_len), caches),
        batch, lambda: use_mesh(mesh))
    want, want_cache = serve(local, tm.init_decode_state(cfg, rows, max_len),
                             {"tokens": tokens}, contextlib.nullcontext)
    for (a, ta), (b, tb) in zip(got, want):
        assert a.dtype == torch.bfloat16 and _same_bits(a, b)
        assert torch.equal(ta, tb)
    for name in ("k", "v"):
        assert _same_bits(got_cache[name].full_tensor(), want_cache[name])
    with use_mesh(mesh):
        greedy = greedy_generate(placed, cfg, prompts, 4)
    np.testing.assert_array_equal(greedy,
                                  greedy_generate(local, cfg, prompts, 4))


@pytest.mark.parametrize("mode", ["sum", "any"])
def test_ring_steps_over_child_blocks_match_one_call(cuda, mode):
    """One rank's ring steps over P = 4 child blocks, folded as the ring
    folds them, equal the one-call K1/K2 bitwise (int32 wrap included),
    and so do the presort steps."""
    from repro_torch.core import distributed as tdist
    rng = np.random.default_rng(7)
    pk = torch.tensor(rng.integers(-2, 5000, 100_003).astype(np.int32),
                      device=cuda)
    pf = torch.tensor(rng.integers(0, 4099, 100_003).astype(np.int32),
                      device=cuda)
    ck = torch.tensor(rng.integers(-2, 5000, 40_000).astype(np.int32),
                      device=cuda)
    cf = torch.tensor(rng.integers(0, 1 << 20, 40_000).astype(np.int32),
                      device=cuda)
    one = tops.freq_join(pk, pf, ck, cf, mode=mode)
    unit = torch.ones_like(pf)
    for presort in (False, True):
        mult = torch.zeros_like(pf)
        for ckb, cfb in zip(ck.view(4, -1), cf.view(4, -1)):
            if presort:
                m = tdist.presort_multiplier(
                    pk, *tdist.presort_payload(ckb, cfb, mode, pf.dtype),
                    pf.dtype)
            else:
                m = tdist._local_multiplier(pk, ckb, cfb, mode, unit)
            mult = tdist.accumulate(mult, m, mode)
        if mode == "any":
            mult = (mult > 0).to(pf.dtype)
        assert torch.equal(pf * mult, one), presort


def _mesh_rank(rank: int, world: int, store: str) -> None:
    """One rank of ``test_mesh_over_every_card_matches_local_executor``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import DistributedExecutor
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        shapes = [((world,), ("data",))]
        if world % 2 == 0 and world > 2:
            shapes.append(((2, world // 2), ("pod", "data")))
        db, schema = trel.make_tpch_db(scale=2000, seed=1, device="cuda")
        for shape, names in shapes:
            mesh = DeviceMesh("cuda", torch.arange(world).reshape(shape),
                              mesh_dim_names=names)
            for presort in (False, True):
                dex = DistributedExecutor(schema, mesh, data_axes=names,
                                          presort=presort)
                sharded = dex.shard_db(db)
                host = {r: db[r].pad_to(dex.shard_capacity(db[r].capacity))
                        for r in db}
                for agg in ("minmax", "count", "median"):
                    plan = tcore.plan_query(trel.tpch_v1_query(agg), schema)
                    got = dex.compile(plan)(sharded)
                    want = tcore.Executor(host, schema).compile(plan)(host)
                    for k in want:
                        assert torch.equal(got[k], want[k]), (shape, agg, k)
    finally:
        dist.destroy_process_group()


def test_mesh_over_every_card_matches_local_executor(cuda, tmp_path):
    """V.1 through ``DistributedExecutor`` with one NCCL rank on each card
    (a 1-D ring, and the nested 2 × n/2 ring where the count is even and
    above 2), presort off and on: every rank's answers bitwise the local
    Executor's over the same padded capacities.  Needs two cards or more."""
    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA GPUs or more: NCCL puts one rank on a "
                    "card")
    mp.start_processes(_mesh_rank, args=(world, str(tmp_path / "store")),
                       nprocs=world, start_method="spawn")
