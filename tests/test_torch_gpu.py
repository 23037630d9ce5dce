"""The port's CUDA kernels and Executor on a GPU (marked ``gpu``).

Every test skips without a CUDA device; on one, run them with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.  Each
kernel is held against its plain PyTorch version on the same card tensors
(integer-valued inputs, so float32 results are exact too), and the slice's
queries on the GPU against the same queries on the CPU.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.data.relational as trel
from repro_torch.kernels import freq_join as tfj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_sum as tss
from repro_torch.kernels import semi_join as tsj
from repro_torch.kernels._build import KernelLaunchError

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
        tss.segment_sum_cuda(k, f.double())
