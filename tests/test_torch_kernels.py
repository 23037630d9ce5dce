"""The port's kernel ops against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.ops`` (backend ``"xla"``
and ``"pallas"`` in interpret mode) and ``repro_torch.kernels.ops``, whose
CPU path is the plain PyTorch version of each CUDA kernel.  int32 results
must be equal bit for bit; float32 results too where the sums are
integer-valued (exact in float32), else within the tolerance each test
states.  The CUDA kernels run only on a GPU: ``test_torch_gpu.py`` holds
them against the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.autotune import KernelConfig as JKernelConfig
from repro_torch.kernels import freq_join as tfj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_sum as tss
from repro_torch.kernels import semi_join as tsj
from repro_torch.kernels.autotune import DENSE_DOMAIN_CAP, KernelConfig

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(1024, 1024), (1000, 37), (2048, 4096), (8, 8), (4096, 1000)]
DTYPES = [(np.int32, np.int32), (np.int32, np.float32)]
BACKENDS = ["xla", "pallas"]


def _tables(rng, np_, nc, key_range, kdt, fdt):
    return (rng.integers(0, key_range, np_).astype(kdt),
            rng.integers(0, 4, np_).astype(fdt),
            rng.integers(0, key_range, nc).astype(kdt),
            rng.integers(0, 4, nc).astype(fdt))


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("np_,nc", SHAPES)
@pytest.mark.parametrize("kdt,fdt", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_freq_join_matches_reference(np_, nc, kdt, fdt, backend):
    rng = np.random.default_rng(np_ * 7919 + nc)
    arrays = _tables(rng, np_, nc, 50, kdt, fdt)
    want = jops.freq_join(*_jax(*arrays), mode="sum", backend=backend)
    got = tops.freq_join(*_torch(*arrays), mode="sum")
    _eq(got, want)   # integer-valued sums: bitwise in float32 as well
    _eq(tref.freq_join_ref(*_torch(*arrays)), want)


@pytest.mark.parametrize("np_,nc", SHAPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_semi_join_matches_reference(np_, nc, backend):
    rng = np.random.default_rng(nc * 31 + np_)
    arrays = _tables(rng, np_, nc, 30, np.int32, np.int32)
    want = jops.semi_join(*_jax(*arrays), backend=backend)
    _eq(tops.semi_join(*_torch(*arrays)), want)
    _eq(tref.semi_join_ref(*_torch(*arrays)), want)


@pytest.mark.parametrize("n", [1024, 1000, 4096, 17, 2048])
@pytest.mark.parametrize("vdt", [np.int32, np.float32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_segment_sum_matches_reference(n, vdt, backend):
    """Both packages emit at the LAST row of each run: sums and valid are
    compared bitwise, and per-key totals against the first-row oracle."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, max(2, n // 8), n).astype(np.int32))
    vals = rng.integers(-3, 5, n).astype(vdt)
    want_s, want_v = jops.segment_sum_sorted(*_jax(keys, vals),
                                             backend=backend)
    got_s, got_v = tops.segment_sum_sorted(*_torch(keys, vals))
    _eq(got_s, want_s)
    _eq(got_v, want_v)
    ref_s, ref_first = tref.segment_sum_ref(*_torch(keys, vals))
    np.testing.assert_array_equal(keys[got_v.numpy()],
                                  keys[ref_first.numpy()])
    np.testing.assert_array_equal(got_s.numpy()[got_v.numpy()],
                                  ref_s.numpy()[ref_first.numpy()])


@pytest.mark.parametrize("vdt", [np.int32, np.float32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_group_by_sum_matches_reference(vdt, backend):
    rng = np.random.default_rng(5)
    keys = rng.integers(-20, 20, 3000).astype(np.int32)
    vals = rng.integers(-3, 5, 3000).astype(vdt)
    want = jops.group_by_sum(*_jax(keys, vals), backend=backend)
    got = tops.group_by_sum(*_torch(keys, vals))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("dense_ratio", [0, 4, 1 << 20],
                         ids=["sort", "default", "dense"])
def test_dispatch_paths_match_reference(mode, dense_ratio):
    """Sort and dense-domain paths of the plain FreqJoin against the XLA
    twin under the same crossover, including negative and out-of-range
    child keys (the dense path masks them, it does not clamp them)."""
    rng = np.random.default_rng(11)
    dom = 64
    pk, pf, ck, cf = _tables(rng, 700, 300, dom, np.int32, np.int32)
    ck[:20] = -1
    ck[20:30] = dom
    pk[:5] = -1
    want = jops.freq_join(*_jax(pk, pf, ck, cf), mode=mode, backend="xla",
                          domain=dom,
                          config=JKernelConfig(dense_ratio=dense_ratio))
    got = tops.freq_join(*_torch(pk, pf, ck, cf), mode=mode, domain=dom,
                         config=KernelConfig(dense_ratio=dense_ratio))
    _eq(got, want)


def test_dense_ok_boundary_and_cap():
    cfg = KernelConfig(dense_ratio=4, dense_floor=1 << 10)
    assert cfg.dense_ok(1 << 10, 8)
    assert not cfg.dense_ok((1 << 10) + 1, 8)
    assert not cfg.dense_ok(None, 100)
    assert not KernelConfig(dense_ratio=0).dense_ok(16, 100)
    eager = KernelConfig(dense_ratio=1 << 30, dense_floor=1 << 30)
    assert not eager.dense_ok(DENSE_DOMAIN_CAP, 100)
    assert eager.dense_ok(DENSE_DOMAIN_CAP - 1, 100)


def test_float_frequencies_within_tolerance():
    """Real-valued float32 frequencies: both packages take differences of a
    float32 prefix sum over the whole sorted child, and XLA's and PyTorch's
    cumsums round differently, so a result may move by the prefix's
    rounding: rtol 1e-6 plus atol 4·eps·Σ|cf|·max|pf|."""
    rng = np.random.default_rng(3)
    pk, _, ck, _ = _tables(rng, 2000, 500, 40, np.int32, np.int32)
    pf = rng.random(2000, np.float32)
    cf = rng.random(500, np.float32)
    want = jops.freq_join(*_jax(pk, pf, ck, cf), backend="xla")
    got = tops.freq_join(*_torch(pk, pf, ck, cf))
    atol = 4 * np.finfo(np.float32).eps * np.abs(cf).sum() * np.abs(pf).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=atol)


def test_int32_frequencies_wrap_like_reference():
    """Regression for the pinned dtypes: frequencies that overflow int32
    wrap in the reference's int32 prefix sum and product.  The port keeps
    every step in int32 (PyTorch's cumsum would promote to int64) and
    agrees bit for bit, dtype included."""
    rng = np.random.default_rng(4)
    i32 = np.iinfo(np.int32)
    pk, _, ck, _ = _tables(rng, 500, 900, 16, np.int32, np.int32)
    pf = rng.integers(i32.min, i32.max, 500).astype(np.int32)
    cf = rng.integers(i32.min, i32.max, 900).astype(np.int32)
    want = jops.freq_join(*_jax(pk, pf, ck, cf), backend="xla")
    got = tops.freq_join(*_torch(pk, pf, ck, cf))
    assert got.dtype == torch.int32
    _eq(got, want)
    _eq(tref.freq_join_ref(*_torch(pk, pf, ck, cf)), want)


def test_group_by_sum_sort_is_stable():
    """Regression for the stable sort: within a run, float32 addition order
    decides the rounding (1e8 + 1 − 1e8 is 0 in order, 1 out of order).
    The port sorts stably, as ``jnp.argsort`` does, and matches."""
    keys = np.array([3, 1, 3, 2, 3, 1], np.int32)
    vals = np.array([1e8, 5.0, 1.0, 7.0, -1e8, 2.0], np.float32)
    want = jops.group_by_sum(*_jax(keys, vals), backend="xla")
    got = tops.group_by_sum(*_torch(keys, vals))
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[1].numpy()[-1] == 0.0


@pytest.mark.parametrize("n", [64, 1000])
def test_weighted_percentile_matches_reference(n):
    rng = np.random.default_rng(n)
    vals = rng.normal(size=n).astype(np.float32)
    w = rng.integers(0, 5, n).astype(np.int32)
    for q in (0.1, 0.5, 0.9):
        want = jops.weighted_percentile(*_jax(vals, w), q)
        got = tops.weighted_percentile(*_torch(vals, w), q)
        assert got.shape == () and float(got) == float(want)
        assert float(tref.weighted_percentile_ref(*_torch(vals, w), q)) \
            == float(want)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """Only a CPU tensor routes to the plain version; the launch counts
    move only where a kernel launches."""
    before = (tsj.K1.launches, tfj.K2.launches, tss.K3.launches)
    rng = np.random.default_rng(0)
    t = _torch(*_tables(rng, 100, 50, 10, np.int32, np.int32))
    tops.semi_join(*t)
    tops.freq_join(*t)
    tops.group_by_sum(t[0], t[1])
    assert (tsj.K1.launches, tfj.K2.launches, tss.K3.launches) == before


@pytest.mark.parametrize("kernel", ["semi_join", "freq_join", "segment_sum"])
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    """The kernel wrappers take CUDA tensors only: they raise on anything
    else rather than compute a plain answer."""
    t = _torch(*_tables(np.random.default_rng(1), 10, 10, 5, np.int32,
                        np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "segment_sum":
            tss.segment_sum_cuda(t[0], t[1])
        elif kernel == "semi_join":
            tsj.semi_join_cuda(*t)
        else:
            tfj.freq_join_cuda(*t)


def test_table_slots_power_of_two_at_half_load():
    for nc in (0, 1, 2, 3, 4, 5, 1000, 1 << 20):
        s = tfj.table_slots(nc)
        assert s >= 2 and s & (s - 1) == 0 and s >= 2 * nc
        assert s == 2 or s < 4 * nc


# V.1's join edges at make_tpch_db(scale=100000): (parent rows, child rows)
V1_EDGES = {"n⋉r": (25, 5), "s⋉n": (100_000, 25),
            "ps⋉p": (8_000_000, 2_000_000), "s⋉ps": (100_000, 8_000_000),
            "ps⋉s": (8_000_000, 100_000)}


@pytest.mark.parametrize("np_,nc,side,n_build", [
    (25, 5, "shared", 5), (100_000, 25, "shared", 25),
    (0, 0, "shared", 0), (10, 1024, "shared", 1024),
    (1025, 1025, "child", 1025), (1024, 1025, "parent", 1024),
    (8_000_000, 2_000_000, "child", 2_000_000),
    (100_000, 8_000_000, "parent", 100_000),
    (8_000_000, 100_000, "child", 100_000), (0, 5000, "parent", 0),
])
def test_join_path_builds_on_the_shorter_side(np_, nc, side, n_build):
    """A child of at most SHARED_MAX_ROWS rows is built in shared memory;
    else the table holds the shorter side (the child on a tie), sized
    from that side's length."""
    path = tfj.join_path(np_, nc)
    assert path == tfj.JoinPath(side, tfj.table_slots(n_build))


def test_v1_edges_take_every_path():
    sides = {e: tfj.join_path(*n).side for e, n in V1_EDGES.items()}
    assert sides == {"n⋉r": "shared", "s⋉n": "shared", "ps⋉p": "child",
                     "s⋉ps": "parent", "ps⋉s": "child"}
    # the s⋉ps table: 2^18 slots of the 100k suppliers, not 2^24 of the
    # 8M partsupp rows
    assert tfj.join_path(*V1_EDGES["s⋉ps"]).slots == 1 << 18


@pytest.mark.parametrize("side,mode,words", [
    ("child", "any", 1 * (1024 + 1)), ("child", "sum", 2 * (1024 + 1)),
    ("parent", "any", 2 * (1024 + 1)), ("parent", "sum", 2 * (1024 + 1)),
    ("shared", "any", 0), ("shared", "sum", 0),
])
def test_table_words_hold_every_slot_and_the_side_slot(side, mode, words):
    """8-byte {key, value} slots, or bare 4-byte keys for the child side in
    any mode, plus the side slot of key −1, in whole 16-byte stores."""
    got = tfj.table_words(tfj.JoinPath(side, 1024), mode)
    assert got >= words and got % 4 == 0 and got - words < 4


def test_shared_table_fits_a_blocks_default_shared_memory():
    """The largest child the shared path takes fits the 48 KiB a block may
    use without opting in: 8-byte slots and the side slot."""
    slots = tfj.table_slots(tfj.SHARED_MAX_ROWS)
    assert 4 * tfj.table_words(tfj.JoinPath("child", slots), "sum") \
        <= 48 * 1024


@pytest.mark.parametrize("np_,nc,mode", [
    (25, 5, "any"), (100_000, 25, "sum"), (9000, 3000, "any"),
    (9000, 3000, "sum"), (3000, 9000, "any"), (3000, 9000, "sum"),
])
def test_prepare_call_allocates_the_paths_table(np_, nc, mode):
    """``prepare_call`` takes ``join_path``'s path unless given one, and
    allocates that path's table (``table_words`` int32 words, none on the
    shared path) and an output like the parent frequencies."""
    pf = torch.zeros(np_, dtype=torch.float32)
    for given in (None, tfj.JoinPath("child", tfj.table_slots(nc))):
        path, table, out = tfj.prepare_call(pf, nc, mode, given)
        assert path == (given or tfj.join_path(np_, nc))
        words = tfj.table_words(path, mode)
        if words:
            assert table.dtype == torch.int32 and table.numel() == words
        else:
            assert table is None and path.side == "shared"
        assert out.shape == pf.shape and out.dtype == pf.dtype
