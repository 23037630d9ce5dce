"""64-bit frequencies: the port against the JAX package under x64.

An ``Executor`` with int64 or float64 frequencies is the port's counterpart
of the JAX package run inside ``with jax.enable_x64(True):`` with
``freq_dtype="int64"`` or ``"float64"``: keys pack in int64, integer
aggregates accumulate in int64, AVG and the median weights in float64.
Every reference call below runs inside that context manager only, so no
x64 setting leaks into other tests of the same worker.  Integer results,
MIN/MAX/MEDIAN picks, ``steps`` and ``peak_tuples`` must be equal bit for
bit and in the reference's dtypes; float64 sums of integer values are
exact, so they are held bitwise too, and real-valued float64 sums within
the bound each test states.  The CUDA kernels' 64-bit instances are held
against these plain versions on the card (``test_torch_gpu.py``).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data.relational as jrel
from repro.core import aggregates as jagg
from repro.kernels import ops as jops
from repro.tables import table as jtab
import repro_torch.core as tcore
import repro_torch.data.relational as trel
from repro_torch.core.aggregates import grouped_aggregate, scalar_aggregate
from repro_torch.kernels import freq_join as tfj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_sum as tss
from repro_torch.tables import table as ttab
from test_torch_baselines import FIG6_GRAPH_SHA256
from test_torch_executor import V1_AGGS, _assert_answers_equal, _carry

jax.config.update("jax_platform_name", "cpu")

I64 = np.iinfo(np.int64)
BACKENDS = ["xla", "pallas"]
WIDE = {"int64": (jnp.int64, torch.int64),
        "float64": (jnp.float64, torch.float64)}


def _x64(fn, *args, **kw):
    """``fn`` of the JAX package under x64, its arrays read out to numpy."""
    with jax.enable_x64(True):
        out = fn(*args, **kw)
        return jax.tree_util.tree_map(np.asarray, out)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_pack_keys_int64_matches_reference(ncols):
    """Single-column keys widen, mixed-radix keys pack in int64 and may
    pass 2^31 without wrapping."""
    rng = np.random.default_rng(ncols)
    doms = [70_000, 90_000, 50][:ncols]
    cols = [rng.integers(0, d, 300).astype(np.int32) for d in doms]

    def ref():
        return jtab.pack_keys([jnp.asarray(c) for c in cols], doms)
    want = _x64(ref)
    got = ttab.pack_keys([torch.tensor(c) for c in cols], doms,
                         ttab.int_dtype(True))
    _eq(got, want)
    if ncols > 1:
        assert int(got.max()) > 2**31


def _np_hash_combine64(cols):
    """numpy oracle of the hash-combine fallback in int64 arithmetic with
    the constant 0x9E3779B97F4A7C15 wrapped to int64."""
    phi = np.int64(0x9E3779B97F4A7C15 - (1 << 64))
    key = cols[0].astype(np.int64)
    with np.errstate(over="ignore"):
        for c in cols[1:]:
            key = key ^ (c.astype(np.int64) + phi + (key << 6) + (key >> 2))
    return key


def test_pack_keys_int64_hash_fallback_matches_numpy_oracle():
    """Reference fault R3 bites in 64 bits too (the JAX package's constant
    overflows int64), so the int64 fallback is held against numpy."""
    rng = np.random.default_rng(10)
    cols = [rng.integers(-(1 << 31), (1 << 31) - 1, 500).astype(np.int32)
            for _ in range(3)]
    got = ttab.pack_keys([torch.tensor(c) for c in cols], [None, 5, None],
                         torch.int64)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _np_hash_combine64(cols))


def test_live_count_is_int64_when_wide():
    jdb, _ = jrel.make_graph_db(30, 200, seed=1)
    tdb = _carry(jdb)
    want = _x64(lambda: jdb["edge"].live_count())
    _eq(tdb["edge"].live_count(wide=True), want)
    assert tdb["edge"].live_count().dtype == torch.int32
    wide = tdb["edge"].with_freq(tdb["edge"].freq.to(torch.float64))
    assert wide.live_count().dtype == torch.int64


# ---------------------------------------------------------------------------
# aggregates
# ---------------------------------------------------------------------------
def test_count_above_int32_is_exact():
    got = scalar_aggregate(tcore.Agg("count"), {},
                           torch.tensor([2**31 - 1, 5], dtype=torch.int64),
                           False)
    assert got.dtype == torch.int64 and int(got) == 2147483652


AGGS = [("count", None, False), ("sum", "i", False), ("sum", "f", False),
        ("avg", "i", False), ("avg", "f", False), ("min", "f", False),
        ("max", "i", False), ("median", "f", False), ("median", "i", False),
        ("count", "i", True), ("sum", "i", True), ("sum", "f", True),
        ("avg", "f", True), ("min", "f", True)]


@pytest.mark.parametrize("func,var,distinct", AGGS,
                         ids=[f"{f}-{v}{'-distinct' if d else ''}"
                              for f, v, d in AGGS])
@pytest.mark.parametrize("fdt", ["int64", "float64"])
@pytest.mark.parametrize("dedup", [False, True])
def test_scalar_aggregates_match_reference(func, var, distinct, fdt, dedup):
    """COUNT and SUM past 2^31 (frequencies up to 2^40), COUNT(DISTINCT) in
    int64, AVG in float64, the median's weights in float64: value and
    dtype as the reference's."""
    rng = np.random.default_rng(len(func) + 7 * distinct)
    n = 500
    cols = {"i": rng.integers(-1000, 1000, n).astype(np.int32),
            "f": rng.normal(size=n).astype(np.float32)}
    cols["i"][::7] = cols["i"][3]           # repeated values for DISTINCT
    freq = rng.integers(0, 1 << 40, n)
    freq[::5] = 0
    freq = freq.astype(np.dtype(fdt))
    jag, tag = jcore.Agg(func, var, distinct), tcore.Agg(func, var, distinct)

    def ref():
        return jagg.scalar_aggregate(
            jag, {k: jnp.asarray(v) for k, v in cols.items()},
            jnp.asarray(freq), dedup)
    want = _x64(ref)
    got = scalar_aggregate(tag, {k: torch.tensor(v) for k, v in cols.items()},
                           torch.tensor(freq), dedup, wide=True)
    assert got.shape == () and got.numpy().dtype == want.dtype
    if want.dtype.kind == "f" and func in ("sum", "avg"):
        # the two packages add in other orders
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12
                                   if want.dtype == np.float64 else 1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


GROUPED = (("count", None), ("sum", "i"), ("avg", "f"), ("min", "f"),
           ("max", "i"), ("median", "f"))


@pytest.mark.parametrize("fdt", ["int64", "float64"])
@pytest.mark.parametrize("dedup", [False, True])
def test_grouped_aggregates_match_reference(fdt, dedup):
    """GROUP BY over two columns whose packed key passes 2^31: group keys
    pack in int64, sums in int64, AVG and the median weights in float64."""
    rng = np.random.default_rng(21)
    n = 700
    cols = {"g": rng.integers(0, 70_000, n).astype(np.int32),
            "h": rng.integers(0, 3, n).astype(np.int32),
            "i": rng.integers(-9, 9, n).astype(np.int32),
            "f": rng.normal(size=n).astype(np.float32)}
    cols["g"][::3] = 69_999
    freq = rng.integers(0, 1 << 36, n)
    freq[::4] = 0
    freq = freq.astype(np.dtype(fdt))
    doms = {"g": 70_000, "h": 3}
    jaggs = tuple(jcore.Agg(f, v) for f, v in GROUPED)
    taggs = tuple(tcore.Agg(f, v) for f, v in GROUPED)

    def ref():
        return jagg.grouped_aggregate(
            ("h", "g"), jaggs, {k: jnp.asarray(v) for k, v in cols.items()},
            jnp.asarray(freq), doms, dedup)
    want_cols, want_valid = _x64(ref)
    got_cols, got_valid = grouped_aggregate(
        ("h", "g"), taggs, {k: torch.tensor(v) for k, v in cols.items()},
        torch.tensor(freq), doms, dedup, wide=True)
    _eq(got_valid, want_valid)
    valid = want_valid
    for name, w in want_cols.items():
        g = got_cols[name].numpy()
        assert g.dtype == w.dtype, name
        if name.startswith("avg"):
            np.testing.assert_allclose(g[valid], w[valid], rtol=1e-12)
        else:
            np.testing.assert_array_equal(g[valid], w[valid], err_msg=name)


@pytest.mark.parametrize("wdt", [np.int64, np.float64])
def test_weighted_percentile_float64_weights_match_reference(wdt):
    """Weights past float32's 24-bit mantissa: the float64 accumulation
    picks the reference's value where a float32 one could not."""
    rng = np.random.default_rng(4)
    vals = rng.normal(size=2000).astype(np.float32)
    w = rng.integers(0, 1 << 45, 2000).astype(wdt)
    w[::9] = 0
    for q in (0.1, 0.5, 0.9):
        want = _x64(lambda: jops.weighted_percentile(jnp.asarray(vals),
                                                     jnp.asarray(w), q))
        got = tops.weighted_percentile(torch.tensor(vals), torch.tensor(w), q,
                                       wide=True)
        assert got.shape == () and got.numpy().dtype == want.dtype
        assert float(got) == float(want)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
def _wide_join_inputs(rng, np_, nc, kdt, fdt):
    """Keys around 0 and around 2^32 (so keys equal in their low 32 bits
    meet, for int64 keys), int64's or int32's extremes and −1 on both
    sides; int64 frequencies over the whole range, so sums wrap past 2^63;
    float64 frequencies integer-valued."""
    info = np.iinfo(kdt)
    pk = rng.integers(-20, 20, np_).astype(kdt)
    ck = rng.integers(-20, 20, nc).astype(kdt)
    if kdt == np.int64:
        pk[::3] += np.int64(1) << 32
        ck[::5] += np.int64(1) << 32
    pk[:3] = [info.min, info.max, -1]
    ck[:3] = [info.max, -1, info.min]
    if fdt == np.int64:
        pf = rng.integers(I64.min, I64.max, np_)
        cf = rng.integers(I64.min, I64.max, nc)
    else:
        pf = rng.integers(0, 4, np_).astype(fdt)
        cf = rng.integers(-2, 4, nc).astype(fdt)
    return pk, pf, ck, cf


KEY_FREQ = [(np.int64, np.int64), (np.int64, np.float64),
            (np.int32, np.int64), (np.int32, np.float64)]


@pytest.mark.parametrize("np_,nc", [(1000, 37), (1024, 1024), (37, 700)])
@pytest.mark.parametrize("kdt,fdt", KEY_FREQ)
@pytest.mark.parametrize("mode", ["sum", "any"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_wide_freq_join_plain_matches_reference(np_, nc, kdt, fdt, mode,
                                                backend):
    rng = np.random.default_rng([np_, nc, len(mode)])
    arrays = _wide_join_inputs(rng, np_, nc, kdt, fdt)
    want = _x64(lambda: jops.freq_join(*map(jnp.asarray, arrays), mode=mode,
                                       backend=backend))
    got = tops.freq_join(*map(torch.tensor, arrays), mode=mode)
    _eq(got, want)


def test_wide_freq_join_real_float64_within_bound():
    """Real-valued float64 frequencies: the plain version differences a
    float64 prefix sum, so each result is within 4·eps·Σ|cf|·|pf| of the
    reference's."""
    rng = np.random.default_rng(11)
    pk, _, ck, _ = _wide_join_inputs(rng, 900, 800, np.int64, np.float64)
    pf, cf = rng.random(900) * 3, rng.random(800) * 3 - 1
    want = _x64(lambda: jops.freq_join(*map(jnp.asarray, (pk, pf, ck, cf))))
    got = tops.freq_join(*map(torch.tensor, (pk, pf, ck, cf))).numpy()
    bound = 4 * np.finfo(np.float64).eps * np.abs(cf).sum() * np.abs(pf)
    assert got.dtype == np.float64
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("n", [1, 100, 2048, 3 * 2048 + 5])
@pytest.mark.parametrize("kdt", [np.int32, np.int64])
@pytest.mark.parametrize("vdt", [np.int64, np.float64])
@pytest.mark.parametrize("backend", BACKENDS)
def test_wide_segment_sum_plain_matches_reference(n, kdt, vdt, backend):
    """int64 sums wrap past 2^63 as the reference's do; int64 keys of runs
    that differ only above bit 31."""
    rng = np.random.default_rng([n, len(backend)])
    keys = np.sort(rng.integers(0, max(2, n // 8), n)).astype(kdt)
    if kdt == np.int64:
        keys = np.sort(keys % 5 << 32)
    vals = (rng.integers(I64.min, I64.max, n) if vdt == np.int64
            else rng.integers(-9, 9, n).astype(vdt))
    want = _x64(lambda: jops.segment_sum_sorted(jnp.asarray(keys),
                                                jnp.asarray(vals),
                                                backend=backend))
    got = tops.segment_sum_sorted(torch.tensor(keys), torch.tensor(vals))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("vdt", [np.int64, np.float64])
def test_wide_group_by_sum_matches_reference(vdt):
    rng = np.random.default_rng(5)
    keys = (rng.integers(-20, 20, 3000) << 33).astype(np.int64)
    vals = rng.integers(-3, 5, 3000).astype(vdt)
    want = _x64(lambda: jops.group_by_sum(jnp.asarray(keys),
                                          jnp.asarray(vals)))
    got = tops.group_by_sum(torch.tensor(keys), torch.tensor(vals))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("side", ["shared", "child", "parent"])
@pytest.mark.parametrize("fdt", [torch.int64, torch.float64])
def test_table_words_of_the_wide_layout(side, fdt):
    """16-byte {key, value} slots (8-byte bare keys on the child side in
    any mode) and the side slot, in whole 16-byte stores, more than the
    narrow layout's; ``prepare_call`` sizes the table from the frequencies'
    width; the widest shared table fits a block's 48 KiB."""
    path = tfj.JoinPath(side, 1024)
    for mode in ("sum", "any"):
        narrow = tfj.table_words(path, mode)
        wide = tfj.table_words(path, mode, wide=True)
        assert wide > narrow or side == "shared"
        per_slot = 2 if mode == "any" and side == "child" else 4
        assert side == "shared" or wide == -(-per_slot * 1025 // 4) * 4
        _, table, out = tfj.prepare_call(torch.zeros(3000, dtype=fdt), 3000,
                                         mode, path)
        assert (table is None) == (side == "shared")
        assert table is None or table.numel() == wide
        assert out.dtype == fdt
    slots = tfj.table_slots(tfj.SHARED_MAX_ROWS)
    assert 4 * tfj.table_words(tfj.JoinPath("child", slots), "sum",
                               wide=True) <= 48 * 1024


@pytest.mark.parametrize("n,words", [
    (tss.TILE, 0), (tss.TILE + 1, 4 + 4 * 2), (3 * tss.TILE + 5, 6 + 4 * 4),
    (8_000_000, 3910 + 4 * 3907)])
def test_segment_sum_wide_scratch(n, words):
    """64-bit values: the counter and a spare word, a 4-byte status per
    tile padded to a whole 8 bytes, then an 8-byte prefix and aggregate per
    tile."""
    assert tss.scratch_words(n, wide=True) == words
    for dt in (torch.int64, torch.float64):
        _, _, scratch = tss.prepare_call(torch.zeros(n, dtype=dt))
        assert (scratch is None and words == 0) or scratch.numel() == words


# ---------------------------------------------------------------------------
# the Executor
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tpch():
    jdb, jschema = jrel.make_tpch_db(scale=150, seed=3)
    tschema = trel.make_tpch_db(scale=150, seed=3, device="cpu")[1]
    return jdb, jschema, _carry(jdb), tschema


def _run_both(jdb, jschema, tdb, tschema, jquery, tquery, fdt, mode,
              use_fkpk=False, compiled=False, **kw):
    jdt, tdt = WIDE[fdt]

    def ref():
        plan = jcore.plan_query(jquery, jschema, mode=mode,
                                use_fkpk=use_fkpk)
        ex = jcore.Executor(jdb, jschema, freq_dtype=jdt, **kw)
        out = ex.compile(plan)(jdb) if compiled else ex.execute(plan)
        stats = out.pop("__stats__", None)
        return out, stats
    plan = tcore.plan_query(tquery, tschema, mode=mode, use_fkpk=use_fkpk)
    ex = tcore.Executor(tdb, tschema, freq_dtype=tdt, **kw)
    with jax.enable_x64(True):
        try:
            want, wstats = ref()
        except jcore.MaterialisationLimit as jerr:
            # a guard trip: the same message, after the same steps
            with pytest.raises(tcore.MaterialisationLimit) as terr:
                ex.execute(plan)
            assert str(terr.value) == str(jerr)
            return None
        want = {k: np.asarray(v) for k, v in want.items()}
    got = ex.compile(plan)(tdb) if compiled else ex.execute(plan)
    gstats = got.pop("__stats__", None)
    _assert_answers_equal(got, want)
    if wstats is not None:
        assert gstats.steps == wstats.steps
        assert gstats.peak_tuples == wstats.peak_tuples
    return got


V1_PLANS = [("auto", False, False), ("auto", False, True),
            ("opt_plus", False, False), ("opt_plus", False, True),
            ("ref", False, False), ("opt", False, False),
            ("opt", True, False)]


@pytest.mark.parametrize("mode,use_fkpk,compiled", V1_PLANS,
                         ids=[f"{m}{'-fkpk' if f else ''}"
                              f"{'-compiled' if c else ''}"
                              for m, f, c in V1_PLANS])
@pytest.mark.parametrize("agg", V1_AGGS)
@pytest.mark.parametrize("fdt", ["int64", "float64"])
def test_v1_in_64_bits_matches_reference(tpch, mode, use_fkpk, compiled, agg,
                                         fdt):
    """V.1 under every plan class: COUNT in int64 (float64), MIN/MAX and
    MEDIAN picks in the value column's float32, steps and peaks as the
    reference's."""
    jdb, jschema, tdb, tschema = tpch
    got = _run_both(jdb, jschema, tdb, tschema, jrel.tpch_v1_query(agg),
                    trel.tpch_v1_query(agg), fdt, mode, use_fkpk, compiled)
    if agg == "count":
        assert got["count(*)"].dtype == WIDE[fdt][1]


GRAPH_QUERIES = ("path_3", "path_4", "path_5", "tree_1", "tree_2", "tree_3")


def _graph_query(rel, name):
    kind, k = name.split("_")
    return rel.path_query(int(k)) if kind == "path" \
        else rel.tree_query(int(k))


@pytest.mark.parametrize("name", GRAPH_QUERIES)
@pytest.mark.parametrize("mode", ["ref", "opt", "opt_plus"])
def test_table2_queries_in_float64_match_reference(name, mode):
    """``benchmarks/graph_counting.py``'s queries with float64 frequencies,
    cut to a 300-node graph and a guard of 5M tuples (the benchmark's
    20M at its 20k-node graph): COUNT(*) equal in float64, past 2^31 for
    the trees, or the guard trips at the same join with the same message
    (Ref beyond path-3)."""
    jdb, jschema = jrel.make_graph_db(300, 3000, seed=0)
    tschema = trel.make_graph_db(300, 3000, seed=0, device="cpu")[1]
    got = _run_both(jdb, jschema, _carry(jdb), tschema,
                    _graph_query(jrel, name), _graph_query(trel, name),
                    "float64", mode, oom_guard=5_000_000)
    assert (got is None) == (mode == "ref" and name != "path_3")
    if got is not None:
        assert got["count(*)"].dtype == torch.float64
        assert (float(got["count(*)"]) > 2**31) == name.startswith("tree")


@pytest.mark.parametrize("mode", ["ref", "opt", "opt_plus"])
def test_fig6_path4_count_is_not_wrapped(mode):
    """Fig. 6 at ``benchmarks/materialisation.py``'s sizes with int64
    frequencies: path-4's COUNT is 2704172672 on this graph (its int32 wrap
    is −1590794624), Opt's peak and Ref's guard trip as the reference's."""
    db, schema = trel.make_graph_db(5000, 60000, seed=2, device="cpu")
    src, dst = (db["edge"].columns[c].numpy() for c in ("src", "dst"))
    if hashlib.sha256(src.tobytes() + dst.tobytes()).hexdigest() != \
            FIG6_GRAPH_SHA256:
        pytest.skip("this numpy draws another zipf graph from the seed")
    jdb, jschema = jrel.make_graph_db(5000, 60000, seed=2)
    guard = 50_000_000
    if mode == "ref":
        with jax.enable_x64(True):
            with pytest.raises(jcore.MaterialisationLimit) as jerr:
                jcore.Executor(jdb, jschema, freq_dtype=jnp.int64,
                               oom_guard=guard).execute(jcore.plan_query(
                                   jrel.path_query(4), jschema, mode="ref"))
        with pytest.raises(tcore.MaterialisationLimit) as terr:
            tcore.Executor(db, schema, freq_dtype=torch.int64,
                           oom_guard=guard).execute(tcore.plan_query(
                               trel.path_query(4), schema, mode="ref"))
        assert str(terr.value) == str(jerr.value)
        return
    got = _run_both(jdb, jschema, db, schema, jrel.path_query(4),
                    trel.path_query(4), "int64", mode, oom_guard=guard)
    assert got is not None
    assert got["count(*)"].dtype == torch.int64
    assert int(got["count(*)"]) == 2704172672
    if mode == "opt_plus":
        out = tcore.Executor(db, schema, freq_dtype=torch.int64).compile(
            tcore.plan_query(trel.path_query(4), schema, mode="opt_plus"))(db)
        assert int(out["count(*)"]) == 2704172672
