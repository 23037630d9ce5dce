"""The slice end to end: the port's Executor against the JAX package's.

The JAX package's tables are carried into the port with ``db_from_numpy``
(on the CPU), both packages plan structurally equal queries, and the
answers of ``execute`` and ``compile`` must be equal bit for bit: MIN, MAX,
COUNT and MEDIAN, group rows and their validity.  Float SUM/AVG inside a
GROUP BY are compared within rtol 1e-6, since the two packages add in other
orders.  The zero-materialisation plan classes (oma, opt_plus) run here; the
materialising Ref/Opt baselines are held in ``test_torch_baselines.py``.
The reference's mesh path (its fault R2) is not exercised.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data.relational as jrel
from repro.core import aggregates as jagg
import repro_torch.core as tcore
import repro_torch.data.relational as trel
from repro_torch.core.aggregates import grouped_aggregate, scalar_aggregate
from repro_torch.kernels import freq_join as tfj
from repro_torch.kernels import segment_sum as tss
from repro_torch.kernels import semi_join as tsj
from repro_torch.tables.table import db_from_numpy

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
V1_AGGS = ("minmax", "count", "median")


def _carry(jdb):
    return db_from_numpy(
        {r: {**{c: np.asarray(v) for c, v in t.columns.items()},
             "freq": np.asarray(t.freq)} for r, t in jdb.items()},
        device="cpu")


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_answers_equal(got: dict, want: dict, float_rtol=None):
    assert set(got) - {"__stats__"} == set(want) - {"__stats__"}
    for k, w in want.items():
        if k == "__stats__":
            continue
        if isinstance(w, dict):
            _assert_answers_equal(got[k], w, float_rtol)
            continue
        g, w = _host(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if float_rtol is not None and g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=float_rtol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def tpch():
    jdb, jschema = jrel.make_tpch_db(scale=150, seed=3)
    # the schema's key domains follow the scale
    tschema = trel.make_tpch_db(scale=150, seed=3, device="cpu")[1]
    return jdb, jschema, _carry(jdb), tschema


@pytest.mark.parametrize("agg", V1_AGGS)
@pytest.mark.parametrize("mode", ["auto", "opt_plus"])
@pytest.mark.parametrize("dense_domain", [False, True])
def test_v1_matches_reference(tpch, agg, mode, dense_domain):
    jdb, jschema, tdb, tschema = tpch
    jplan = jcore.plan_query(jrel.tpch_v1_query(agg), jschema, mode=mode)
    tplan = tcore.plan_query(trel.tpch_v1_query(agg), tschema, mode=mode)
    assert tplan.mode == jplan.mode
    jex = jcore.Executor(jdb, jschema, dense_domain=dense_domain)
    tex = tcore.Executor(tdb, tschema, dense_domain=dense_domain)
    want = jex.execute(jplan)
    got = tex.execute(tplan)
    _assert_answers_equal(got, want)
    assert got["__stats__"].steps == want["__stats__"].steps
    assert got["__stats__"].peak_tuples == want["__stats__"].peak_tuples
    _assert_answers_equal(tex.compile(tplan)(tdb), jex.compile(jplan)(jdb))


def _graph_queries(rel):
    return {"path_2": rel.path_query(2), "tree_1": rel.tree_query(1),
            "tree_2": rel.tree_query(2), "star_3": rel.star_query(3)}


@pytest.mark.parametrize("name", sorted(_graph_queries(trel)))
def test_graph_counts_match_reference(name):
    """Counting queries over a skewed multigraph: Opt⁺ FreqJoins with
    pre-grouping on duplicate keys, COUNT equal bit for bit."""
    jdb, jschema = jrel.make_graph_db(60, 400, seed=4)
    tdb = _carry(jdb)
    tschema = trel.make_graph_db(60, 400, seed=4, device="cpu")[1]
    jplan = jcore.plan_query(_graph_queries(jrel)[name], jschema)
    tplan = tcore.plan_query(_graph_queries(trel)[name], tschema)
    want = jcore.Executor(jdb, jschema).compile(jplan)(jdb)
    _assert_answers_equal(tcore.Executor(tdb, tschema).execute(tplan), want)
    _assert_answers_equal(tcore.Executor(tdb, tschema).compile(tplan)(tdb),
                          want)


def test_grouped_aggregates_match_reference(tpch):
    jdb, jschema, tdb, tschema = tpch

    def query(core):
        atoms = (core.Atom("supplier", "s", ("sk", "nk", "bal")),
                 core.Atom("nation", "n", ("nk", "rk")),
                 core.Atom("region", "r", ("rk", "rname")))
        aggs = tuple(core.Agg(f, v) for f, v in (
            ("count", None), ("sum", "bal"), ("avg", "bal"), ("min", "bal"),
            ("max", "bal"), ("median", "bal"), ("sum", "sk")))
        spec = (("in", "r_name", (2, 3)),)
        return core.AggQuery(atoms=atoms, aggregates=aggs,
                             group_by=("nk",),
                             selections={"r": core.selection_from_spec(spec)},
                             selection_specs={"r": spec})

    for mode in ("auto", "opt_plus"):
        jplan = jcore.plan_query(query(jcore), jschema, mode=mode)
        tplan = tcore.plan_query(query(tcore), tschema, mode=mode)
        want = jcore.Executor(jdb, jschema).execute(jplan)
        got = tcore.Executor(tdb, tschema).execute(tplan)
        _assert_answers_equal(got, want, float_rtol=1e-6)
        for name in ("count(*)", "min(bal)", "max(bal)", "median(bal)",
                     "sum(sk)"):
            np.testing.assert_array_equal(
                _host(got["groups"][name]), np.asarray(want["groups"][name]))


def test_compile_multi_matches_solo(tpch):
    _, _, tdb, tschema = tpch
    plans = [tcore.plan_query(trel.tpch_v1_query(a), tschema)
             for a in V1_AGGS]
    ex = tcore.Executor(tdb, tschema)
    fused = ex.compile_multi(plans)(tdb)
    for plan, out in zip(plans, fused):
        _assert_answers_equal(out, ex.compile(plan)(tdb))


def test_cpu_run_launches_no_kernel(tpch):
    _, _, tdb, tschema = tpch
    before = (tsj.K1.launches, tfj.K2.launches, tss.K3.launches)
    ex = tcore.Executor(tdb, tschema)
    for a in V1_AGGS:
        ex.execute(tcore.plan_query(trel.tpch_v1_query(a), tschema))
    assert (tsj.K1.launches, tfj.K2.launches, tss.K3.launches) == before


def test_tuning_is_not_ported(tpch):
    """The refusal of ``tuning`` is gone: an Executor on CPU tables takes a
    ``TuneTable``, looks its configs up under the ``"plain"`` backend by
    each call's shape bucket, and answers as untuned (the dense path off
    everywhere changes the plain FreqJoin's route, not its answer)."""
    from repro_torch.kernels.autotune import KernelConfig, TuneTable
    _, _, tdb, tschema = tpch
    table = TuneTable()
    caps = sorted({t.capacity for t in tdb.values()})
    off = KernelConfig(dense_ratio=0)
    for kernel in ("freq_join", "semi_join"):
        for bp in caps:
            for bc in caps:
                table.install(kernel, (bp, bc), "plain", off)
    ex = tcore.Executor(tdb, tschema, dense_domain=True, tuning=table)
    assert ex.backend == "plain" and ex.jittable().tuning is table
    untuned = tcore.Executor(tdb, tschema, dense_domain=True)
    for a in V1_AGGS:
        plan = tcore.plan_query(trel.tpch_v1_query(a), tschema)
        _assert_answers_equal(ex.compile(plan)(tdb),
                              untuned.compile(plan)(tdb))
        _assert_answers_equal(ex.execute(plan), untuned.execute(plan))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("agg", V1_AGGS)
def test_64bit_frequencies_run_v1(tpch, dtype, agg):
    """The Executor takes 64-bit frequencies (fault F1 closed) and answers
    V.1 as the JAX package does under ``jax.enable_x64(True)``, in its
    64-bit dtypes: COUNT in int64 or float64, not narrowed to 32 bits."""
    jdb, jschema, tdb, tschema = tpch
    tplan = tcore.plan_query(trel.tpch_v1_query(agg), tschema)
    with jax.enable_x64(True):
        jplan = jcore.plan_query(jrel.tpch_v1_query(agg), jschema)
        want = jcore.Executor(jdb, jschema,
                              freq_dtype=getattr(jnp, dtype)).execute(jplan)
        want = {k: v if k == "__stats__" else np.asarray(v)
                for k, v in want.items()}
    ex = tcore.Executor(tdb, tschema, freq_dtype=getattr(torch, dtype))
    assert ex.wide
    got = ex.execute(tplan)
    _assert_answers_equal(got, want)
    if agg == "count":
        assert got["count(*)"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("agg", V1_AGGS)
def test_32bit_frequencies_run_v1(tpch, dtype, agg):
    jdb, jschema, tdb, tschema = tpch
    jplan = jcore.plan_query(jrel.tpch_v1_query(agg), jschema)
    tplan = tcore.plan_query(trel.tpch_v1_query(agg), tschema)
    want = jcore.Executor(jdb, jschema,
                          freq_dtype=getattr(jnp, dtype)).execute(jplan)
    got = tcore.Executor(tdb, tschema,
                         freq_dtype=getattr(torch, dtype)).execute(tplan)
    _assert_answers_equal(got, want)


def test_int32_aggregates_wrap_like_reference():
    """Regression for the pinned dtypes: PyTorch sums int32 into int64
    unless told otherwise; the reference's COUNT and SUM stay int32 and
    wrap, and so do the port's."""
    big = np.full(8, 1 << 29, np.int32)          # Σ = 2^32 → wraps to 0
    keys = np.array([0, 0, 1, 1, 1, 2, 2, 2], np.int32)
    for ag in (jcore.Agg("count"), jcore.Agg("sum", "k")):
        tag = tcore.Agg(ag.func, ag.var)
        want = jagg.scalar_aggregate(ag, {"k": jnp.asarray(keys)},
                                     jnp.asarray(big), False)
        got = scalar_aggregate(tag, {"k": torch.tensor(keys)},
                               torch.tensor(big), False)
        assert got.dtype == torch.int32
        assert int(got) == int(want)
    jcols, jvalid = jagg.grouped_aggregate(
        ("k",), (jcore.Agg("count"),), {"k": jnp.asarray(keys)},
        jnp.asarray(big * 2), {"k": 3}, False)
    tcols, tvalid = grouped_aggregate(
        ("k",), (tcore.Agg("count"),), {"k": torch.tensor(keys)},
        torch.tensor(big * 2), {"k": 3}, False)
    assert tcols["count(*)"].dtype == torch.int32
    np.testing.assert_array_equal(tcols["count(*)"].numpy(),
                                  np.asarray(jcols["count(*)"]))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def test_entry_points_default_to_the_gpu():
    """No silent CPU: without a card the default device cannot be used."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        trel.make_tpch_db(scale=1)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, or when copied alone into an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
