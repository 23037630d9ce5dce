"""The materialising baselines (Ref, Opt) against the JAX package's.

``plan_query(mode="ref" | "opt")`` plans hold ``MaterializeJoinOp``s, which
``Executor.execute`` expands row by row.  On the same inputs the port's
answers, its ``ExecStats.steps`` and its ``peak_tuples`` must equal the
reference's bit for bit: the running example V.1, the paper's graph
counting queries, the STATS-CEB-shaped count, the Fig. 6 invariant and the
``oom_guard``.  Where the reference's expansion raises on an empty live
side (its fault R1), the port returns an empty state; those cases are held
against a brute-force numpy oracle instead.
"""

import hashlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data.relational as jrel
import repro_torch.core as tcore
import repro_torch.data.relational as trel
from repro_torch.core.executor import ExecStats
from repro_torch.core.plan import MaterializeJoinOp, ScanOp
from test_torch_executor import V1_AGGS, _assert_answers_equal, _carry
from test_torch_gpu import _two_relation_db, _two_relation_query

REPO = Path(__file__).resolve().parents[1]

# Fig. 6's path rows at the JAX package's sizes (benchmarks/materialisation.py:
# make_graph_db(5000, 60000, seed=2), oom_guard=50_000_000) and int32, as the
# JAX package gives them on the CPU with numpy 2.0.2: k → (peak tuples per
# mode, None where the guard trips; COUNT(*)).  path-4's COUNT is the int32
# wrap of 2704172672.  numpy's Generator.zipf stream differs between numpy
# versions, so the rows hold for the graph whose src and dst bytes have the
# digest FIG6_GRAPH_SHA256.
FIG6_GRAPH_SHA256 = ("a0f0d273b8236a254618de0ce816109b"
                     "0f72f2724a1ce622a6822f5a99e189ad")
FIG6_PATHS = {
    2: ({"ref": 12781853, "opt": 876893, "opt_plus": 60000}, 12781853),
    3: ({"ref": None, "opt": 876893, "opt_plus": 60000}, 185955164),
    4: ({"ref": None, "opt": 876893, "opt_plus": 60000}, -1590794624),
}


def _graph_queries(rel):
    return {"path_2": rel.path_query(2), "path_3": rel.path_query(3),
            "path_4": rel.path_query(4), "tree_1": rel.tree_query(1),
            "tree_2": rel.tree_query(2), "star_3": rel.star_query(3)}


def _both(jdb, jschema, tdb, tschema, jquery, tquery, mode, use_fkpk=False,
          freq_dtype=(jnp.int32, torch.int32), **kw):
    """The JAX package's and the port's ``execute`` of one query."""
    jplan = jcore.plan_query(jquery, jschema, mode=mode, use_fkpk=use_fkpk)
    tplan = tcore.plan_query(tquery, tschema, mode=mode, use_fkpk=use_fkpk)
    assert tplan.mode == jplan.mode == mode
    want = jcore.Executor(jdb, jschema, freq_dtype=freq_dtype[0],
                          **kw).execute(jplan)
    got = tcore.Executor(tdb, tschema, freq_dtype=freq_dtype[1],
                         **kw).execute(tplan)
    return got, want


def _assert_same_run(got, want):
    _assert_answers_equal(got, want)
    assert got["__stats__"].steps == want["__stats__"].steps
    assert got["__stats__"].peak_tuples == want["__stats__"].peak_tuples


@pytest.fixture(scope="module")
def tpch():
    jdb, jschema = jrel.make_tpch_db(scale=150, seed=3)
    tschema = trel.make_tpch_db(scale=150, seed=3, device="cpu")[1]
    return jdb, jschema, _carry(jdb), tschema


@pytest.fixture(scope="module")
def graph():
    jdb, jschema = jrel.make_graph_db(40, 160, seed=6)
    tschema = trel.make_graph_db(40, 160, seed=6, device="cpu")[1]
    return jdb, jschema, _carry(jdb), tschema


@pytest.mark.parametrize("agg", V1_AGGS)
@pytest.mark.parametrize("mode", ["ref", "opt"])
@pytest.mark.parametrize("use_fkpk", [False, True])
def test_v1_baselines_match_reference(tpch, agg, mode, use_fkpk):
    jdb, jschema, tdb, tschema = tpch
    got, want = _both(jdb, jschema, tdb, tschema, jrel.tpch_v1_query(agg),
                      trel.tpch_v1_query(agg), mode, use_fkpk)
    _assert_same_run(got, want)
    # every partsupp row is scanned live, so each plan peaks at |partsupp|
    assert got["__stats__"].peak_tuples == tdb["partsupp"].capacity


@pytest.mark.parametrize("name", sorted(_graph_queries(trel)))
@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_graph_baselines_match_reference(graph, name, mode):
    jdb, jschema, tdb, tschema = graph
    got, want = _both(jdb, jschema, tdb, tschema, _graph_queries(jrel)[name],
                      _graph_queries(trel)[name], mode)
    _assert_same_run(got, want)


def _weighted(jdb, tdb, rel, seed):
    """Both packages' databases with ``rel``'s frequencies times one draw of
    real float32 weights in [0.5, 2), so sums depend on the order of adds."""
    w = np.random.default_rng(seed).uniform(
        0.5, 2.0, tdb[rel].capacity).astype(np.float32)
    freq = np.asarray(jdb[rel].freq).astype(np.float32) * w
    return ({**jdb, rel: jdb[rel].with_freq(jnp.asarray(freq))},
            {**tdb, rel: tdb[rel].with_freq(torch.from_numpy(freq))})


@pytest.mark.parametrize("name", ["path_3", "tree_2"])
@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_float32_graph_baselines_match_reference(graph, name, mode):
    """float32 frequencies of real values through the expansion and Opt's
    regroup: COUNT(*) within rtol 1e-6 of the reference's, which adds in
    another order; steps and peaks equal."""
    jdb, jschema, tdb, tschema = graph
    jdb, tdb = _weighted(jdb, tdb, "edge", seed=12)
    got, want = _both(jdb, jschema, tdb, tschema, _graph_queries(jrel)[name],
                      _graph_queries(trel)[name], mode,
                      freq_dtype=(jnp.float32, torch.float32))
    _assert_answers_equal(got, want, float_rtol=1e-6)
    assert got["__stats__"].steps == want["__stats__"].steps
    assert got["__stats__"].peak_tuples == want["__stats__"].peak_tuples


@pytest.mark.parametrize("agg", V1_AGGS)
@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_float32_v1_baselines_match_reference(tpch, agg, mode):
    """V.1 under Ref and Opt with float32 frequencies: the answers, steps
    and peaks equal the reference's (integer frequencies, so every sum is
    exact in float32)."""
    jdb, jschema, tdb, tschema = tpch
    got, want = _both(jdb, jschema, tdb, tschema, jrel.tpch_v1_query(agg),
                      trel.tpch_v1_query(agg), mode,
                      freq_dtype=(jnp.float32, torch.float32))
    _assert_same_run(got, want)


@pytest.mark.parametrize("mode", ["ref", "opt", "opt_plus"])
def test_stats_count_matches_reference(mode):
    sizes = dict(n_users=30, n_posts=90, n_comments=300, n_votes=200, seed=1)
    jdb, jschema = jrel.make_stats_db(**sizes)
    tschema = trel.make_stats_db(**sizes, device="cpu")[1]
    got, want = _both(jdb, jschema, _carry(jdb), tschema,
                      jrel.stats_count_query(), trel.stats_count_query(),
                      mode)
    _assert_same_run(got, want)


def test_make_stats_db_matches_reference():
    """Same seed, same column bytes, dtypes and schema."""
    jdb, jschema = jrel.make_stats_db(seed=4)
    tdb, tschema = trel.make_stats_db(seed=4, device="cpu")
    assert set(tdb) == set(jdb)
    for rel, jtab in jdb.items():
        ttab = tdb[rel]
        assert set(ttab.columns) == set(jtab.columns)
        for c, jcol in jtab.columns.items():
            want, got = np.asarray(jcol), ttab.columns[c].numpy()
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert ttab.freq.numpy().tobytes() == np.asarray(jtab.freq).tobytes()
        assert ttab.content_token() == jtab.content_token()
        jrs, trs = jschema.relations[rel], tschema.relations[rel]
        assert [(m.name, m.unique, m.domain) for m in trs.columns] == \
            [(m.name, m.unique, m.domain) for m in jrs.columns]
    assert [tuple(vars(fk).values()) for fk in tschema.foreign_keys] == \
        [tuple(vars(fk).values()) for fk in jschema.foreign_keys]


def test_opt_plus_never_materialises_beyond_base_relations():
    """Fig. 6's invariant on the reference's own test graph: Opt⁺ peaks at
    the largest base relation, Ref strictly above it; every mode's peak and
    COUNT equal the reference's."""
    jdb, jschema = jrel.make_graph_db(n_nodes=15, n_edges=60, seed=11)
    tdb = _carry(jdb)
    tschema = trel.make_graph_db(15, 60, seed=11, device="cpu")[1]
    base_max = max(int(t.live_count()) for t in tdb.values())
    peaks = {}
    for mode in ("ref", "opt", "opt_plus"):
        got, want = _both(jdb, jschema, tdb, tschema, jrel.path_query(4),
                          trel.path_query(4), mode)
        _assert_same_run(got, want)
        peaks[mode] = got["__stats__"].peak_tuples
    assert peaks["opt_plus"] <= base_max < peaks["ref"]


def test_oom_guard_fires_like_paper_x_entries():
    """The guard raises at the same step as the reference's, with the steps
    before it recorded alike; Opt⁺ passes the same guard."""
    jdb, jschema = jrel.make_graph_db(n_nodes=20, n_edges=300, seed=13)
    tdb = _carry(jdb)
    tschema = trel.make_graph_db(20, 300, seed=13, device="cpu")[1]
    jstats, tstats = jcore.executor.ExecStats(), ExecStats()
    with pytest.raises(jcore.MaterialisationLimit) as jerr:
        jcore.Executor(jdb, jschema, oom_guard=10_000).execute(
            jcore.plan_query(jrel.path_query(5), jschema, mode="ref"),
            jstats)
    ex = tcore.Executor(tdb, tschema, oom_guard=10_000)
    with pytest.raises(tcore.MaterialisationLimit) as terr:
        ex.execute(tcore.plan_query(trel.path_query(5), tschema, mode="ref"),
                   tstats)
    assert str(terr.value) == str(jerr.value)
    assert tstats.steps == jstats.steps
    ex.execute(tcore.plan_query(trel.path_query(5), tschema,
                                mode="opt_plus"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fig6_table_is_the_oracle_on_its_graph():
    """``FIG6_PATHS`` (the JAX package's numbers on the graph whose digest is
    ``FIG6_GRAPH_SHA256``) equal ``chip_smoke.path_oracle`` on that graph,
    as the port makes it from ``chip_smoke.FIG6_GRAPH``'s seed here."""
    cs = _chip_smoke()
    db, _ = trel.make_graph_db(**cs.FIG6_GRAPH, device="cpu")
    src, dst = (db["edge"].columns[c].numpy() for c in ("src", "dst"))
    assert hashlib.sha256(src.tobytes() + dst.tobytes()).hexdigest() == \
        FIG6_GRAPH_SHA256
    assert len(src) == cs.FIG6_GRAPH["n_edges"]
    for k, (peaks, count) in FIG6_PATHS.items():
        got_peaks, refused, got_count = cs.path_oracle(src, dst, k,
                                                       cs.FIG6_GUARD)
        assert (got_peaks, got_count) == (peaks, count)
        assert peaks["opt_plus"] == len(src)
        assert (refused is None) == (peaks["ref"] is not None)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_fig6_path_oracle_matches_reference(k):
    """``chip_smoke.py`` holds Fig. 6's path rows against its numpy oracle,
    since the card's machine may draw another zipf stream from the same
    seed; the oracle's peaks, guard trip and COUNT equal the JAX package's,
    with a guard that path-3 and path-4 trip under Ref."""
    chip_smoke = _chip_smoke()
    jdb, jschema = jrel.make_graph_db(300, 3000, seed=2)
    src, dst = (np.asarray(jdb["edge"].columns[c]) for c in ("src", "dst"))
    guard = 1_000_000
    peaks, refused, count = chip_smoke.path_oracle(src, dst, k, guard)
    assert (refused is None) == (k == 2)
    ex = jcore.Executor(jdb, jschema, oom_guard=guard)
    for mode in ("ref", "opt", "opt_plus"):
        plan = jcore.plan_query(jrel.path_query(k), jschema, mode=mode)
        if peaks[mode] is None:
            with pytest.raises(jcore.MaterialisationLimit,
                               match=f"would materialise {refused} tuples"):
                ex.execute(plan)
            continue
        res = ex.execute(plan)
        assert res["__stats__"].peak_tuples == peaks[mode]
        assert int(res["count(*)"]) == count


@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_compile_refuses_materialising_plans(tpch, mode):
    jdb, jschema, tdb, tschema = tpch
    jplan = jcore.plan_query(jrel.tpch_v1_query("median"), jschema, mode=mode)
    tplan = tcore.plan_query(trel.tpch_v1_query("median"), tschema, mode=mode)
    jex, tex = jcore.Executor(jdb, jschema), tcore.Executor(tdb, tschema)
    for jcall, tcall in ((jex.compile, tex.compile),
                         (lambda p: jex.compile_multi([p]),
                          lambda p: tex.compile_multi([p]))):
        with pytest.raises(ValueError) as jerr:
            jcall(jplan)
        with pytest.raises(ValueError) as terr:
            tcall(tplan)
        assert str(terr.value) == str(jerr.value)


def test_compile_refuses_oom_guard_and_jittable_strips_it(tpch):
    jdb, jschema, tdb, tschema = tpch
    plan = tcore.plan_query(trel.tpch_v1_query("minmax"), tschema)
    jplan = jcore.plan_query(jrel.tpch_v1_query("minmax"), jschema)
    ex = tcore.Executor(tdb, tschema, dense_domain=True, oom_guard=10)
    with pytest.raises(ValueError) as terr:
        ex.compile(plan)
    with pytest.raises(ValueError) as jerr:
        jcore.Executor(jdb, jschema, oom_guard=10).compile(jplan)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="oom_guard"):
        ex.compile_multi([plan])
    free = ex.jittable()
    assert free.oom_guard is None and ex.oom_guard == 10
    assert free.dense_domain and free.freq_dtype == ex.freq_dtype
    _assert_answers_equal(free.compile(plan)(tdb),
                          jcore.Executor(jdb, jschema).compile(jplan)(jdb))


# ---------------------------------------------------------------------------
# one materialising join against a brute-force oracle, empty sides included
# ---------------------------------------------------------------------------
def _expand_oracle(pcols, pf, pkey, ccols, cf, ckey, regroup):
    """The join by nested loops: live parent rows in row order, each with
    its live matches in the stable order of the child's keys; with
    ``regroup``, the parent's columns grouped in lexicographic order and
    their frequency products summed (int32 wrap).  Also returns the number
    of joined rows."""
    corder = sorted(np.flatnonzero(cf > 0), key=lambda j: ckey[j])
    rows = [(i, j) for i in np.flatnonzero(pf > 0) for j in corder
            if ckey[j] == pkey[i]]
    cols = {v: np.array([col[i] for i, _ in rows], col.dtype)
            for v, col in pcols.items()}
    for v, col in ccols.items():
        cols.setdefault(v, np.array([col[j] for _, j in rows], col.dtype))
    freq = np.array([pf[i] * cf[j] for i, j in rows], pf.dtype)
    if not regroup:
        return cols, freq, len(rows)
    groups: dict = {}
    for r, f in enumerate(freq):
        key = tuple(cols[v][r] for v in pcols)
        groups[key] = np.int32(groups.get(key, 0) + f)
    keys = sorted(groups)
    return ({v: np.array([k[n] for k in keys], pcols[v].dtype)
             for n, v in enumerate(pcols)},
            np.array([groups[k] for k in keys], pf.dtype), len(rows))


@pytest.mark.parametrize("dead", ["none", "parent", "child", "both"])
@pytest.mark.parametrize("mode", ["ref", "opt"])
def test_materialize_join_matches_oracle(dead, mode):
    """Fault R1: where no parent (or no child) row is live, the reference's
    expansion raises; the port returns an empty state in the reference's
    dtypes and records 0 tuples."""
    db, schema = _two_relation_db("cpu")
    plan = tcore.plan_query(_two_relation_query(), schema, mode=mode)
    ex = tcore.Executor(db, schema)
    (node,) = [n for n in plan.nodes if isinstance(n.op, MaterializeJoinOp)]
    op = node.op
    p, c = (ex._scan(db, plan, n.op) for n in node.inputs)
    assert all(isinstance(n.op, ScanOp) for n in node.inputs)
    if dead in ("parent", "both"):
        p.freq = torch.zeros_like(p.freq)
    if dead in ("child", "both"):
        c.freq = torch.zeros_like(c.freq)
    stats = ExecStats()
    st = ex._materialize_join(plan, op, p, c, stats)
    ph = {v: col.numpy() for v, col in p.cols.items()}
    ch = {v: col.numpy() for v, col in c.cols.items()}
    want_cols, want_freq, n_rows = _expand_oracle(
        ph, p.freq.numpy(), ph["b"], ch, c.freq.numpy(), ch["b"], op.regroup)
    assert list(st.cols) == list(want_cols)
    for v, want in want_cols.items():
        got = st.cols[v].numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=v)
    assert st.freq.dtype == torch.int32
    np.testing.assert_array_equal(st.freq.numpy(), want_freq)
    want_steps = [(f"join({op.parent}⋈{op.child})", n_rows)]
    if op.regroup:
        want_steps.append((f"regroup({op.parent})", want_freq.shape[0]))
    assert stats.steps == want_steps
    assert (n_rows == 0) == (dead != "none")
    # end to end, the dead side's relation zeroed: COUNT(*) as the oracle's
    for alias in {"parent": (op.parent,), "child": (op.child,),
                  "both": (op.parent, op.child), "none": ()}[dead]:
        rel = plan.tree.atoms[alias].rel
        db = {**db, rel: db[rel].with_freq(torch.zeros_like(db[rel].freq))}
    count = tcore.Executor(db, schema).execute(plan)["count(*)"]
    assert count.dtype == torch.int32
    assert int(count) == int(want_freq.sum(dtype=np.int32))
