"""Tables and planner of the port against the JAX package's, on the CPU.

Both packages get the same numpy data and structurally equal queries (each
built from its own package's classes).  Tables must hash to the same
``content_token``; plans must have equal node keys, ``graph_key()``,
``subplan_keys()``, ``describe()`` and ``Decision`` traces, with and without
a statistics catalog, in every mode and with the FK/PK rewrite on and off.

Opaque selection callables key on ``id()`` in both packages, which differs
between two objects, so for such plans the ids are renumbered in order of
appearance, and ``describe()`` is compared without callables' addresses.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data.relational as jrel
import repro.tables.table as jtab
import repro_torch.core as tcore
import repro_torch.data.relational as trel
import repro_torch.tables.table as ttab

jax.config.update("jax_platform_name", "cpu")

MODES = ("auto", "oma", "opt_plus", "opt", "ref")
SPEC_R = (("in", "r_name", (2, 3)),)
SPEC_P = ((">", "p_price", 1200.0),)


def _queries(core, rel):
    """name → query, built from one package's classes."""
    Agg, AggQuery, Atom = core.Agg, core.AggQuery, core.Atom
    sfs = core.selection_from_spec
    v1_atoms = rel.tpch_v1_query().atoms
    dims = (Atom("supplier", "s", ("sk", "nk", "bal")),
            Atom("nation", "n", ("nk", "rk")),
            Atom("region", "r", ("rk", "rname")))
    qs = {f"v1_{a}": rel.tpch_v1_query(a)
          for a in ("minmax", "count", "median")}
    for a, aggs in (("median", (Agg("median", "bal"),)),
                    ("count", (Agg("count"),))):
        qs[f"v1_spec_{a}"] = AggQuery(
            atoms=v1_atoms, aggregates=aggs,
            selections={"r": sfs(SPEC_R), "p": sfs(SPEC_P)},
            selection_specs={"r": SPEC_R, "p": SPEC_P})
    qs["dims_count"] = AggQuery(atoms=dims, aggregates=(Agg("count"),))
    qs["dims_grouped"] = AggQuery(
        atoms=dims,
        aggregates=(Agg("count"), Agg("avg", "bal"), Agg("median", "bal")),
        group_by=("nk",), selections={"r": sfs(SPEC_R)},
        selection_specs={"r": SPEC_R})
    for k in (1, 3):
        qs[f"path_{k}"] = rel.path_query(k)
    for v in (1, 2, 3):
        qs[f"tree_{v}"] = rel.tree_query(v)
    qs["star_3"] = rel.star_query(3)
    return qs


QUERY_NAMES = sorted(_queries(tcore, trel))


def _dbs(name):
    if name.startswith(("path", "tree", "star")):
        return (jrel.make_graph_db(40, 300, seed=2),
                trel.make_graph_db(40, 300, seed=2, device="cpu"))
    return (jrel.make_tpch_db(scale=60, seed=1),
            trel.make_tpch_db(scale=60, seed=1, device="cpu"))


def _catalog(core, db, schema):
    cat = core.StatsCatalog(schema)
    for name, table in db.items():
        cat.refresh(name, table, db)
    return cat


def _norm(obj, ids):
    """Renumber opaque-selection ids in a node key, in traversal order."""
    if isinstance(obj, tuple):
        if len(obj) == 2 and obj[0] == "<opaque>":
            return ("<opaque>", ids.setdefault(obj[1], len(ids)))
        return tuple(_norm(o, ids) for o in obj)
    return obj


def _decisions(plan):
    return [(d.pass_name, d.target, d.applied, d.reason, d.stats, d.depends,
             d.describe()) for d in plan.decisions]


def _plan_or_error(core, q, schema, mode, fkpk, stats):
    try:
        return core.plan_query(q, schema, mode=mode, use_fkpk=fkpk,
                               stats=stats)
    except ValueError as e:   # PlanningError in both packages
        return f"{type(e).__name__}: {e}"


def _check_plans_equal(jp, tp):
    if isinstance(jp, str):
        assert tp == jp
        return
    assert tp.mode == jp.mode
    ids_j, ids_t = {}, {}
    assert [_norm(n.key(), ids_t) for n in tp.nodes] == \
        [_norm(n.key(), ids_j) for n in jp.nodes]
    assert {_norm(k, ids_t) for k in tp.subplan_keys()} == \
        {_norm(k, ids_j) for k in jp.subplan_keys()}
    # selection callables print with their addresses; opaque ones also
    # key on them, so their short keys differ too
    strip = re.compile(r" at 0x[0-9a-f]+" + (r"| key=[0-9a-f]{10}"
                                             if ids_j else ""))
    assert strip.sub("", tp.describe()) == strip.sub("", jp.describe())
    if ids_j:
        assert (tp.graph_key() is None) == (jp.graph_key() is None)
    else:
        assert tp.graph_key() == jp.graph_key()
    assert _decisions(tp) == _decisions(jp)
    assert tp.tree.root == jp.tree.root and tp.tree.parent == jp.tree.parent
    assert tp.var_cols == jp.var_cols


@pytest.mark.parametrize("name", QUERY_NAMES)
def test_plans_match_reference(name):
    (jdb, jschema), (tdb, tschema) = _dbs(name)
    jq = _queries(jcore, jrel)[name]
    tq = _queries(tcore, trel)[name]
    jcls, tcls = jcore.classify(jq, jschema), tcore.classify(tq, tschema)
    assert (tcls.acyclic, tcls.guarded, tcls.guard, tcls.set_safe,
            tcls.is_oma) == (jcls.acyclic, jcls.guarded, jcls.guard,
                             jcls.set_safe, jcls.is_oma)
    stats = [(None, None), (_catalog(jcore, jdb, jschema),
                            _catalog(tcore, tdb, tschema))]
    for mode in MODES:
        for fkpk in (False, True):
            for jst, tst in stats:
                _check_plans_equal(
                    _plan_or_error(jcore, jq, jschema, mode, fkpk, jst),
                    _plan_or_error(tcore, tq, tschema, mode, fkpk, tst))


def test_stats_gate_fires_identically():
    """FK-join elimination needs measured zero orphans: both catalogs
    measure the same counts and tokens, so the gate applies in both."""
    (jdb, jschema), (tdb, tschema) = _dbs("dims_count")
    jq, tq = (_queries(c, r)["dims_count"]
              for c, r in ((jcore, jrel), (tcore, trel)))
    jp = jcore.plan_query(jq, jschema, stats=_catalog(jcore, jdb, jschema))
    tp = tcore.plan_query(tq, tschema, stats=_catalog(tcore, tdb, tschema))
    applied = [d for d in tp.decisions if d.applied
               and d.pass_name == "fk_join_eliminate"]
    assert applied and all(d.depends for d in applied)
    assert _decisions(tp) == _decisions(jp)


@pytest.mark.parametrize("rel", ["region", "nation", "supplier", "part",
                                 "partsupp"])
def test_table_stats_match_reference(rel):
    (jdb, jschema), (tdb, tschema) = _dbs("v1")
    js = jcore.compute_table_stats(rel, jdb[rel], jschema, jdb)
    ts = tcore.compute_table_stats(rel, tdb[rel], tschema, tdb)
    assert (ts.relation, ts.rows, ts.capacity, ts.token, ts.fk_orphans) == \
        (js.relation, js.rows, js.capacity, js.token, js.fk_orphans)
    assert {c: (s.distinct, s.lo, s.hi) for c, s in ts.columns.items()} == \
        {c: (s.distinct, s.lo, s.hi) for c, s in js.columns.items()}


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_content_tokens_and_bytes_match_reference(seed):
    jdb, _ = jrel.make_tpch_db(scale=40, seed=seed)
    tdb, _ = trel.make_tpch_db(scale=40, seed=seed, device="cpu")
    assert sorted(tdb) == sorted(jdb)
    for rel in jdb:
        jt, tt = jdb[rel], tdb[rel]
        assert tt.column_names == jt.column_names
        for c in jt.column_names:
            a, b = np.asarray(jt.columns[c]), tt.columns[c].numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert tt.content_token() == jt.content_token()
        sel = (lambda c: c[jt.column_names[0]] % 2 == 0)
        assert tt.select(sel).content_token() == \
            jt.select(sel).content_token()
        padded = jtab.bucket_capacity(jt.capacity + 1)
        assert ttab.bucket_capacity(tt.capacity + 1) == padded
        assert tt.pad_to(padded).content_token() == \
            jt.pad_to(padded).content_token()
        assert int(tt.live_count()) == int(jt.live_count())
        assert tt.live_count().numpy().dtype == np.asarray(
            jt.live_count()).dtype


def test_graph_db_bytes_match_reference():
    jdb, _ = jrel.make_graph_db(1000, 5000, seed=7)
    tdb, _ = trel.make_graph_db(1000, 5000, seed=7, device="cpu")
    assert tdb["edge"].content_token() == jdb["edge"].content_token()


def test_db_from_numpy_carries_reference_tables():
    jdb, _ = jrel.make_tpch_db(scale=30, seed=5)
    jdb["part"] = jdb["part"].select(lambda c: c["p_price"] > 900.0)
    arrays = {r: {**{c: np.asarray(v) for c, v in t.columns.items()},
                  "freq": np.asarray(t.freq)} for r, t in jdb.items()}
    tdb = ttab.db_from_numpy(arrays, device="cpu")
    for rel, jt in jdb.items():
        assert tdb[rel].device.type == "cpu"
        assert tdb[rel].content_token() == jt.content_token()


def test_from_numpy_capacity_and_default_device():
    data = {"a": np.arange(5, dtype=np.int32),
            "b": np.linspace(0, 1, 5).astype(np.float32)}
    jt = jtab.Table.from_numpy(data, capacity=8)
    tt = ttab.Table.from_numpy(data, capacity=8, device="cpu")
    assert tt.content_token() == jt.content_token()
    with pytest.raises(ValueError):
        ttab.Table.from_numpy(data, capacity=4, device="cpu")
    assert ttab.DEFAULT_DEVICE == "cuda"


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_pack_keys_mixed_radix_matches_reference(ncols):
    rng = np.random.default_rng(ncols)
    doms = [7, 13, 50][:ncols]
    cols = [rng.integers(0, d, 200).astype(np.int32) for d in doms]
    want = jtab.pack_keys([jnp.asarray(c) for c in cols], doms)
    got = ttab.pack_keys([torch.tensor(c) for c in cols], doms)
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _np_hash_combine(cols):
    """numpy oracle of the hash-combine fallback in int32 arithmetic with
    the golden-ratio constant 0x9E3779B9 wrapped to int32."""
    phi = np.int32(0x9E3779B9 - (1 << 32))
    key = cols[0].astype(np.int32)
    for c in cols[1:]:
        key = key ^ (c.astype(np.int32) + phi + (key << 6) + (key >> 2))
    return key


def test_pack_keys_hash_fallback_matches_numpy_oracle():
    """The fallback for unknown domains (reference fault R3: the JAX
    package's int32 constant overflows on the installed JAX, so it is held
    against numpy instead)."""
    rng = np.random.default_rng(9)
    cols = [rng.integers(-(1 << 31), (1 << 31) - 1, 500).astype(np.int32)
            for _ in range(3)]
    got = ttab.pack_keys([torch.tensor(c) for c in cols], [None, 5, None])
    np.testing.assert_array_equal(got.numpy(), _np_hash_combine(cols))
    assert got.dtype == torch.int32
