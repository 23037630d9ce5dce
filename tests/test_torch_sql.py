"""The SQL front end and query fingerprints: the port against the JAX package.

The same statement goes through both packages' ``parse_sql``: the
``AggQuery``s must be structurally identical (atoms, aggregates, GROUP BY,
declarative selection specs), and each selection closure must select the
same rows of the same numpy columns.  Garbage SQL, non-equi joins and
unknown relations must raise the same error class with the same message.
``canonicalize`` must give equal fingerprints and prefix fingerprints, and
renamed-alias variants of a statement one fingerprint in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.relational as jrel
import repro_torch.data.relational as trel
from repro.core.sql import SqlError as JSqlError
from repro.core.sql import parse_sql as jparse
from repro.service import canonicalize as jcanon
from repro_torch.core.sql import SqlError as TSqlError
from repro_torch.core.sql import parse_sql as tparse
from repro_torch.service import canonicalize as tcanon

jax.config.update("jax_platform_name", "cpu")

FIG1 = """
    SELECT MIN(s.s_acctbal), MAX(s.s_acctbal)
    FROM region r, nation n, supplier s, partsupp ps, part p
    WHERE r.r_regionkey = n.n_regionkey
      AND n.n_nationkey = s.s_nationkey
      AND s.s_suppkey = ps.ps_suppkey
      AND ps.ps_partkey = p.p_partkey
      AND r.r_name IN (2, 3) AND p.p_price > 1200.0
"""
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
DIMS = """FROM supplier s, nation n, region r
    WHERE s.s_nationkey = n.n_nationkey
      AND n.n_regionkey = r.r_regionkey AND r.r_name IN (2, 3)"""
FIVE = FIG1[FIG1.index("FROM"):]

TPCH_STATEMENTS = {
    "fig1": FIG1,
    "fig1_renamed": FIG1_RENAMED,
    "count": f"SELECT COUNT(*) {FIVE}",
    "median": f"SELECT MEDIAN(s.s_acctbal) {FIVE}",
    "dash_minmax": f"SELECT MIN(s.s_acctbal), MAX(s.s_acctbal) {DIMS}",
    "dash_sum": f"SELECT SUM(s.s_acctbal) {DIMS}",
    "dash_grouped": f"SELECT COUNT(*) AS cnt, AVG(s.s_acctbal) AS avg {DIMS} "
                    "GROUP BY s.s_nationkey",
    "lookup": f"SELECT COUNT(*) {DIMS}",
    "costly_parts": """SELECT SUM(ps.ps_supplycost), COUNT(*)
        FROM partsupp ps, part p
        WHERE ps.ps_partkey = p.p_partkey AND p.p_price > 1500.0""",
    "nation_region": "SELECT COUNT(*) FROM nation n, region r "
                     "WHERE n.n_regionkey = r.r_regionkey",
    "distinct": "SELECT COUNT(DISTINCT s.s_nationkey) FROM supplier s, "
                "nation n WHERE s.s_nationkey = n.n_nationkey",
    "comparisons": "SELECT MIN(p.p_price), MAX(p.p_price), AVG(p.p_price) "
                   "FROM part p WHERE p.p_price >= 100.5 "
                   "AND p.p_price <= 1900 AND p.p_partkey != 7 "
                   "AND p.p_partkey < 900",
    "equality": "SELECT SUM(ps.ps_supplycost) FROM partsupp ps "
                "WHERE ps.ps_suppkey = 3",
    "lowercase": "select min(s.s_acctbal) as lo from supplier s, nation n "
                 "where s.s_nationkey = n.n_nationkey and n.n_regionkey "
                 "in (1, 4)",
}
STATS_STATEMENT = """
    SELECT COUNT(*) FROM posts po, comments co
    WHERE po.p_id = co.c_post
    GROUP BY po.p_owner
"""

ERROR_STATEMENTS = {
    "unknown relation": "SELECT COUNT(*) FROM nope x",
    "unknown relation in join": "SELECT COUNT(*) FROM part p, nosuch n "
                                "WHERE p.p_partkey = n.n_key",
    "no aggregate": "SELECT p.p_price FROM part p",
    "empty aggregate": "SELECT MIN() FROM part p",
    "unknown column": "SELECT MIN(p.bogus) FROM part p",
    "unqualified column": "SELECT MIN(p_price) FROM part p",
    "unknown alias in aggregate": "SELECT MIN(zz.p_price) FROM part p",
    "unknown alias in where": "SELECT COUNT(*) FROM part p "
                              "WHERE q.p_price > 10",
    "non-equi join": """SELECT COUNT(*) FROM partsupp ps, part p
        WHERE ps.ps_partkey = p.p_partkey
          AND ps.ps_supplycost < p.p_price""",
    "between": "SELECT COUNT(*) FROM part p WHERE p.p_price BETWEEN 1 AND 2",
    "garbage": "this is not sql at all",
    "no from": "SELECT COUNT(*)",
    "group by unknown": "SELECT COUNT(*) FROM part p GROUP BY q.p_partkey",
}


@pytest.fixture(scope="module")
def tpch():
    jdb, jschema = jrel.make_tpch_db(scale=120, seed=5)
    tschema = trel.make_tpch_db(scale=120, seed=5, device="cpu")[1]
    return jdb, jschema, tschema


@pytest.fixture(scope="module")
def stats():
    kw = dict(n_users=30, n_posts=100, n_comments=250, n_votes=100, seed=2)
    jdb, jschema = jrel.make_stats_db(**kw)
    tschema = trel.make_stats_db(**kw, device="cpu")[1]
    return jdb, jschema, tschema


def _structure(q):
    """Everything of an AggQuery but its selection closures."""
    return (tuple((a.rel, a.alias, a.vars) for a in q.atoms),
            tuple((g.func, g.var, g.distinct, g.name) for g in q.aggregates),
            q.group_by, sorted(q.selections),
            sorted((k, v) for k, v in q.selection_specs.items()))


def _assert_same_query(jq, tq, jdb):
    assert repr(_structure(tq)) == repr(_structure(jq))
    for alias, jsel in jq.selections.items():
        rel = jq.atom(alias).rel
        cols = {c: np.asarray(v) for c, v in jdb[rel].columns.items()}
        jmask = np.asarray(jsel({c: jnp.asarray(v) for c, v in cols.items()}))
        tmask = tq.selections[alias](
            {c: torch.tensor(v) for c, v in cols.items()}).numpy()
        np.testing.assert_array_equal(tmask, jmask, err_msg=alias)


@pytest.mark.parametrize("name", sorted(TPCH_STATEMENTS))
def test_parse_sql_matches_reference(tpch, name):
    jdb, jschema, tschema = tpch
    sql = TPCH_STATEMENTS[name]
    _assert_same_query(jparse(sql, jschema), tparse(sql, tschema), jdb)


def test_parse_sql_group_by_matches_reference(stats):
    jdb, jschema, tschema = stats
    jq, tq = jparse(STATS_STATEMENT, jschema), tparse(STATS_STATEMENT,
                                                      tschema)
    assert tq.group_by and tq.aggregates[0].func == "count"
    _assert_same_query(jq, tq, jdb)


@pytest.mark.parametrize("name", sorted(ERROR_STATEMENTS))
def test_sql_errors_match_reference(tpch, name):
    _, jschema, tschema = tpch
    sql = ERROR_STATEMENTS[name]
    with pytest.raises(JSqlError) as jerr:
        jparse(sql, jschema)
    with pytest.raises(TSqlError) as terr:
        tparse(sql, tschema)
    assert issubclass(TSqlError, ValueError)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", sorted(TPCH_STATEMENTS))
def test_fingerprints_match_reference(tpch, name):
    _, jschema, tschema = tpch
    sql = TPCH_STATEMENTS[name]
    jc, tc = jcanon(jparse(sql, jschema)), tcanon(tparse(sql, tschema))
    assert tc.fingerprint == jc.fingerprint
    assert tc.prefix_fingerprint == jc.prefix_fingerprint
    assert tc.shareable and jc.shareable
    assert (tc.agg_names, tc.group_names) == (jc.agg_names, jc.group_names)
    assert repr(_structure(tc.query)) == repr(_structure(jc.query))


def test_renamed_statements_share_one_fingerprint(tpch):
    _, jschema, tschema = tpch
    fps = {tcanon(tparse(s, tschema)).fingerprint
           for s in (FIG1, FIG1_RENAMED)}
    assert fps == {jcanon(jparse(FIG1, jschema)).fingerprint}
    # the dashboard shares its whole join prefix, not its fingerprint
    dash = [tcanon(tparse(TPCH_STATEMENTS[k], tschema))
            for k in ("dash_minmax", "dash_sum", "lookup")]
    assert len({c.fingerprint for c in dash}) == 3
    assert len({c.prefix_fingerprint for c in dash}) == 1
