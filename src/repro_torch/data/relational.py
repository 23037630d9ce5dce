"""Synthetic relational datasets mirroring the paper's benchmarks.

  make_graph_db  — power-law directed graph (SNAP stand-in, Table 1)
  make_tpch_db   — mini TPC-H star schema: region→nation→supplier→partsupp
                   ←part, with FK/PK metadata (running example, §1/§4)
  make_stats_db  — FK/FK-joined tables à la STATS-CEB (Table 2)

plus query builders for the paper's path/tree/star counting queries.  The
generators draw from numpy with the JAX package's seeds and calls, so one
seed gives the same column bytes in both packages; ``device=None`` puts the
tables on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.query import Agg, AggQuery, Atom
from repro_torch.tables.table import (
    ColumnMeta,
    ForeignKey,
    RelSchema,
    Schema,
    Table,
)


# --------------------------------------------------------------------------
# SNAP-like graphs
# --------------------------------------------------------------------------
def make_graph_db(n_nodes: int, n_edges: int, seed: int = 0,
                  zipf_a: float = 1.5, device=None):
    """Directed multigraph with zipf-ish degree skew (like SNAP graphs)."""
    rng = np.random.default_rng(seed)

    def zipf_nodes(size):
        r = rng.zipf(zipf_a, size=size) % n_nodes
        return r.astype(np.int32)

    src = zipf_nodes(n_edges)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    schema = Schema(
        relations={
            "edge": RelSchema("edge", (
                ColumnMeta("src", domain=n_nodes),
                ColumnMeta("dst", domain=n_nodes),
            )),
        },
    )
    db = {"edge": Table.from_numpy({"src": src, "dst": dst}, device=device)}
    return db, schema


def path_query(k: int) -> AggQuery:
    """COUNT(*) over a k-join path: e1.dst=e2.src ∧ ... (paper §6.1,
    'path-0k' counts homomorphisms of a (k+1)-edge path)."""
    atoms = tuple(
        Atom("edge", f"e{i}", (f"x{i}", f"x{i+1}")) for i in range(k + 1))
    return AggQuery(atoms=atoms, aggregates=(Agg("count"),))


def tree_query(variant: int = 1) -> AggQuery:
    """Small tree-shaped counting queries (paper's tree-01..03)."""
    if variant == 1:      # out-star of 3 from a center reached by an edge
        atoms = (
            Atom("edge", "e0", ("r", "c")),
            Atom("edge", "e1", ("c", "a")),
            Atom("edge", "e2", ("c", "b")),
            Atom("edge", "e3", ("c", "d")),
        )
    elif variant == 2:    # depth-2 binary tree
        atoms = (
            Atom("edge", "e0", ("r", "u")),
            Atom("edge", "e1", ("r", "v")),
            Atom("edge", "e2", ("u", "a")),
            Atom("edge", "e3", ("u", "b")),
            Atom("edge", "e4", ("v", "c")),
        )
    else:                 # caterpillar
        atoms = (
            Atom("edge", "e0", ("a", "b")),
            Atom("edge", "e1", ("b", "c")),
            Atom("edge", "e2", ("c", "d")),
            Atom("edge", "e3", ("b", "p")),
            Atom("edge", "e4", ("c", "q")),
        )
    return AggQuery(atoms=atoms, aggregates=(Agg("count"),))


def star_query(fanout: int) -> AggQuery:
    atoms = tuple(
        Atom("edge", f"e{i}", ("c", f"x{i}")) for i in range(fanout))
    return AggQuery(atoms=atoms, aggregates=(Agg("count"),))


# --------------------------------------------------------------------------
# Mini TPC-H (the paper's running example, Figures 1/2)
# --------------------------------------------------------------------------
def make_tpch_db(scale: int = 1000, seed: int = 0, device=None):
    """region(5) ← nation(25) ← supplier(s) ← partsupp(ps) → part(p).

    Cardinalities scale like TPC-H: |supplier| = scale,
    |part| = 20·scale, |partsupp| = 80·scale.
    """
    rng = np.random.default_rng(seed)
    n_region, n_nation = 5, 25
    n_supp, n_part = scale, 20 * scale
    n_ps = 80 * scale

    region = {
        "r_regionkey": np.arange(n_region, dtype=np.int32),
        "r_name": np.arange(n_region, dtype=np.int32),  # dict-encoded name
    }
    nation = {
        "n_nationkey": np.arange(n_nation, dtype=np.int32),
        "n_regionkey": rng.integers(0, n_region, n_nation).astype(np.int32),
    }
    supplier = {
        "s_suppkey": np.arange(n_supp, dtype=np.int32),
        "s_nationkey": rng.integers(0, n_nation, n_supp).astype(np.int32),
        "s_acctbal": rng.normal(5000, 2500, n_supp).astype(np.float32),
    }
    part = {
        "p_partkey": np.arange(n_part, dtype=np.int32),
        "p_price": rng.gamma(4.0, 300.0, n_part).astype(np.float32),
    }
    partsupp = {
        "ps_partkey": rng.integers(0, n_part, n_ps).astype(np.int32),
        "ps_suppkey": rng.integers(0, n_supp, n_ps).astype(np.int32),
        "ps_supplycost": rng.gamma(2.0, 150.0, n_ps).astype(np.float32),
    }

    schema = Schema(
        relations={
            "region": RelSchema("region", (
                ColumnMeta("r_regionkey", unique=True, domain=n_region),
                ColumnMeta("r_name", domain=n_region),
            )),
            "nation": RelSchema("nation", (
                ColumnMeta("n_nationkey", unique=True, domain=n_nation),
                ColumnMeta("n_regionkey", domain=n_region),
            )),
            "supplier": RelSchema("supplier", (
                ColumnMeta("s_suppkey", unique=True, domain=n_supp),
                ColumnMeta("s_nationkey", domain=n_nation),
                ColumnMeta("s_acctbal"),
            )),
            "part": RelSchema("part", (
                ColumnMeta("p_partkey", unique=True, domain=n_part),
                ColumnMeta("p_price"),
            )),
            "partsupp": RelSchema("partsupp", (
                ColumnMeta("ps_partkey", domain=n_part),
                ColumnMeta("ps_suppkey", domain=n_supp),
                ColumnMeta("ps_supplycost"),
            )),
        },
        foreign_keys=(
            ForeignKey("nation", "n_regionkey", "region", "r_regionkey"),
            ForeignKey("supplier", "s_nationkey", "nation", "n_nationkey"),
            ForeignKey("partsupp", "ps_suppkey", "supplier", "s_suppkey"),
            ForeignKey("partsupp", "ps_partkey", "part", "p_partkey"),
        ),
    )
    db = {name: Table.from_numpy(data, device=device) for name, data in
          [("region", region), ("nation", nation), ("supplier", supplier),
           ("part", part), ("partsupp", partsupp)]}
    return db, schema


def tpch_v1_query(agg: str = "minmax", price_threshold: float = 1200.0,
                  regions=(2, 3)) -> AggQuery:
    """The paper's running example (Fig. 1): MIN/MAX (0MA) or MEDIAN
    (guarded, frequency propagation) of s_acctbal over the 5-way join.

    The nested `p_price > (SELECT avg(p_price) ...)` subquery is a local
    selection after decorrelation — we model it as the σ threshold.
    """
    atoms = (
        Atom("region", "r", ("rk", "rname")),
        Atom("nation", "n", ("nk", "rk")),
        Atom("supplier", "s", ("sk", "nk", "bal")),
        Atom("partsupp", "ps", ("pk", "sk", "cost")),
        Atom("part", "p", ("pk", "price")),
    )
    sels = {
        "r": lambda c: _isin(c["r_name"], regions),
        "p": lambda c: c["p_price"] > price_threshold,
    }
    if agg == "minmax":
        aggs = (Agg("min", "bal"), Agg("max", "bal"))
    elif agg == "median":
        aggs = (Agg("median", "bal"),)
    elif agg == "count":
        aggs = (Agg("count"),)
    else:
        raise ValueError(agg)
    return AggQuery(atoms=atoms, aggregates=aggs, selections=sels)


def _isin(arr, values):
    m = torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
    for v in values:
        m = m | (arr == v)
    return m


# --------------------------------------------------------------------------
# STATS-CEB-like FK/FK schema
# --------------------------------------------------------------------------
def make_stats_db(n_users: int = 2000, n_posts: int = 8000,
                  n_comments: int = 30000, n_votes: int = 20000,
                  seed: int = 0, device=None):
    """users ← posts ← {comments, votes}: joins are FK/FK-style (many-many
    through shared key columns), like STATS-CEB."""
    rng = np.random.default_rng(seed)
    users = {
        "u_id": np.arange(n_users, dtype=np.int32),
        "u_rep": rng.integers(0, 1000, n_users).astype(np.int32),
    }
    posts = {
        "p_id": np.arange(n_posts, dtype=np.int32),
        "p_owner": rng.integers(0, n_users, n_posts).astype(np.int32),
        "p_score": rng.integers(-10, 100, n_posts).astype(np.int32),
    }
    comments = {
        "c_post": rng.integers(0, n_posts, n_comments).astype(np.int32),
        "c_user": rng.integers(0, n_users, n_comments).astype(np.int32),
        "c_score": rng.integers(0, 50, n_comments).astype(np.int32),
    }
    votes = {
        "v_post": rng.integers(0, n_posts, n_votes).astype(np.int32),
        "v_user": rng.integers(0, n_users, n_votes).astype(np.int32),
    }
    schema = Schema(
        relations={
            "users": RelSchema("users", (
                ColumnMeta("u_id", unique=True, domain=n_users),
                ColumnMeta("u_rep", domain=1000),
            )),
            "posts": RelSchema("posts", (
                ColumnMeta("p_id", unique=True, domain=n_posts),
                ColumnMeta("p_owner", domain=n_users),
                ColumnMeta("p_score"),
            )),
            "comments": RelSchema("comments", (
                ColumnMeta("c_post", domain=n_posts),
                ColumnMeta("c_user", domain=n_users),
                ColumnMeta("c_score"),
            )),
            "votes": RelSchema("votes", (
                ColumnMeta("v_post", domain=n_posts),
                ColumnMeta("v_user", domain=n_users),
            )),
        },
        foreign_keys=(
            ForeignKey("posts", "p_owner", "users", "u_id"),
            ForeignKey("comments", "c_post", "posts", "p_id"),
            ForeignKey("votes", "v_post", "posts", "p_id"),
        ),
    )
    db = {name: Table.from_numpy(d, device=device) for name, d in
          [("users", users), ("posts", posts), ("comments", comments),
           ("votes", votes)]}
    return db, schema


def stats_count_query() -> AggQuery:
    """COUNT(*) over users⋈posts⋈comments⋈votes (STATS-CEB shape)."""
    atoms = (
        Atom("users", "u", ("uid", "rep")),
        Atom("posts", "po", ("pid", "uid", "score")),
        Atom("comments", "co", ("pid", "cuid", "cscore")),
        Atom("votes", "v", ("pid", "vuid")),
    )
    return AggQuery(atoms=atoms, aggregates=(Agg("count"),))
