from repro_torch.data.lm_pipeline import TokenPipeline
from repro_torch.data.relational import (
    make_graph_db,
    make_stats_db,
    make_tpch_db,
    path_query,
    star_query,
    stats_count_query,
    tpch_v1_query,
    tree_query,
)

__all__ = [
    "TokenPipeline",
    "make_graph_db",
    "make_stats_db",
    "make_tpch_db",
    "path_query",
    "star_query",
    "stats_count_query",
    "tpch_v1_query",
    "tree_query",
]
