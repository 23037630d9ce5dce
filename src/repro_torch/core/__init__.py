"""The paper's contribution, in PyTorch: query IR, GYO join trees, 0MA
classification, rule-based rewrites (§4), and the frequency-propagating
executor whose sweep runs the hand-written CUDA kernels (§5)."""

from repro_torch.core.executor import (
    ExecStats,
    Executor,
    MaterialisationLimit,
)
from repro_torch.core.hypergraph import JoinTree, build_join_tree
from repro_torch.core.oma import Classification, classify
from repro_torch.core.plan import Decision, PhysicalPlan, PlanNode, rewrite_dag
from repro_torch.core.query import Agg, AggQuery, Atom, selection_from_spec
from repro_torch.core.rewrite import PlanningError, plan_query
from repro_torch.core.stats import StatsCatalog, TableStats, compute_table_stats

__all__ = [
    "Agg",
    "AggQuery",
    "Atom",
    "Classification",
    "Decision",
    "ExecStats",
    "Executor",
    "JoinTree",
    "MaterialisationLimit",
    "PhysicalPlan",
    "PlanNode",
    "PlanningError",
    "StatsCatalog",
    "TableStats",
    "build_join_tree",
    "classify",
    "compute_table_stats",
    "plan_query",
    "rewrite_dag",
    "selection_from_spec",
]
