"""The paper's contribution, in PyTorch: query IR, GYO join trees, 0MA
classification, rule-based rewrites (§4), the frequency-propagating
executor whose sweep runs the hand-written CUDA kernels (§5), and the
mesh ring sweep over ``torch.distributed`` (``core.distributed``, imported
from there as the JAX package's ``repro.core.distributed`` is)."""

from repro_torch.core.executor import (
    ExecStats,
    Executor,
    MaterialisationLimit,
    shared_subplan_savings,
)
from repro_torch.core.hypergraph import JoinTree, build_join_tree
from repro_torch.core.oma import Classification, classify
from repro_torch.core.plan import (
    Decision,
    PhysicalPlan,
    PlanNode,
    PlanNotSerialisable,
    PlanSegments,
    op_result_keys,
    plan_from_payload,
    plan_to_payload,
    rewrite_dag,
    segment_plan,
)
from repro_torch.core.query import Agg, AggQuery, Atom, selection_from_spec
from repro_torch.core.rewrite import PlanningError, plan_query
from repro_torch.core.sql import SqlError, parse_sql
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
    "PlanNotSerialisable",
    "PlanSegments",
    "PlanningError",
    "SqlError",
    "StatsCatalog",
    "TableStats",
    "build_join_tree",
    "classify",
    "compute_table_stats",
    "op_result_keys",
    "parse_sql",
    "plan_from_payload",
    "plan_query",
    "plan_to_payload",
    "rewrite_dag",
    "segment_plan",
    "selection_from_spec",
    "shared_subplan_savings",
]
