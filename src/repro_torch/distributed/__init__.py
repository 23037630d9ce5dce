"""The port of the JAX package's ``repro.distributed``: the logical
sharding rules as DTensor placements (``sharding``) and gradient
compression (``compression``)."""

from repro_torch.distributed.compression import (
    CompressedPsum,
    ef_int8_roundtrip,
)
from repro_torch.distributed.sharding import (
    LOGICAL_RULES,
    axis_rules,
    current_mesh,
    logical_spec,
    shard,
    use_mesh,
)

__all__ = [
    "LOGICAL_RULES",
    "axis_rules",
    "current_mesh",
    "logical_spec",
    "shard",
    "use_mesh",
    "ef_int8_roundtrip",
    "CompressedPsum",
]
