"""The LM stack's models: the dense, MoE, rwkv6, mamba2 and hybrid
(zamba2) families, on one device.

The port of the JAX package's ``repro.models`` (``decode_state_specs``, a
sharding annotation, has no counterpart)."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    LM,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)

__all__ = [
    "LM",
    "ModelConfig",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "init_decode_state",
]
