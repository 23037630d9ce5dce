"""The LM stack's models: the dense, MoE, rwkv6, mamba2 and hybrid
(zamba2) families.

The port of the JAX package's ``repro.models``; ``param_specs`` is the
spec half of its ``init_params``, ``decode_state_specs`` the decode
caches' logical axes."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    LM,
    decode_state_specs,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    param_specs,
    prefill,
)

__all__ = [
    "LM",
    "ModelConfig",
    "init_params",
    "param_specs",
    "forward",
    "prefill",
    "decode_step",
    "decode_state_specs",
    "init_decode_state",
]
