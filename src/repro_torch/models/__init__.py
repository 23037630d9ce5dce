"""The LM stack's models: the dense, MoE, rwkv6, mamba2 and hybrid
(zamba2) families.

The port of the JAX package's ``repro.models``; ``param_specs`` is the
spec half of its ``init_params`` (``decode_state_specs`` waits for the dry
run, ``ROADMAP.md`` §1 item 4)."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    LM,
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
    "init_decode_state",
]
