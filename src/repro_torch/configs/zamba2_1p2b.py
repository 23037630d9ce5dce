"""zamba2-1.2b — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64.  Shared transformer block applied every 6 Mamba2
layers (weights shared across applications; per-application LoRA omitted —
DESIGN.md §10).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_chunk=128,
        shared_attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8, ssm_expand=2,
        shared_attn_every=2,
    )
