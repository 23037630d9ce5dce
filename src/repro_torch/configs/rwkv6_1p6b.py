"""rwkv6-1.6b ("Finch") — attention-free, data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 (attn-free) d_ff=7168
vocab=65536.  Chunked linear attention, chunk 32 (DESIGN.md §10).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="rwkv6",
        n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
        d_ff=7168, vocab_size=65536,
        ssm_head_dim=64, ssm_chunk=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="rwkv6",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=128, vocab_size=256,
        ssm_head_dim=16, ssm_chunk=8,
    )
