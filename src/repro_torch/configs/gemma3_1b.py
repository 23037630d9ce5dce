"""gemma3-1b — dense, 5:1 local:global attention, MQA (kv=1), 262k vocab.

[hf:google/gemma-3-1b-pt; unverified]  26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144; local window 512; d_head 256; sqrt(d) embed scale.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_head=256,
        d_ff=6912, vocab_size=262144,
        local_global_ratio=5, local_window=512, embed_scale=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab_size=512,
        local_global_ratio=1, local_window=8, embed_scale=True,
    )
