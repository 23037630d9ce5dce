"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]  56L d_model=6144 48H (GQA kv=8) d_ff=16384
(per expert), vocab=32768, MoE 8e top-2, SWA 4096.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=16384, vocab_size=32768,
        n_experts=8, top_k=2, sliding_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=64, vocab_size=256,
        n_experts=4, top_k=2, sliding_window=16,
    )
