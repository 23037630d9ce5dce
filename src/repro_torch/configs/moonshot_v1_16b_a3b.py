"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — 64-expert top-6 MoE.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert), vocab=163840, MoE 64e top-6 + 1 shared expert
(DeepSeek-V3-style; simplification noted in DESIGN.md §10).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab_size=163840,
        n_experts=64, top_k=6, n_shared_experts=1, capacity_factor=1.25,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=32, vocab_size=256,
        n_experts=8, top_k=2, n_shared_experts=1,
    )
