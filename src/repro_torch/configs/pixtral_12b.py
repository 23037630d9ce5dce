"""pixtral-12b — mistral-nemo-style decoder with a stub ViT frontend.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H
(GQA kv=8) d_ff=14336 vocab=131072.  The ViT is a STUB (assignment:
backbone only): input_specs provides 256 precomputed patch embeddings
[B, 256, d_model] prepended to seq_len−256 text tokens.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=131072,
        frontend="vision_stub", num_patches=256,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256,
        frontend="vision_stub", num_patches=4,
    )
