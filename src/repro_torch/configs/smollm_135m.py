"""smollm-135m — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-135M; hf]  30L d_model=576 9H (GQA kv=3)
d_ff=1536 vocab=49152.  Also the end-to-end training-example model.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
        d_ff=1536, vocab_size=49152,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=3, d_head=16,
        d_ff=96, vocab_size=256,
    )
