"""musicgen-large — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048.  The EnCodec frontend + codebook delay pattern are STUBs
(assignment: backbone only); input is a single pre-delayed token stream.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="dense",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
        d_ff=8192, vocab_size=2048,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=64,
    )
