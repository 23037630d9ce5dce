"""Assigned-architecture registry: full configs, smoke configs, shapes.

The port's copy of the JAX package's registry (pure data; the port imports
nothing of that package).  ``get_config(name)`` returns the exact published
configuration; ``get_smoke_config(name)`` a reduced same-family config for
CPU tests.

Input-shape cells (assignment):
    train_4k     seq 4096  × global_batch 256   (train_step)
    prefill_32k  seq 32768 × global_batch 32    (serve: prefill)
    decode_32k   seq 32768 × global_batch 128   (serve: 1 token, 32k KV)
    long_500k    seq 524288 × global_batch 1    (serve: 1 token, 500k KV;
                 sub-quadratic archs only)
"""

from __future__ import annotations

import dataclasses
import importlib

ARCHS = (
    "zamba2-1.2b",
    "musicgen-large",
    "moonshot-v1-16b-a3b",
    "mixtral-8x22b",
    "gemma3-1b",
    "smollm-135m",
    "h2o-danube-3-4b",
    "qwen3-14b",
    "pixtral-12b",
    "rwkv6-1.6b",
)

_MODULES = {name: "repro_torch.configs."
            + name.replace("-", "_").replace(".", "p") for name in ARCHS}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"
    microbatch: int = 0  # train: per-step microbatch rows (0 = whole batch)


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train", microbatch=32),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def get_config(name: str):
    mod = importlib.import_module(_MODULES[name])
    return mod.config()


def get_smoke_config(name: str):
    mod = importlib.import_module(_MODULES[name])
    return mod.smoke_config()


def cells_for(name: str):
    """The shape cells this arch runs (long_500k only when sub-quadratic)."""
    cfg = get_config(name)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out
