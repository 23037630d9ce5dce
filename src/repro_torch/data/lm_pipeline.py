"""Deterministic, shardable LM token pipeline.

The port of the JAX package's ``data/lm_pipeline.py``.  Batches are a pure
function of (seed, step), so

  * resuming from a checkpoint replays exactly the same stream (no
    data-loader state to persist beyond the step);
  * any host can compute any shard of any batch (a job restarted with
    another data-parallel degree re-slices the same stream);
  * a slow host can skip ahead to ``batch_at(step + 1)`` without
    coordination, since the schedule is static.

The source is a synthetic Zipf-flavoured token sampler; the ``corpus`` hook
takes any memory-mapped token array.  ``batch_at`` and ``shard_at`` are
numpy and draw the reference's arrays; ``torch_batch`` puts a batch on a
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus: np.ndarray | None = None  # optional real token stream

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Full global batch for `step` (host-level, numpy)."""
        if self.corpus is not None:
            n = self.global_batch * (self.seq_len + 1)
            start = (step * n) % max(1, len(self.corpus) - n)
            flat = self.corpus[start:start + n]
            toks = flat.reshape(self.global_batch, self.seq_len + 1)
        else:
            rng = np.random.default_rng((self.seed, step))
            # zipf-flavoured token stream, clipped into the vocab
            toks = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
            toks = (toks % self.vocab_size).astype(np.int32)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def shard_at(self, step: int, shard: int, num_shards: int):
        """Rows of the global batch owned by `shard` — any host can compute
        any shard (see module docstring)."""
        b = self.batch_at(step)
        rows = self.global_batch // num_shards
        sl = slice(shard * rows, (shard + 1) * rows)
        return {k: v[sl] for k, v in b.items()}

    def torch_batch(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """``batch_at(step)`` as int32 tensors on ``device`` (the GPU unless
        the caller names another; a CUDA device without a card raises)."""
        device = resolve_device(device)
        return {k: torch.as_tensor(v, device=device)
                for k, v in self.batch_at(step).items()}
