"""Losses: masked cross-entropy with z-loss (logit-norm regulariser).

The port of the JAX package's ``training/losses.py``."""

from __future__ import annotations

import torch

IGNORE = -1  # label value excluded from the loss (e.g. image positions)


def cross_entropy_loss(logits, labels, z_weight: float = 1e-4,
                       tokens: torch.Tensor | None = None):
    """logits [B,S,V] (any float dtype), labels [B,S] int (IGNORE masked),
    computed in float32.  Returns (loss, metrics): ``ce`` and ``zloss``
    float32, ``tokens`` (the unmasked labels) int32.  ``tokens``, where
    given, is the float32 count of unmasked labels the sums are divided by
    (a mesh step passes the whole microbatch's, so that each rank's loss
    is its rows' share of the microbatch's)."""
    logits = logits.to(torch.float32)
    mask = (labels != IGNORE).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum() if tokens is None else tokens, min=1.0)
    ce = nll.sum() / denom
    zloss = (torch.square(lse) * mask).sum() / denom
    loss = ce + z_weight * zloss
    return loss, {"ce": ce, "zloss": zloss,
                  "tokens": mask.sum().to(torch.int32)}
