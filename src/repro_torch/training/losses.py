"""Losses: masked cross-entropy with z-loss (logit-norm regulariser).

The port of the JAX package's ``training/losses.py``."""

from __future__ import annotations

import torch

IGNORE = -1  # label value excluded from the loss (e.g. image positions)


def cross_entropy_loss(logits, labels, z_weight: float = 1e-4):
    """logits [B,S,V] (any float dtype), labels [B,S] int (IGNORE masked),
    computed in float32.  Returns (loss, metrics): ``ce`` and ``zloss``
    float32, ``tokens`` (the unmasked labels) int32."""
    logits = logits.to(torch.float32)
    mask = (labels != IGNORE).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = nll.sum() / denom
    zloss = (torch.square(lse) * mask).sum() / denom
    loss = ce + z_weight * zloss
    return loss, {"ce": ce, "zloss": zloss,
                  "tokens": mask.sum().to(torch.int32)}
