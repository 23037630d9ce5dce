"""Losses: masked cross-entropy with z-loss (logit-norm regulariser).

The port of the JAX package's ``training/losses.py``.  On a mesh the
logits are a DTensor and the loss is the whole microbatch's: each rank
reduces its block, and the sums over the ranks are DTensor's.  Logits cut
along the vocabulary take their log-sum-exp from each rank's block
(``_logsumexp``) and their gold logit from the rank that holds it
(``_gold``); they are never gathered whole."""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed.sharding import (
    block_start,
    block_take,
    local_apply,
)

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
    lse = _logsumexp(logits)
    gold = _gold(logits, safe)
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum() if tokens is None else tokens, min=1.0)
    ce = nll.sum() / denom
    zloss = (torch.square(lse) * mask).sum() / denom
    loss = ce + z_weight * zloss
    return loss, {"ce": ce, "zloss": zloss,
                  "tokens": mask.sum().to(torch.int32)}


def _logsumexp(x):
    """``torch.logsumexp`` over the last dim; a DTensor cut along it is
    reduced block by block, as ATen computes it: the max (its infinities
    zeroed) over every rank's block, then the log of the summed
    exponentials plus that max."""
    if not (isinstance(x, DTensor) and any(
            p.is_shard(x.ndim - 1) for p in x.placements)):
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x.detach(), dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def _gold(logits, labels):
    """``logits[..., labels]``.  A DTensor's is taken on each rank's block
    (DTensor's own gather would build the backward's zeros at the whole
    logits' shape on every rank): where the vocabulary is cut, the rank
    holding a label's logit gives it and the others zeros, a partial sum."""
    if not isinstance(logits, DTensor):
        return _take_last(labels, logits)
    last = logits.ndim - 1
    idx = tuple(Replicate() if p.is_shard(last) else p
                for p in logits.placements)
    out = tuple(Partial() if p.is_shard(last) else p
                for p in logits.placements)
    return local_apply(functools.partial(
        block_take, _take_last, first=block_start(logits, last), dim=last),
        (labels, logits), (idx, logits.placements), out)


def _take_last(idx, logits):
    """``logits[..., idx]``, one entry of the last dim a position."""
    return torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
