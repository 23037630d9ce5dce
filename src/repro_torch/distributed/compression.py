"""Gradient compression: int8 quantisation with error feedback.

The port of the JAX package's ``distributed/compression.py``, its
per-step round trip: ``ef_int8_roundtrip`` quantises a gradient to int8
with one scale per tensor and back, so the train step sees the numeric
effect of sending ~4× fewer bytes (the residual stays in the gradient:
immediate error feedback).  Both packages round half to even, so the round
trip is bitwise the reference's.  The reference's ``CompressedPsum`` (the
int8 payload across a mesh axis, with a persistent residual) is a
collective and has no counterpart yet.
"""

from __future__ import annotations

import torch


def _quant(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Quantise → dequantise in float32, per-tensor scale; the result in
    g's dtype."""
    q, scale = _quant(g.to(torch.float32))
    return (q.to(torch.float32) * scale).to(g.dtype)
