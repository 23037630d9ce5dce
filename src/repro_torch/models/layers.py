"""Shared neural layers: init helper, RMSNorm, RoPE, SwiGLU, embeddings.

The port of the JAX package's ``models/layers.py``, plus the places where
the port follows how XLA rounds the reference's bfloat16 arithmetic on the
CPU, so that a bfloat16 model computes what the reference computes
(``silu``/``sigmoid``, ``add_rms_norm``, and ``matmul``/``einsum``, through
which every product of the models runs).  Weights live in
``nn.Module``s whose attribute names are the keys of the JAX package's
parameter tree (``models.convert`` carries a tree across by those names);
the functions take the module and compute op for op as the reference does.
Weights are float32 masters, cast to the compute dtype at each use, as the
reference casts them.  The reference's ``shard`` annotations inside the
model are not placed here: the mesh train step is data parallel and runs
the model on whole weights (tensor-parallel compute is ``ROADMAP.md`` §1
item 5).  Each module's ``SPECS`` names its leaves' logical axes, by which
``distributed.sharding`` places the weights.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def param(*shape: int, device) -> nn.Parameter:
    """An uninitialised float32 weight (``init_params`` or
    ``from_reference_params`` fills it), frozen: a served model records no
    gradients, and ``training.init_train_state`` makes a model's weights
    require them."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               device=None) -> torch.Tensor:
    """A seeded standard normal in float32 times ``1/sqrt(fan_in)``."""
    fan_in = shape[in_axis]
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return out * (1.0 / math.sqrt(fan_in))


def _cpu_bf16(t) -> bool:
    return t.dtype == torch.bfloat16 and t.device.type == "cpu"


def matmul(a, b):
    """``a @ b``.  A bfloat16 product on the CPU is taken as a float32 one
    rounded once to bfloat16, as XLA's CPU backend computes the reference's
    bfloat16 dots: torch's CPU bfloat16 GEMM also rounds once, but sums in
    another order, and a last-bit difference in one entry is amplified
    through a few layers past the bfloat16 tests' bound.  On the card a
    bfloat16 GEMM runs as it is (float32 accumulation, its own order)."""
    if _cpu_bf16(a):
        return (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)
    return a @ b


def einsum(equation: str, *operands):
    """``torch.einsum``, with bfloat16 operands on the CPU contracted in
    float32 and rounded once, as ``matmul``."""
    if _cpu_bf16(operands[0]):
        return torch.einsum(equation, *(o.to(torch.float32)
                                        for o in operands)).to(torch.bfloat16)
    return torch.einsum(equation, *operands)


def rms_norm(x, weight, eps: float, dtype=None):
    """In float32, the weight applied as ``1 + w``, cast to ``dtype`` (x's
    own by default)."""
    dt = x.dtype if dtype is None else dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(dt)


def add_rms_norm(x, y, weight, eps: float):
    """``(x + y, rms_norm(x + y))``, the norm reading the sum before it is
    rounded to x's dtype.  XLA keeps a bfloat16 sum that the reference
    casts straight to float32 (``rms_norm``'s first step) in float32, and
    rounds only the copy the residual stream carries on; in float32 both
    are the plain sum."""
    s = x.to(torch.float32) + y
    return s.to(x.dtype), rms_norm(s, weight, eps, x.dtype)


def sigmoid(x):
    """``1 / (1 + exp(-x))`` with each step rounded to x's dtype: XLA
    expands the reference's logistic into these four operations and rounds
    a bfloat16 value after each, where ``torch.sigmoid`` rounds once."""
    return torch.reciprocal(1 + torch.exp(-x))


def silu(x):
    """``x · sigmoid(x)``, rounded as the reference's ``jax.nn.silu``
    (``sigmoid`` above)."""
    return x * sigmoid(x)


def rope(pos, d_head: int, theta: float):
    """Rotary tables: (sin, cos), each of shape pos.shape + [d_head/2]."""
    half = d_head // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=pos.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = pos.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """x: [..., n_heads, d_head]; sin/cos broadcastable to [..., d_head/2].
    The two halves rotate together (not interleaved pairs)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
class MLP(nn.Module):
    # each leaf's logical axes (the reference's ``mlp_init`` specs)
    SPECS = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
             "wo": ("mlp", "embed")}

    def __init__(self, d_model: int, d_ff: int, device=None):
        super().__init__()
        self.wi = param(d_model, d_ff, device=device)
        self.wg = param(d_model, d_ff, device=device)
        self.wo = param(d_ff, d_model, device=device)


def mlp_apply(p: MLP, x, dtype):
    h = matmul(x, p.wi.to(dtype))
    g = matmul(x, p.wg.to(dtype))
    return matmul(silu(g) * h, p.wo.to(dtype))


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
class Embed(nn.Module):
    SPECS = {"embedding": ("vocab", "embed"), "unembed": ("embed", "vocab")}

    def __init__(self, vocab: int, d_model: int, tie: bool, device=None):
        super().__init__()
        self.embedding = param(vocab, d_model, device=device)
        self.unembed = None if tie else param(d_model, vocab, device=device)


def embed_apply(p: Embed, tokens, dtype):
    """The rows are gathered before the cast, which the reference does after
    (``take`` of the cast table): the cast is elementwise, so the bits are
    the same, and only the gathered rows are cast.  The gather is
    ``F.embedding``, whose backward sums each row's gradients in a fixed
    order on the CPU as on the card: an indexing gather's backward (an
    accumulating ``index_put_``) adds with atomics across CPU threads, and
    a train step was not bitwise repeatable."""
    return nn.functional.embedding(tokens, p.embedding).to(dtype)


def unembed_apply(p: Embed, x, dtype, softcap: float = 0.0):
    """Logits in the compute dtype; the embedding's transpose when tied."""
    w = p.unembed if p.unembed is not None else p.embedding.T
    logits = matmul(x, w.to(dtype))
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
