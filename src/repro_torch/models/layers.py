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
reference casts them (``sharding.weight_use``).  Each module's ``SPECS``
names its leaves' logical axes, by which ``distributed.sharding`` places
the weights.

On a mesh (the dense family's mesh train step) the weights are DTensors
and every function here computes on their blocks: a use gathers a weight
along the data-parallel axes only, ``matmul`` runs each rank's block of
the product (column-parallel where the weight's output dim is cut,
row-parallel with a partial sum where its input dim is), and the
reference's ``shard`` annotations are placed where it places them
(``mlp_apply``'s hidden, the embedding's output, the logits).  Off a mesh
every one of them is the identity.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (
    block_start,
    block_take,
    local_apply,
    replicated_like,
    shard,
    weight_use,
)


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


def _matmul(a, b):
    if _cpu_bf16(a):
        return (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)
    return a @ b


def matmul(a, b):
    """``a @ b``.  A bfloat16 product on the CPU is taken as a float32 one
    rounded once to bfloat16, as XLA's CPU backend computes the reference's
    bfloat16 dots: torch's CPU bfloat16 GEMM also rounds once, but sums in
    another order, and a last-bit difference in one entry is amplified
    through a few layers past the bfloat16 tests' bound.  On the card a
    bfloat16 GEMM runs as it is (float32 accumulation, its own order).

    ``a`` a DTensor and ``b`` a weight in use (``weight_use``): each rank
    multiplies its blocks, ``a`` laid out for ``b`` first
    (``matmul_operand``): the product is cut as ``a``'s rows and ``b``'s
    columns are, and partial where ``b``'s rows are cut."""
    if not isinstance(a, DTensor):
        return _matmul(a, b)
    a = matmul_operand(a, b)
    last = a.ndim - 1
    out = tuple(Partial() if bp.is_shard(0) else
                Shard(last) if bp.is_shard(1) else ap
                for ap, bp in zip(a.placements, b.placements))
    return local_apply(_matmul, (a, b), (a.placements, b.placements), out)


def matmul_operand(a, b):
    """``a`` (a DTensor) laid out to multiply the weight ``b`` block by
    block: cut along its last dim on each mesh dim that cuts ``b``'s rows,
    whole on each that cuts ``b``'s columns or that cuts ``a``'s last dim
    under a whole ``b``, and as it is elsewhere (its rows' cut, a partial
    sum).  Several products of one operand lay it out once."""
    last = a.ndim - 1
    want = tuple(Shard(last) if bp.is_shard(0) else
                 Replicate() if bp.is_shard(1) or ap.is_shard(last) else ap
                 for ap, bp in zip(a.placements, b.placements))
    return a if want == a.placements else a.redistribute(a.device_mesh,
                                                         want)


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
    wi, wg, wo = (weight_use(w, dtype) for w in (p.wi, p.wg, p.wo))
    if isinstance(x, DTensor):
        x = matmul_operand(x, wi)
    h = matmul(x, wi)
    g = matmul(x, wg)
    h = shard(silu(g) * h, "batch", "seq", "mlp")
    return matmul(h, wo)


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
    a train step was not bitwise repeatable.  On a mesh each rank looks up
    the tokens of its block of the vocabulary (``block_take``; the others are
    zeros, a partial sum), and the annotation point sums them."""
    w = weight_use(p.embedding)
    if not isinstance(w, DTensor):
        return nn.functional.embedding(tokens, w).to(dtype)
    tokens = replicated_like(tokens, w)
    out = tuple(Partial() if wp.is_shard(0) else tp
                for tp, wp in zip(tokens.placements, w.placements))
    out = local_apply(functools.partial(
        block_take, nn.functional.embedding, first=block_start(w, 0), dim=0),
        (tokens, w), (tokens.placements, w.placements), out)
    return shard(out, "batch", "seq", "act_embed").to(dtype)


def unembed_apply(p: Embed, x, dtype, softcap: float = 0.0):
    """Logits in the compute dtype; the embedding's transpose when tied."""
    w = p.unembed if p.unembed is not None else p.embedding.T
    logits = matmul(x, weight_use(w, dtype))
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return shard(logits, "batch", "seq", "vocab")
