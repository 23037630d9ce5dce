"""Attention: GQA + RoPE + optional qk-norm / sliding-window / local:global.

The port of the JAX package's ``models/attention.py``, with its three
execution paths kept apart because their numerics differ:

  * train   — dense masked attention; the scores are divided by sqrt(d_head)
              in the compute dtype (``forward`` runs it)
  * prefill — chunked online softmax over KV blocks of ``attn_chunk``; the
              scores are scaled by 1/sqrt(d_head) in float32
  * decode  — one new token against the whole ``[B, Smax]`` KV cache under
              the ``kp <= pos`` ∧ window mask; divided by sqrt(d_head) in
              float32

Plain ``torch.einsum`` and ``softmax``, as the reference is plain ``jnp``
(no Pallas kernel): ``scaled_dot_product_attention`` computes in another
order and would hide what the reference computes.  GQA computes grouped
einsums; ``n_kv_heads == 1`` (gemma3) is MQA.

On a mesh (the dense family's mesh train step and its partitioned
serving) the train and prefill paths place the reference's annotations:
the three projections' ``("batch", "seq", "heads_fused")`` and the
scores' ``("batch", "kv_heads", None, "q_seq", None)``.  The scores'
placement decides each rank's share of the attention: its KV heads where
their count divides the "model" axis, else its block of query positions
against every key (``_attend_placements``); each rank then runs the
one-device code on its blocks.  The decode path computes on the caches'
blocks as ``decode_state_specs`` places them (``_decode_placed``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (
    block_ranges,
    current_mesh,
    local_apply,
    placements,
    replicated_like,
    resolve_spec,
    shard,
    take_block,
    weight_use,
    write_block,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    einsum,
    matmul,
    matmul_operand,
    param,
    rms_norm,
    rope,
)

NEG_INF = -1e30


class Attention(nn.Module):
    """Projections in the fused head layout ``[d, h·hd]``, as the
    reference stores them."""
    SPECS = {"wq": ("embed", "heads_fused"), "wk": ("embed", "heads_fused"),
             "wv": ("embed", "heads_fused"), "wo": ("heads_fused", "embed"),
             "q_norm": ("head_dim",), "k_norm": ("head_dim",)}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = param(d, h * hd, device=device)
        self.wk = param(d, kv * hd, device=device)
        self.wv = param(d, kv * hd, device=device)
        self.wo = param(h * hd, d, device=device)
        self.q_norm = param(hd, device=device) if cfg.qk_norm else None
        self.k_norm = param(hd, device=device) if cfg.qk_norm else None


def window_of(cfg: ModelConfig) -> int | None:
    """gemma3's local window where layers alternate, else the SWA width."""
    return cfg.local_window if cfg.local_global_ratio else cfg.sliding_window


def _qkv(p: Attention, cfg: ModelConfig, x, pos, dtype):
    """Project + (qk-norm) + rope.  q [B,S,KV,G,hd], k and v [B,S,KV,hd]."""
    b, s = x.shape[:2]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    wq, wk, wv = (weight_use(w, dtype) for w in (p.wq, p.wk, p.wv))
    if isinstance(x, DTensor):
        x = matmul_operand(x, wq)
    q = _heads(shard(matmul(x, wq), "batch", "seq", "heads_fused"), h, hd)
    k = _heads(shard(matmul(x, wk), "batch", "seq", "heads_fused"), kv, hd)
    v = _heads(shard(matmul(x, wv), "batch", "seq", "heads_fused"), kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    sin, cos = (replicated_like(t, q) for t in rope(pos, hd, cfg.rope_theta))
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    return q.reshape(b, s, kv, h // kv, hd), k, v


def _heads(t, n: int, hd: int):
    """[B, S, n·hd] → [B, S, n, hd].  A DTensor cut along the fused dim
    (where the sequence could not take "model") is gathered along it
    first: DTensor does not split a cut dim."""
    if isinstance(t, DTensor) and any(p.is_shard(2) for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_shard(2) else p for p in t.placements])
    return t.reshape(*t.shape[:2], n, hd)


def _mask(q_pos, k_pos, window, is_global: bool):
    """[Sq, Sk] bool: causal ∧ (global ∨ within window)."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window is None or is_global:
        return causal
    return causal & ((q_pos[:, None] - k_pos[None, :]) < window)


def _sqrt_hd(hd: int) -> torch.Tensor:
    """sqrt(d_head) as the reference's float32 scalar (a CPU 0-dim tensor,
    which an op on the card takes as a scalar, with no copy)."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32)


def _attend(q, k, v, mask, hd: int, dtype):
    """Masked softmax attention of q [B,Sq,KV,G,hd] over k, v [B,Sk,KV,hd]
    under mask [Sq, Sk], scores divided by sqrt(d_head) in the compute
    dtype.  Returns [B,Sq,KV·G·hd]."""
    scores = einsum("bqhgk,bshk->bhgqs", q, k) / _sqrt_hd(hd).to(dtype)
    scores = torch.where(mask, scores.to(torch.float32), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(*out.shape[:2], -1)


def _attend_placements(q, sk: int | None = None) -> tuple:
    """``_attend``'s operands' and output's placements on the current mesh
    from the reference's scores annotation ``("batch", "kv_heads", None,
    "q_seq", None)`` of the scores [B,KV,G,Sq,Sk] (``sk`` keys, Sq by
    default): a mesh axis that cuts B, KV or Sq cuts q and the output
    there, k and v where it cuts B or KV, the mask (or a vector of the
    query positions) where it cuts Sq.  An axis on G or on the keys
    computes them whole: the output's fused heads would not be one block,
    and the softmax would run across ranks."""
    mesh = current_mesh()
    b, sq, kvh, g, _ = q.shape
    sb, skv, _, sq_, _ = resolve_spec(
        (b, kvh, g, sq, sq if sk is None else sk),
        ("batch", "kv_heads", None, "q_seq", None))
    kv = placements((sb, None, skv, None), mesh)
    return ([placements((sb, sq_, skv, None, None), mesh), kv, kv,
             placements((sq_, None), mesh)], placements((sb, sq_, skv), mesh))


def attention_train(p: Attention, cfg: ModelConfig, x, pos, is_global: bool,
                    dtype):
    """Dense masked attention (``forward``'s path)."""
    q, k, v = _qkv(p, cfg, x, pos, dtype)
    mask = _mask(pos[0], pos[0], window_of(cfg), is_global)
    attend = functools.partial(_attend, hd=cfg.d_head, dtype=dtype)
    if isinstance(q, DTensor):
        o = local_apply(attend, (q, k, v, mask), *_attend_placements(q))
    else:
        o = attend(q, k, v, mask)
    return matmul(o, weight_use(p.wo, dtype))


def attention_prefill(p: Attention, cfg: ModelConfig, x, pos,
                      is_global: bool, dtype):
    """Chunked online-softmax attention (inference prefill).  Returns
    ``(out, k, v)``: the prefix's keys and values feed the cache, where the
    reference projects them a second time with the same bits.

    On a mesh the chunk loop is placed by the reference's scores
    annotation (``_attend_placements`` of the chunk scores
    [B,KV,G,S,chunk]): each rank runs the one-device loop on its block of
    query positions (or of KV heads, where their count divides "model")
    against every key, so k and v are gathered along the sequence over
    "model" first, and the returned k and v are those gathered blocks.
    For qwen3-14b's ``prefill_32k`` on (16, 16) (8 KV heads: the query
    positions take "model") a rank gathers k and v of [32/16, 32768, 8,
    128] bfloat16, 134 MB each, 268 MB a layer, of which it held 1/16."""
    s = x.shape[1]
    chunk = min(cfg.attn_chunk, s)
    if s % chunk:
        raise ValueError(f"prefill length {s} is not a multiple of the "
                         f"attention chunk {chunk}")
    q, k, v = _qkv(p, cfg, x, pos, dtype)
    run = functools.partial(_prefill_attend, chunk=chunk,
                            window=window_of(cfg), is_global=is_global,
                            hd=cfg.d_head, dtype=dtype)
    qp = pos[0]
    if isinstance(q, DTensor):
        (q_pl, kv_pl, _, rows_pl), out_pl = _attend_placements(q, chunk)
        k, v = (t.redistribute(t.device_mesh, kv_pl) for t in (k, v))
        whole = (Replicate(),) * len(kv_pl)
        out = local_apply(run, (q, k, v, qp, qp),
                          (q_pl, kv_pl, kv_pl, rows_pl, whole), out_pl)
    else:
        out = run(q, k, v, qp, qp)
    return matmul(out, weight_use(p.wo, dtype)), k, v


def _prefill_attend(q, k, v, qp, kp, chunk: int, window, is_global: bool,
                    hd: int, dtype):
    """The online softmax of q [B,Sq,KV,G,hd] at query positions ``qp``
    [Sq] over k, v [B,Sk,KV,hd] at key positions ``kp`` [Sk], ``chunk``
    keys at a time, the scores scaled by 1/sqrt(d_head) in float32; the
    mask reads the global positions (a rank's block of queries need not
    start at 0).  Returns [B,Sq,KV·G·hd]."""
    b, sq, kvh, g, _ = q.shape
    scale = 1.0 / _sqrt_hd(hd)
    f32 = torch.float32
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=f32, device=q.device)
    for idx in range(k.shape[1] // chunk):
        keys = slice(idx * chunk, (idx + 1) * chunk)
        msk = _mask(qp, kp[keys], window, is_global)
        sc = einsum("bqhgk,bshk->bhgqs", q, k[:, keys]).to(f32) * scale
        sc = torch.where(msk, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(sc - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + einsum(
            "bhgqs,bshk->bhgqk", pexp.to(dtype), v[:, keys]).to(f32)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)
    return torch.movedim(out, 3, 1).reshape(b, sq, kvh * g * hd)


def attention_decode(p: Attention, cfg: ModelConfig, x, cache_k, cache_v,
                     pos: int, is_global: bool, dtype):
    """One new token per row against the KV cache.

    x: [B, 1, D]; cache_k/v: [B, Smax, KV, hd], written IN PLACE at the
    host position ``pos`` (the reference returns updated copies).  Returns
    out [B, 1, D].  On a mesh the caches are DTensors of each rank's
    block, as ``decode_state_specs`` places them (``_decode_placed``)."""
    b = x.shape[0]
    smax = cache_k.shape[1]
    if not 0 <= pos < smax:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{smax} positions")
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, posv, dtype)
    kp = torch.arange(smax, device=x.device)
    valid = kp <= pos
    window = window_of(cfg)
    if window is not None and not is_global:
        valid = valid & ((pos - kp) < window)
    if isinstance(cache_k, DTensor):
        out = _decode_placed(q, k, v, cache_k, cache_v, pos, valid,
                             cfg.d_head, dtype)
    else:
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        out = _decode_attend(q, cache_k, cache_v, valid, cfg.d_head, dtype)
        out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return matmul(out, weight_use(p.wo, dtype))


def _decode_attend(q, cache_k, cache_v, valid, hd: int, dtype,
                   scores=None, keys=None):
    """Softmax attention of q [B,1,KV,G,hd] over the caches [B,S,KV,hd]
    under ``valid`` [Smax], the scores divided by sqrt(d_head) in float32.
    On a mesh ``scores`` makes each rank's partial scores the whole rows
    (a sum over the head dim's blocks, a gather along the keys' blocks)
    and ``keys`` keeps the rank's block of the probabilities.  Returns
    [B,1,KV,G,hd] (partial sums over the keys' blocks on a mesh)."""
    sc = einsum("bqhgk,bshk->bhgqs", q, cache_k.to(dtype)).to(torch.float32)
    if scores is not None:
        sc = scores(sc)
    sc = sc / _sqrt_hd(hd)
    sc = torch.where(valid, sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1).to(dtype)
    if keys is not None:
        probs = probs[..., keys]
    return einsum("bhgqs,bshk->bqhgk", probs, cache_v.to(dtype))


def _by_cache_dim(cache_pl, b, s, kv, hd) -> tuple:
    """A placement for each mesh dim: ``b``, ``s``, ``kv`` or ``hd`` where
    it cuts the cache [B,S,KV,hd] along its batch, sequence, KV heads or
    head dim, ``Replicate()`` where it cuts none."""
    return tuple(Replicate() if p.is_replicate() else (b, s, kv, hd)[p.dim]
                 for p in cache_pl)


def _decode_placed(q, k, v, cache_k, cache_v, pos: int, valid, hd: int,
                   dtype):
    """``attention_decode`` on caches placed by ``decode_state_specs``,
    each rank on its own block: the batch over the data-parallel axes, and
    over "model" the KV heads, the head dim or the sequence.

    The new k and v, which every "model" rank holds whole (``_heads``
    gathered the projection's fused heads), are written into each rank's
    block at ``pos`` (only where its block of the sequence holds ``pos``),
    and q is cut the same way: local slices, no collective.  Each rank
    scores its block of the cache: where the head dim is cut the scores
    [B,KV,G,1,S] are partial sums, reduced; where the sequence is cut the
    rows are gathered along the keys, and each rank takes the one-device
    softmax over the whole row and keeps its block of the probabilities,
    whose product with its block of v is a partial sum, reduced.  Then the
    head dim's blocks of the output are gathered.  No rank gathers a
    cache.  Returns [B,1,KV·G·hd] cut as the cache's KV heads are."""
    mesh = cache_k.device_mesh
    cpl = cache_k.placements
    write_block(cache_k, k, 1, pos)
    write_block(cache_v, v, 1, pos)
    (b0, bn), (s0, sn), (h0, hn), (d0, dn) = block_ranges(cache_k)
    b, kvh, g = q.shape[0], q.shape[2], q.shape[3]
    ql = take_block(q, {0: (b0, bn), 2: (h0, hn), 4: (d0, dn)})
    smax = cache_k.shape[1]

    def whole_rows(sc):
        part = DTensor.from_local(
            sc, mesh, _by_cache_dim(cpl, Shard(0), Shard(4), Shard(1),
                                    Partial()),
            run_check=False, shape=(b, kvh, g, 1, smax),
            stride=_strides((b, kvh, g, 1, smax)))
        return part.redistribute(mesh, _by_cache_dim(
            cpl, Shard(0), Replicate(), Shard(1), Replicate())).to_local()

    out = _decode_attend(ql, cache_k.to_local(), cache_v.to_local(), valid,
                         hd, dtype, scores=whole_rows,
                         keys=slice(s0, s0 + sn))
    out = DTensor.from_local(
        out, mesh, _by_cache_dim(cpl, Shard(0), Partial(), Shard(2),
                                 Shard(4)),
        run_check=False, shape=(b, 1, kvh, g, hd),
        stride=_strides((b, 1, kvh, g, hd)))
    out = out.redistribute(mesh, _by_cache_dim(
        cpl, Shard(0), Replicate(), Shard(2), Replicate())).to_local()
    fused = (b, 1, kvh * g * hd)
    return DTensor.from_local(
        out.reshape(out.shape[0], 1, -1), mesh,
        _by_cache_dim(cpl, Shard(0), Replicate(), Shard(2), Replicate()),
        run_check=False, shape=fused, stride=_strides(fused))


def _strides(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()
