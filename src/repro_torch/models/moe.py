"""Mixture-of-Experts layer: top-k router, capacity-bounded scatter
dispatch, per-expert SwiGLU, optional shared experts (Moonlight-style).

The port of the JAX package's ``models/moe.py``, op for op: a float32
softmax router, top-k with the gate renormalised, first-come-first-served
positions within each expert from a stable sort, a linear-index scatter
into an ``[e·(cap+1), d]`` buffer whose row ``cap`` of each expert is the
trash row of dropped tokens, the experts as batched einsums, a gather +
gate-weighted combine, the shared expert, and the aux values
``load_balance``, ``router_z`` and ``dropped_frac``.

On the gather path of the mesh train step a rank holds one row block of
each microbatch (``distributed.sharding.row_blocks``), and ``moe_apply``
computes what the whole microbatch gives its rows, as the reference does
on the whole: the capacity from every block's tokens, first-come
positions over the microbatch in row order (one exchange of per-expert
counts a layer), and the aux values over every token.

``load_stats`` is expert load as ``SELECT expert, COUNT(*) GROUP BY
expert`` through the query engine's ``group_by_sum``: on the card it
launches the segmented-sum kernel K3.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed.sharding import current_row_blocks
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    einsum,
    matmul,
    mlp_apply,
    param,
    silu,
)


class MoE(nn.Module):
    SPECS = {"router": ("embed", None),
             "wi": ("experts", None, "expert_mlp"),
             "wg": ("experts", None, "expert_mlp"),
             "wo": ("experts", "expert_mlp", None)}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = param(d, e, device=device)
        self.wi = param(e, d, f, device=device)
        self.wg = param(e, d, f, device=device)
        self.wo = param(e, f, d, device=device)
        self.shared = (MLP(d, f * cfg.n_shared_experts, device)
                       if cfg.n_shared_experts else None)

    def forward(self, cfg: ModelConfig, x, dtype):
        """``moe_apply`` as a module call, so that forward hooks see each
        layer's input."""
        return moe_apply(self, cfg, x, dtype)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def route(p: MoE, cfg: ModelConfig, xt, dtype):
    """Router over tokens ``xt`` [t, d]: float32 ``(logits, probs)`` [t, e]
    and the renormalised ``(gate, expert_idx)`` [t, k].  Ties go to the
    lower expert index, as ``jax.lax.top_k`` breaks them: a stable
    descending sort keeps equal probabilities in index order, where
    ``torch.topk`` promises no order."""
    logits = matmul(xt, p.router.to(dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = top.values[:, :cfg.top_k]
    expert_idx = top.indices[:, :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, expert_idx


def first_come(flat_e, e: int, blocks=None):
    """Each assignment's place in its expert, first come first served in
    row order, for assignments ``flat_e`` (expert ids in (token, choice)
    order) of row block ``blocks.index`` of ``blocks.count`` (of the whole
    microbatch where ``blocks`` is None).  Returns ``(pos,
    at, counts, total)``: ``pos`` each assignment's stable position among
    the block's assignments to its expert and ``at`` its position in the
    microbatch (``pos`` plus the earlier blocks' assignments to the
    expert), both int32; ``counts`` the block's assignments per expert
    (float32) and ``total`` the microbatch's (int32)."""
    n_assign = flat_e.numel()
    dev = flat_e.device
    # a stable sort by expert gives first-come-first-served positions
    sorted_e, order = torch.sort(flat_e, stable=True)
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_sorted = torch.arange(n_assign, device=dev) - seg_start[sorted_e]
    pos = torch.zeros(n_assign, dtype=torch.int32, device=dev)
    pos[order] = pos_sorted.to(torch.int32)
    # counts by index_add_, as the reference's scatter-add: bincount on the
    # card reads its input's maximum back to the host
    counts = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(n_assign, dtype=torch.float32, device=dev))
    if blocks is None:
        return pos, pos, counts, counts.to(torch.int32)
    table = torch.zeros((blocks.count, e), dtype=torch.int32, device=dev)
    table[blocks.index] = counts.to(torch.int32)
    dist.all_reduce(table, group=blocks.group)
    before = table[:blocks.index].sum(dim=0, dtype=torch.int32)
    return (pos, pos + before[flat_e], counts,
            table.sum(dim=0, dtype=torch.int32))


def moe_apply(p: MoE, cfg: ModelConfig, x, dtype):
    """x: [B, S, D] → ([B, S, D], aux dict of float32 scalars).

    Under ``row_blocks`` ``x`` is block ``i`` of ``n`` equal row blocks
    of a microbatch of ``t = n·B·S`` tokens, and the capacity is ``t``'s.
    Each block's per-expert assignment counts are summed over the group in
    one ``all_reduce`` (each rank writes row ``i`` of a zero ``[n, e]``
    int32 table, so the group's rank order does not matter), and an
    assignment's position is its stable position in the block plus the
    counts of the blocks before it.  A rank scatters its kept assignments
    at their positions in the block (each below its position in the
    microbatch, so below the capacity) and runs the experts on its own
    ``[e, cap]`` buffer.  ``density`` and ``dropped_frac`` come from the
    summed counts: whole and equal on every rank.  ``load_balance`` and
    ``router_z`` read every token's router output and carry gradient, so
    each rank returns its share (its tokens' sums over ``t``); summed over
    the group they are the microbatch's values and gradients.  Outside
    ``row_blocks`` (one device, or a mesh whose batch axes leave the rows
    whole) ``x`` is the whole microbatch, ``n`` is 1, and the same
    formulas give the whole values.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    blocks = current_row_blocks()
    n = 1 if blocks is None else blocks.count
    cap = _capacity(cfg, n * t)
    xt = x.reshape(t, d)
    logits, probs, gate, expert_idx = route(p, cfg, xt, dtype)

    # position of each (token, choice) within its expert, first come first
    # served over the microbatch; over capacity drops
    n_assign = t * k
    flat_e = expert_idx.reshape(n_assign)
    pos, at, _, total = first_come(flat_e, e, blocks)
    keep = at < cap

    # scatter into the buffer by linear row index; row cap is the trash
    flat_pos = torch.where(keep, pos, cap)
    lin = flat_e * (cap + 1) + flat_pos
    buf = torch.zeros((e * (cap + 1), d), dtype=dtype, device=x.device)
    buf[lin] = torch.repeat_interleave(xt, k, dim=0).to(dtype)
    buf = buf.reshape(e, cap + 1, d)[:, :cap]

    # batched per-expert SwiGLU
    h = einsum("ecd,edf->ecf", buf, p.wi.to(dtype))
    g = einsum("ecd,edf->ecf", buf, p.wg.to(dtype))
    out_buf = einsum("ecf,efd->ecd", silu(g) * h, p.wo.to(dtype))
    out_buf = out_buf.reshape(e * cap, d)

    # combine: gather each (token, choice) result, weight by gate
    lin_out = flat_e * cap + torch.clamp(flat_pos, max=cap - 1)
    w = (gate.reshape(n_assign) * keep).to(dtype)
    out = (out_buf[lin_out] * w[:, None]).reshape(t, k, d).sum(dim=1)

    if p.shared is not None:
        out = out + mlp_apply(p.shared, xt, dtype)

    # aux losses (Switch-style load balance + router z-loss)
    lse = torch.logsumexp(logits, -1)
    density = total.to(torch.float32) / (n * t)
    kept = torch.clamp(total, max=cap).sum().to(torch.float32)
    aux = {
        "load_balance": e * torch.sum(density * (probs.sum(dim=0) / (n * t))),
        "router_z": torch.sum(torch.square(lse)) / (n * t),
        "dropped_frac": 1.0 - kept / (n * n_assign),
    }
    return out.reshape(b, s, d), aux


def load_stats(expert_idx, n_experts: int):
    """Expert load = ``SELECT expert, COUNT(*) GROUP BY expert`` over the
    (token → expert) assignment relation, through the query engine's
    stable sort and segmented sum (K3 on the card): int32 ``[n_experts]``."""
    flat = expert_idx.reshape(-1).to(torch.int32)
    keys, sums, valid = kops.group_by_sum(flat, torch.ones_like(flat))
    loads = torch.zeros(n_experts + 1, dtype=torch.int32, device=flat.device)
    loads.index_add_(0, torch.where(valid, keys, n_experts).long(),
                     torch.where(valid, sums, 0))
    return loads[:n_experts]
