"""Mixture-of-Experts layer: top-k router, capacity-bounded scatter
dispatch, per-expert SwiGLU, optional shared experts (Moonlight-style).

The port of the JAX package's ``models/moe.py``, op for op: a float32
softmax router, top-k with the gate renormalised, first-come-first-served
positions within each expert from a stable sort, a linear-index scatter
into an ``[e·(cap+1), d]`` buffer whose row ``cap`` of each expert is the
trash row of dropped tokens, the experts as batched einsums, a gather +
gate-weighted combine, the shared expert, and the aux values
``load_balance``, ``router_z`` and ``dropped_frac``.

On a mesh the layer reads the whole microbatch: its capacity, first-come
positions over the microbatch in row order and aux values are the whole
microbatch's, whichever row block of it a rank holds
(``distributed.sharding.row_blocks``; one exchange of per-expert counts
a layer).  The mesh train step on placed weights, and a placed model's
``prefill`` and ``decode_step`` on a mesh, hand it a DTensor residual
stream (``_placed_moe``): the experts stay cut along their
expert dim, and the tokens move to the ranks holding their experts'
buffer blocks and back at the reference's ``shard()`` points.  On the
gather path each rank runs the experts on whole weights over its own
``[e, cap]`` buffer (``moe_apply`` on a plain tensor).

``load_stats`` is expert load as ``SELECT expert, COUNT(*) GROUP BY
expert`` through the query engine's ``group_by_sum``: on the card it
launches the segmented-sum kernel K3.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (
    block_start,
    current_row_blocks,
    expert_weight_use,
    local_apply,
    match,
    placements,
    redistribute_stepwise,
    replicated_like,
    resolve_spec,
    spec_axes,
    weight_use,
)
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
    return _route(xt, p.router.to(dtype), cfg.top_k)


def _route(xt, router, k: int):
    """``route`` with the router weight in use (cast) given."""
    logits = matmul(xt, router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = top.values[:, :k]
    expert_idx = top.indices[:, :k]
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


# --------------------------------------------------------------------------
# the layer's stages, on whole tensors or on one rank's blocks
# --------------------------------------------------------------------------
def _dispatch(xt, lin, e: int, cap: int, k: int, dtype):
    """Each (token, choice) of ``xt`` [t, d] scattered to buffer row
    ``lin`` of a zero ``[e·(cap+1), d]`` buffer (row ``cap`` of each expert
    the trash row of dropped tokens), which is returned without its trash
    rows: ``[e, cap, d]``."""
    d = xt.shape[-1]
    buf = torch.zeros((e * (cap + 1), d), dtype=dtype, device=xt.device)
    buf[lin] = torch.repeat_interleave(xt, k, dim=0).to(dtype)
    return buf.reshape(e, cap + 1, d)[:, :cap]


def _experts(buf, wi, wg, wo):
    """The batched per-expert SwiGLU of ``buf`` [e, cap, d]."""
    h = einsum("ecd,edf->ecf", buf, wi)
    g = einsum("ecd,edf->ecf", buf, wg)
    return einsum("ecf,efd->ecd", silu(g) * h, wo)


def _combine(out_buf, gate, lin_out, keep, k: int, dtype):
    """Each (token, choice)'s row ``lin_out`` of ``out_buf`` [e, cap, d]
    weighted by its gate (zero where dropped), summed over the choices:
    [t, d]."""
    d = out_buf.shape[-1]
    w = (gate.reshape(-1) * keep).to(dtype)
    rows = out_buf.reshape(-1, d)[lin_out] * w[:, None]
    return rows.reshape(-1, k, d).sum(dim=1)


def _aux(logits, probs, total, e: int, tokens: int):
    """``load_balance`` and ``router_z`` of the tokens whose router
    outputs are ``logits`` and ``probs`` [t, e], as their share of a
    microbatch of ``tokens`` tokens whose summed assignment counts are
    ``total``."""
    density = total.to(torch.float32) / tokens
    lse = torch.logsumexp(logits, -1)
    return (e * torch.sum(density * (probs.sum(dim=0) / tokens)),
            torch.sum(torch.square(lse)) / tokens)


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

    A DTensor ``x`` (the mesh step on placed weights) takes
    ``_placed_moe``.
    """
    if isinstance(x, DTensor):
        return _placed_moe(p, cfg, x, dtype)
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
    flat_e = expert_idx.reshape(t * k)
    pos, at, _, total = first_come(flat_e, e, blocks)
    keep = at < cap

    # scatter into the buffer by linear row index; row cap is the trash
    flat_pos = torch.where(keep, pos, cap)
    buf = _dispatch(xt, flat_e * (cap + 1) + flat_pos, e, cap, k, dtype)
    out_buf = _experts(buf, p.wi.to(dtype), p.wg.to(dtype), p.wo.to(dtype))
    lin_out = flat_e * cap + torch.clamp(flat_pos, max=cap - 1)
    out = _combine(out_buf, gate, lin_out, keep, k, dtype)

    if p.shared is not None:
        out = out + mlp_apply(p.shared, xt, dtype)

    # aux losses (Switch-style load balance + router z-loss)
    load_balance, router_z = _aux(logits, probs, total, e, n * t)
    return out.reshape(b, s, d), {
        "load_balance": load_balance, "router_z": router_z,
        "dropped_frac": _dropped_frac(total, cap, n * t * k)}


def _dropped_frac(total, cap: int, n_assign: int):
    kept = torch.clamp(total, max=cap).sum().to(torch.float32)
    return 1.0 - kept / n_assign


def _placed_moe(p: MoE, cfg: ModelConfig, x, dtype):
    """``moe_apply`` of a microbatch whose residual stream ``x`` [B, S, D]
    is a DTensor (its rows cut over the batch axes that divide them, its
    sequence over "model"), on the placed weights, at the reference's
    ``shard()`` points.  The mesh train step calls it on each microbatch,
    and a MoE model's ``prefill`` (the sequence over "model") and
    ``decode_step`` (``S = 1``) on a mesh on the served batch; each sets
    the row blocks of the rows it hands in (``sharding.row_blocks``: the
    step from the microbatch's spec, serving from the batch rule,
    ``sharding.batch_row_blocks``), which must name the blocks that
    ``x``'s placements cut its rows into, or it raises ``ValueError``.
    In serving the aux values are not read: they stay this rank's
    partial sums, and no collective is issued for them.

      * tokens: ``x`` gathered along "model" (``("batch", None, None)``),
        so that every rank of a row block holds its rows whole and in the
        microbatch's (row, position) order; the router's float32 logits
        from the whole ``d`` on every such rank (the same product of the
        same bits); the dispatched tokens are this rank's block of ``d``
        ("dispatch_embed"), a slice of what it holds.  One all-gather of
        the block's ``[rows, S, D]`` where the reference's
        ``("batch", "dispatch_embed")`` point moves the sequence cut to
        ``d`` and a ``d`` gather feeds the router;
      * positions: the row block's first-come positions in the microbatch
        (``first_come`` over ``row_blocks``, one ``[n, e]`` count table a
        layer), the capacity the microbatch's;
      * dispatch: each rank scatters its kept assignments at their
        positions in the microbatch into a zero ``[e, cap, D/model]``
        buffer (``(None, "dispatch_embed")``), a partial sum over the mesh
        dims that cut the rows (the ranks' slots are disjoint), the same
        on a batch axis the rows do not divide; the buffer is
        reduce-scattered onto ``("experts", None, "act_embed")``, one mesh
        dim at a time, and gathered along "model".  Each rank sends its
        whole ``[e, cap, D/model]`` buffer into the reduce-scatter: 1/model
        of the whole buffer, however few of its slots it filled (an
        exchange of the rank's own assignments alone is a later change);
      * experts: ``h`` and ``g`` (``("experts", None, "expert_mlp")``) and
        ``wo``'s product on each rank's blocks, the weights as
        ``expert_weight_use`` gives them: still cut along each mesh dim
        that cuts their expert dim (the buffer's expert dim resolves the
        same rule on the same ``e``), gathered along the other
        data-parallel axes, cut along "model".  Where the experts do not
        divide by their axes (mixtral's 8 on 16 or 32 ranks), the freed
        axis cuts the weights' ``d`` and the buffer's capacity: the
        weights are gathered along it, and each rank runs every expert
        on its slice of the capacity;
      * combine: ``wo``'s partial sums reduce-scattered over "model" onto
        ``d`` and gathered along the axes that cut ``e`` or ``cap``
        (``(None, "dispatch_embed")``: whole ``e·cap`` rows); each rank
        reads its tokens' rows at their microbatch positions, weights
        them by the gate and sums over ``k``; the caller puts the result
        in the residual's placement;
      * the shared expert: ``mlp_apply``, the dense block's MLP, on the
        gathered rows (which its column-parallel products would gather;
        the backward then sums the tokens' gradients in the one-device
        order);
      * aux: ``load_balance`` and ``router_z`` this rank's shares, partial
        sums over the mesh dims that cut the rows and replicated on every
        other (each rank of a row block holds the same tokens);
        ``density`` and ``dropped_frac`` from the summed int32 counts,
        replicated.

    ``cfg.dispatch_reshard`` has no effect: the buffer always takes the
    expert placement that every config's True asks for."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    blocks = current_row_blocks()
    _check_row_blocks(x, blocks)
    cap = _capacity(cfg, b * s)
    # this rank's rows whole, and their block of d
    rows = tuple(pl.is_shard(0) for pl in x.placements)
    tok = tuple(Shard(0) if r else Replicate() for r in rows)
    d_axes = spec_axes(resolve_spec((d,), ("dispatch_embed",))[0])
    tok_d = tuple(Shard(2) if a in d_axes else pl
                  for a, pl in zip(names, tok))
    xw = x.redistribute(mesh, tok)

    # the router whole ("embed", None: weight_use gathers it whole)
    logits, probs, gate, expert_idx = local_apply(
        lambda xl, r: _route(xl.reshape(-1, d), r, k),
        (xw, weight_use(p.router, dtype)),
        (tok, (Replicate(),) * mesh.ndim), tok)

    flat_e = expert_idx.to_local().reshape(-1)
    _, at, _, total = first_come(flat_e, e, blocks)
    keep = at < cap
    slot = torch.where(keep, at, cap)

    # dispatch: disjoint slots of one [e, cap, d] buffer, summed onto the
    # expert blocks
    partial = tuple(Partial() if r else Replicate() for r in rows)
    buf = local_apply(
        lambda xl: _dispatch(xl.reshape(-1, xl.shape[-1]),
                             flat_e * (cap + 1) + slot, e, cap, k, dtype),
        (xw,), (tok_d,),
        tuple(Shard(2) if a in d_axes else pl
              for a, pl in zip(names, partial)))
    buf = redistribute_stepwise(buf, placements(resolve_spec(
        (e, cap, d), ("experts", None, "act_embed")), mesh))

    wi, wg, wo = (expert_weight_use(w, dtype) for w in (p.wi, p.wg, p.wo))
    out_pl = _expert_placements(buf, wi, wo)
    out_buf = local_apply(_experts, (buf, wi, wg, wo), (
        buf.placements, wi.placements, wg.placements, wo.placements),
        out_pl)

    # combine: whole e·cap rows, d cut as the dispatched tokens were
    out_buf = redistribute_stepwise(out_buf, tuple(
        Shard(2) if a in d_axes else Replicate() for a in names))
    lin_out = flat_e * cap + torch.clamp(slot, max=cap - 1)
    out = local_apply(
        lambda ob, g: _combine(ob, g, lin_out, keep, k, dtype).reshape(
            -1, s, ob.shape[-1]),
        (out_buf, gate), (out_buf.placements, tok), tok_d)
    out = match(out, x)
    if p.shared is not None:
        out = out + match(mlp_apply(p.shared, xw, dtype), x)

    load_balance, router_z = local_apply(
        lambda lg, pr: _aux(lg, pr, total, e, b * s), (logits, probs),
        (tok, tok), partial)
    return out, {
        "load_balance": load_balance, "router_z": router_z,
        "dropped_frac": replicated_like(
            _dropped_frac(total, cap, b * s * k), x)}


def _check_row_blocks(x, blocks) -> None:
    """Raises ``ValueError`` unless the row blocks ``blocks`` name the
    blocks that the residual ``x``'s placements cut its rows into, and
    this rank's among them (None where no mesh dim cuts them).  Without
    them each row block would number its assignments from 0, and the
    ranks' kept assignments would land in the same slots of the buffer,
    whose partial sums over the row blocks would add their tokens."""
    mesh = x.device_mesh
    count = math.prod(n for n, pl in zip(mesh.shape, x.placements)
                      if pl.is_shard(0))
    index = block_start(x, 0) * count // x.shape[0]
    have = (0, 1) if blocks is None else (blocks.index, blocks.count)
    if have != (index, count):
        raise ValueError(
            f"the MoE layer's rows are row block {index} of {count} "
            f"({x.placements} on {mesh.mesh_dim_names}), the row blocks "
            f"set say {blocks}: set sharding.row_blocks (the mesh step "
            f"and a mesh's prefill and decode_step do)")


def _expert_placements(buf, wi, wo) -> tuple:
    """The placements of the experts' output ``[e, cap, d]`` from the
    buffer's and the weights' in use, mesh dim by mesh dim: cut as the
    buffer's experts or capacity are, a partial sum where "model" cuts
    ``d_ff``, whole elsewhere.  Any other layout raises."""
    out = []
    for bp, ip, op in zip(buf.placements, wi.placements, wo.placements):
        if bp.is_shard(0) and ip.is_shard(0) and op.is_shard(0):
            out.append(Shard(0))
        elif bp.is_shard(1) and ip.is_replicate() and op.is_replicate():
            out.append(Shard(1))
        elif bp.is_replicate() and ip.is_shard(2) and op.is_shard(1):
            out.append(Partial())
        elif bp.is_replicate() and ip.is_replicate() and op.is_replicate():
            out.append(Replicate())
        else:
            raise ValueError(f"experts on a buffer {buf.placements} and "
                             f"weights {ip}, {op}: no block-local product")
    return tuple(out)


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
