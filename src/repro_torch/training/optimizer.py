"""AdamW with decoupled weight decay, global-norm clipping, and cosine LR.

The port of the JAX package's ``training/optimizer.py``: plain functions on
tensors keyed by parameter name (``dict(model.named_parameters())``), in
the reference's order of operations — clip by the global norm, update the
moments in float32 and store them in the state's dtype, bias-correct, then
decay every leaf.  ``torch.optim.AdamW`` places the decay and epsilon
otherwise.  Parameters are float32 masters; the model casts them at each
use.  The per-leaf arithmetic runs as ``torch._foreach_*`` ops over groups
of leaves (a few kernels a group, ``GROUP_ELEMENTS``), each the
reference's operation.  The step, the bias corrections and the schedule are float32
tensors on the parameters' device, as the reference computes them on its
device: nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

F32 = torch.float32


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor              # int32 scalar: updates taken
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def adamw_init(params: dict, state_dtype=torch.float32) -> AdamWState:
    """Zero moments like ``params`` in ``state_dtype`` (bfloat16 halves the
    optimizer's memory; the update's arithmetic stays float32)."""
    zeros = {n: torch.zeros_like(p, dtype=state_dtype)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v={n: z.clone() for n, z in zeros.items()})


def _f32(ts):
    return [t if t.dtype == F32 else t.to(F32) for t in ts]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in
    float32.  A DTensor leaf is the whole tensor: each rank squares its
    block's norm, and the squares are summed over the ranks holding the
    leaf's other blocks (one ``all_reduce`` a mesh dim, over the leaves cut
    along it), so every rank gets the same norm."""
    leaves = list(tree.values())
    local = [t.to_local() if isinstance(t, DTensor) else t for t in leaves]
    squares = torch.square(torch.stack(torch._foreach_norm(_f32(local))))
    placed = [t for t in leaves if isinstance(t, DTensor)]
    if placed:
        mesh = placed[0].device_mesh
        for d in range(mesh.ndim):
            if mesh.size(d) == 1:
                continue
            cut = [i for i, t in enumerate(leaves) if isinstance(t, DTensor)
                   and not (t.placements[d].is_replicate()
                            or t.placements[d].is_partial())]
            if cut:
                part = squares[cut]
                dist.all_reduce(part, group=mesh.get_group(d))
                squares[cut] = part
    return torch.sqrt(torch.sum(squares))


# leaves updated together: each foreach op's temporaries stay at about this
# many float32 elements (1 GiB), whatever the model's size
GROUP_ELEMENTS = 1 << 28


def _groups(names: list, params: dict):
    group, size = [], 0
    for n in names:
        if group and size + params[n].numel() > GROUP_ELEMENTS:
            yield group
            group, size = [], 0
        group.append(n)
        size += params[n].numel()
    if group:
        yield group


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 grad_norm: torch.Tensor | None = None):
    """One AdamW update of ``params`` by ``grads`` (both keyed by name).
    Updates ``params`` and the moments in place and returns (params, the
    state with ``step + 1``, metrics ``grad_norm`` and ``lr``).  The clip
    reads ``grad_norm`` where the caller gives it (a mesh step updates its
    shards by the norm of the whole gradient), else ``global_norm(grads)``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    b1c = 1 - torch.pow(b1, step.to(F32))
    b2c = 1 - torch.pow(b2, step.to(F32))
    lr = torch.as_tensor(lr, dtype=F32, device=step.device)
    for names in _groups(list(params), params):
        g = torch._foreach_mul(_f32(grads[n] for n in names), scale)
        ms = [state.m[n] for n in names]
        vs = [state.v[n] for n in names]
        m32 = torch._foreach_add(torch._foreach_mul(_f32(ms), b1),
                                 torch._foreach_mul(g, 1 - b1))
        torch._foreach_copy_(ms, m32)
        torch._foreach_mul_(g, torch._foreach_mul(g, 1 - b2))     # (1-b2)·g·g
        v32 = torch._foreach_add(torch._foreach_mul(_f32(vs), b2), g)
        torch._foreach_copy_(vs, v32)
        del g, m32, v32
        ps = [params[n] for n in names]
        mhat = torch._foreach_div(_f32(ms), b1c)
        denom = torch._foreach_div(_f32(vs), b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mhat, denom)
        del denom
        torch._foreach_add_(mhat, torch._foreach_mul(ps, weight_decay))
        torch._foreach_mul_(mhat, lr)
        torch._foreach_sub_(ps, mhat)
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``; ``lr(step)`` of an integer step tensor is float32 on
    its device."""
    def lr(step):
        step = step.to(F32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
