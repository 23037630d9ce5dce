"""Mamba2 (SSD, state-space duality) mixer, chunked parallel form.

The port of the JAX package's ``models/mamba2.py``: within chunks of Q
tokens the recurrence is a masked, decay-weighted attention-like product;
across chunks a Python loop carries the float32 ``[b, h, p, n]`` state
(the reference runs a ``lax.scan``).  ngroups = 1 (B and C shared across
heads), a causal depthwise conv of ``conv_width``, gated RMSNorm output:
the zamba2 configuration.

Every decay exponent is a difference of cumulative sums within one chunk;
the masked entries (j > i) are filled with ``-inf`` before they are
exponentiated, where the reference exponentiates every entry and then
zeroes the masked ones (an overflow to ``inf`` it drops).

After a prompt shorter than ``conv_width - 1`` tokens the conv state is
the last ``conv_width - 1`` rows of (``conv_width - 1`` zero rows ‖ the
prompt's conv inputs): the state ``mamba2_decode`` reaches token by token
from a zero state.  The reference returns no conv state there
(``ROADMAP.md`` §3, R5).

No TPU kernel lies here: the reference computes it with einsums, and the
port with plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum, matmul, param, rms_norm, silu


class Mamba2(nn.Module):
    """One Mamba2 mixer's weights, named as the reference's tree."""
    SPECS = {"in_proj": ("embed", "ssm_inner"), "conv_w": ("conv", "ssm_inner"),
             "A_log": (None,), "D": (None,), "dt_bias": (None,),
             "norm_w": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        self.in_proj = param(d, 2 * di + 2 * n + h, device=device)
        self.conv_w = param(cfg.conv_width, di + 2 * n, device=device)
        self.A_log = param(h, device=device)
        self.D = param(h, device=device)
        self.dt_bias = param(h, device=device)
        self.norm_w = param(di, device=device)
        self.out_proj = param(di, d, device=device)


def _split(cfg: ModelConfig, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, w):
    """Depthwise causal conv over the sequence, then SiLU: xbc [b,s,c],
    w [k,c]; the taps summed in the reference's order."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return silu(out)


def _ssd_chunked(x, dA, B, C, chunk: int):
    """x: [b,s,h,p] (dt-scaled), dA: [b,s,h] (≤ 0), B, C: [b,s,n]; all
    float32, s a multiple of ``chunk``.  Returns y [b,s,h,p] and the final
    state [b,h,p,n] from a zero state.

    The reference's ``einsum("bij,bijh,bjhp->bihp")`` runs as the scores
    times the decay matrix, [b,i,j,h], then one batched matmul over
    (b, h): no [b,i,j,h,p] intermediate.  The decay matrix is formed in
    place without autograd and out of place when autograd records
    (``exp``'s backward reads its output), as in ``rwkv6._wkv_chunked``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    idx = torch.arange(chunk, device=x.device)
    masked = (idx[:, None] < idx[None, :])[None, :, :, None]
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        xc, Ac = x[:, c0:c0 + chunk], dA[:, c0:c0 + chunk]
        Bc, Cc = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        cs = torch.cumsum(Ac, dim=1)                         # [b,l,h]
        # intra-chunk decay L_ij = exp(cs_i - cs_j) for i ≥ j, else 0
        seg = cs[:, :, None, :] - cs[:, None, :, :]          # [b,i,j,h]
        scores = einsum("bin,bjn->bij", Cc, Bc)[..., None]
        if torch.is_grad_enabled():
            L = seg.masked_fill(masked, float("-inf")).exp() * scores
        else:
            L = seg.masked_fill_(masked, float("-inf")).exp_().mul_(scores)
        y = einsum("bijh,bjhp->bihp", L, xc)
        # inter-chunk, from the carried state
        y = y + einsum("bin,bhpn->bihp", Cc, S) \
            * torch.exp(cs)[..., None]
        # state update
        decay_to_end = torch.exp(cs[:, -1:, :] - cs)         # [b,l,h]
        S = S * torch.exp(cs[:, -1])[:, :, None, None] + einsum(
            "blhp,bln->bhpn", xc * decay_to_end[..., None], Bc)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _gated_norm(p: Mamba2, cfg: ModelConfig, y, z, dtype):
    """rms_norm(y · silu(z)), the product in float32: XLA keeps the
    reference's bfloat16 product, which its norm casts straight to float32,
    unrounded."""
    return rms_norm(y.to(torch.float32) * silu(z), p.norm_w, cfg.norm_eps,
                    dtype)


def mamba2_apply(p: Mamba2, cfg: ModelConfig, x, dtype):
    """The mixer over a whole sequence from a zero state.  Returns
    (y, (ssm state [b,h,p,n] float32, conv state [b, conv_width-1, c]))."""
    b, s, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    zxbcdt = matmul(x, p.in_proj.to(dtype))
    z, xbc_pre, dt = _split(cfg, zxbcdt)
    xbc = _causal_conv(xbc_pre, p.conv_w.to(dtype))
    xr, B, C = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    A = -torch.exp(p.A_log.to(torch.float32))
    dA = dt * A                                               # [b,s,h] ≤ 0

    xs = xr.reshape(b, s, h, hp).to(torch.float32)
    xh = xs * dt[..., None]
    B, C = B.to(torch.float32), C.to(torch.float32)
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    if pad:
        # state-preserving padding: zero input and zero decay (dA = 0)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dA, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (dA, B, C))
    y, final = _ssd_chunked(xh, dA, B, C, chunk)
    y = y[:, :s] + p.D.to(torch.float32)[:, None] * xs
    y = y.reshape(b, s, di).to(dtype)
    y = _gated_norm(p, cfg, y, z, dtype)
    out = matmul(y, p.out_proj.to(dtype))
    k1 = cfg.conv_width - 1
    if s < k1:
        xbc_pre = F.pad(xbc_pre, (0, 0, k1 - s, 0))
    return out, (final, xbc_pre[:, xbc_pre.shape[1] - k1:, :])


def mamba2_decode(p: Mamba2, cfg: ModelConfig, x, ssm_state, conv_state,
                  dtype):
    """One token.  x: [b,1,d]; ssm_state: [b,h,p,n]; conv_state:
    [b, conv_width-1, c].  Returns (out, (ssm state, conv state))."""
    b = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    zxbcdt = matmul(x, p.in_proj.to(dtype))
    z, xbc, dt = _split(cfg, zxbcdt)
    # the causal conv over the rolling window
    window = torch.cat([conv_state, xbc], dim=1)              # [b,k,c]
    conv_out = einsum("bkc,kc->bc", window, p.conv_w.to(dtype))
    xbc1 = silu(conv_out)
    xr, B, C = xbc1[:, :di], xbc1[:, di:di + n], xbc1[:, di + n:]
    dt1 = F.softplus(dt[:, 0].to(torch.float32) + p.dt_bias)  # [b,h]
    A = -torch.exp(p.A_log.to(torch.float32))
    decay = torch.exp(dt1 * A)                                # [b,h]
    xs = xr.reshape(b, h, hp).to(torch.float32)
    outer = (xs * dt1[..., None])[..., None] \
        * B.to(torch.float32)[:, None, None, :]               # [b,h,p,n]
    new_state = ssm_state * decay[..., None, None] + outer
    y = einsum("bhpn,bn->bhp", new_state, C.to(torch.float32))
    y = y + p.D.to(torch.float32)[:, None] * xs
    y = y.reshape(b, 1, di).to(dtype)
    y = _gated_norm(p, cfg, y, z, dtype)
    out = matmul(y, p.out_proj.to(dtype))
    return out, (new_state, window[:, 1:, :])
