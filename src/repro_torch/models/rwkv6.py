"""RWKV6 ("Finch") mixer: data-dependent per-channel decay linear attention.

The port of the JAX package's ``models/rwkv6.py``.  The chunked parallel
form runs a Python loop over chunks carrying the float32 ``[b, h, K, V]``
state, where the reference runs a ``lax.scan``.  Every decay exponent is a
pairwise difference of a within-chunk cumulative log-decay, filled with
``-inf`` where masked before it is exponentiated, so the chunked form is
safe in float32 at any chunk length.  Static token-shift mixes and a
per-head RMS in place of GroupNorm, as the reference has them.

The per-token recurrence (decode, and the tests' oracle):
    S_t = diag(w_t)·S_{t-1} + kᵀ_t v_t
    o_t = r_t · (S_{t-1} + diag(u)·kᵀ_t v_t)

No TPU kernel lies here: the reference computes it with einsums, and the
port with plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    add_rms_norm,
    einsum,
    matmul,
    param,
    rms_norm,
    sigmoid,
    silu,
)


class RWKV6(nn.Module):
    """One RWKV block's weights (time mix and channel mix), named as the
    reference's parameter tree."""
    SPECS = {"mu": (None, None), "wr": ("embed", "ssm_inner"),
             "wk": ("embed", "ssm_inner"), "wv": ("embed", "ssm_inner"),
             "ww": ("embed", "ssm_inner"), "w_bias": (None,),
             "wg": ("embed", "ssm_inner"), "u": (None, None),
             "norm_w": (None,), "ln1": (None,), "ln2": (None,),
             "wo": ("ssm_inner", "embed"), "ffn_wr": ("embed", None),
             "ffn_wk": ("embed", "mlp"), "ffn_wv": ("mlp", "embed"),
             "ffn_mu": (None, None)}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hd, f = cfg.d_model, cfg.ssm_head_dim, cfg.d_ff
        self.mu = param(5, d, device=device)     # token-shift mix r,k,v,w,g
        self.wr = param(d, d, device=device)
        self.wk = param(d, d, device=device)
        self.wv = param(d, d, device=device)
        self.ww = param(d, d, device=device)
        self.w_bias = param(d, device=device)
        self.wg = param(d, d, device=device)
        self.u = param(d // hd, hd, device=device)
        self.norm_w = param(d, device=device)
        self.ln1 = param(d, device=device)
        self.ln2 = param(d, device=device)
        self.wo = param(d, d, device=device)
        # channel-mix FFN (r-sigmoid gate, squared relu)
        self.ffn_wr = param(d, d, device=device)
        self.ffn_wk = param(d, f, device=device)
        self.ffn_wv = param(f, d, device=device)
        self.ffn_mu = param(2, d, device=device)


def _token_shift(x, prev):
    """shift(x)[t] = x[t-1]; position 0 takes ``prev`` (the decode carry)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_chunked(r, k, v, logw, u, chunk: int, state0):
    """r, k: [b,s,h,K]; v: [b,s,h,V]; logw: [b,s,h,K] (≤ 0); u: [h,K];
    all float32, s a multiple of ``chunk``.  Returns (o [b,s,h,V], final
    state [b,h,K,V]).

    Per chunk, the decay tensor ``exp(W_{i-1} - W_j)`` [b,i,j,h,K] is the
    largest intermediate.  Without autograd (serving) it is reused in place
    for the products with r and k before the sum over K (the reference's
    three-operand einsum); when autograd records (``torch.is_grad_enabled``)
    the same products run out of place, since ``exp``'s backward reads its
    output.  The masked exponents are ``-inf`` before ``exp`` either way, so
    no ``inf·0`` reaches a backward."""
    s = r.shape[1]
    idx = torch.arange(chunk, device=r.device)
    masked = (idx[:, None] <= idx[None, :])[None, :, :, None, None]
    S, outs = state0, []
    for c0 in range(0, s, chunk):
        rc, kc = r[:, c0:c0 + chunk], k[:, c0:c0 + chunk]
        vc, lwc = v[:, c0:c0 + chunk], logw[:, c0:c0 + chunk]
        W = torch.cumsum(lwc, dim=1)                 # inclusive, ≤ 0 slope
        Wi = W - lwc                                 # exclusive (W_{i-1})
        # intra-chunk: pairwise decay differences are ≤ 0 where kept
        dec = Wi[:, :, None] - W[:, None, :]
        if torch.is_grad_enabled():
            att = (dec.masked_fill(masked, float("-inf")).exp()
                   * rc[:, :, None] * kc[:, None]).sum(-1)
        else:
            att = dec.masked_fill_(masked, float("-inf")).exp_() \
                .mul_(rc[:, :, None]).mul_(kc[:, None]).sum(-1)
        o = einsum("bijh,bjhv->bihv", att, vc)
        diag = (rc * u * kc).sum(-1)                 # [b,i,h]
        o = o + diag[..., None] * vc
        # inter-chunk, from the carried state
        o = o + einsum("bihk,bhkv->bihv", rc * torch.exp(Wi), S)
        # state update (every exponent ≤ 0)
        k_dec = kc * torch.exp(W[:, -1:] - W)
        S = S * torch.exp(W[:, -1])[..., None] \
            + einsum("bjhk,bjhv->bhkv", k_dec, vc)
        outs.append(o)
    return torch.cat(outs, dim=1), S


def _mixes(p: RWKV6, xn, sx, dtype):
    """The five token-shift mixes' projections: r, k, v, logw (float32,
    ≤ 0) and g."""
    mu = p.mu.to(dtype)
    xm = [xn + mu[i] * (sx - xn) for i in range(5)]
    r = matmul(xm[0], p.wr.to(dtype))
    k = matmul(xm[1], p.wk.to(dtype))
    v = matmul(xm[2], p.wv.to(dtype))
    wlog = -torch.exp(matmul(xm[3], p.ww.to(dtype)).to(torch.float32)
                      + p.w_bias)
    g = matmul(xm[4], p.wg.to(dtype))
    return r, k, v, wlog, g


def _channel_mix(p: RWKV6, cfg: ModelConfig, x, y, prev_ffn, dtype):
    """x1 = x + y (the time mix's residual), then x1 + the channel-mix FFN
    of LN2(x1); returns (out, LN2(x1))."""
    x1, x1n = add_rms_norm(x, y, p.ln2, cfg.norm_eps)
    sx2 = _token_shift(x1n, prev_ffn)
    fmu = p.ffn_mu.to(dtype)
    xr = x1n + fmu[0] * (sx2 - x1n)
    xk = x1n + fmu[1] * (sx2 - x1n)
    rr = sigmoid(matmul(xr, p.ffn_wr.to(dtype)))
    kk = torch.square(torch.relu(matmul(xk, p.ffn_wk.to(dtype))))
    return x1 + rr * matmul(kk, p.ffn_wv.to(dtype)), x1n


def rwkv6_apply(p: RWKV6, cfg: ModelConfig, x, dtype):
    """One full RWKV block (time mix + channel mix, pre-norm residuals)
    from a zero state:
        h = x + time_mix(LN1(x));   out = h + channel_mix(LN2(h))
    Returns (out, carry); carry = (wkv state, last LN1 token, last LN2
    token), so that decode continues where the prefill stopped."""
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    wkv0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    prev_tok = torch.zeros((b, d), dtype=dtype, device=x.device)
    prev_ffn = torch.zeros((b, d), dtype=dtype, device=x.device)

    xn = rms_norm(x, p.ln1, cfg.norm_eps)
    r, k, v, wlog, g = _mixes(p, xn, _token_shift(xn, prev_tok), dtype)

    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    sp = s + pad

    def heads(t):
        # state-preserving padding: k = r = v = 0 (no ingest), logw = 0
        # (decay 1)
        if pad:
            t = F.pad(t, (0, 0, 0, pad))
        return t.reshape(b, sp, h, hd).to(torch.float32)

    o, wkv = _wkv_chunked(heads(r), heads(k), heads(v), heads(wlog),
                          p.u.to(torch.float32), chunk, wkv0)
    o = o.reshape(b, sp, d)[:, :s].to(dtype)
    o = rms_norm(o, p.norm_w, cfg.norm_eps) * silu(g)
    out, x1n = _channel_mix(p, cfg, x, matmul(o, p.wo.to(dtype)), prev_ffn,
                            dtype)
    return out, (wkv, xn[:, -1, :], x1n[:, -1, :])


def rwkv6_decode(p: RWKV6, cfg: ModelConfig, x, state, dtype):
    """One token through the exact recurrence.  x: [b,1,d]; state as
    ``rwkv6_apply``'s carry.  Returns (out, new state)."""
    b, _, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    wkv, prev_tok, prev_ffn = state
    xn = rms_norm(x, p.ln1, cfg.norm_eps)
    r, k, v, wlog, g = _mixes(p, xn, prev_tok[:, None, :], dtype)

    rh = r.reshape(b, h, hd).to(torch.float32)
    kh = k.reshape(b, h, hd).to(torch.float32)
    vh = v.reshape(b, h, hd).to(torch.float32)
    wh = torch.exp(wlog.reshape(b, h, hd))
    kv = kh[..., :, None] * vh[..., None, :]              # [b,h,K,V]
    u = p.u.to(torch.float32)
    o = einsum("bhk,bhkv->bhv", rh, wkv + u[None, :, :, None] * kv)
    wkv_new = wkv * wh[..., None] + kv
    o = o.reshape(b, 1, d).to(dtype)
    o = rms_norm(o, p.norm_w, cfg.norm_eps) * silu(g)
    out, x1n = _channel_mix(p, cfg, x, matmul(o, p.wo.to(dtype)), prev_ffn,
                            dtype)
    return out, (wkv_new, xn[:, 0, :], x1n[:, 0, :])
