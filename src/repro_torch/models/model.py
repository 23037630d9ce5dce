"""Model assembly: init / forward / prefill / decode for the dense and MoE
families.

The port of the JAX package's ``models/model.py`` for its dense/MoE
skeleton, ``[LN → attention → LN → SwiGLU or MoE(+shared)] × L``.  The
reference scans one block over weights stacked ``[L, ...]``; here each
layer is a ``Block`` in an ``nn.ModuleList`` and a Python loop runs them.
The decode caches stay stacked ``[L, B, Smax, KV, hd]`` as the reference's
are, and are written in place; their position is a host integer, so no
step reads the device to learn it.

The rwkv6, mamba2 and hybrid families are not ported yet (``ROADMAP.md``
§1, item 2: the mixers): building one raises ``NotImplementedError``.
``forward`` runs without rematerialisation only; the training slice brings
``remat`` (``ROADMAP.md`` §1, item 2: training).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Embed,
    dense_init,
    embed_apply,
    mlp_apply,
    param,
    rms_norm,
    unembed_apply,
)

DEFAULT_DEVICE = "cuda"
PORTED_FAMILIES = ("dense", "moe")
_NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def resolve_device(device) -> torch.device:
    """``device``, or the GPU where the caller names none; a CUDA device
    without a card raises rather than falling back to the CPU."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "model on the CPU")
    return device


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP.md §1, item 2: the mixers rwkv6/mamba2/hybrid)")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = param(cfg.d_model, device=device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = param(cfg.d_model, device=device)
        self.mlp = (moe_mod.MoE(cfg, device) if cfg.family == "moe"
                    else MLP(cfg.d_model, cfg.d_ff, device))


class LM(nn.Module):
    """Uninitialised weights of one dense or MoE model, named as the JAX
    package's parameter tree (``layers.3.attn.wq`` is ``layers/attn/wq``'s
    row 3)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                           device)
        self.final_norm = param(cfg.d_model, device=device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """A model with seeded random weights on ``device`` (the GPU unless the
    caller names another), drawn by a ``torch.Generator`` on that device:
    norms 0, the embedding normal × 0.02, every other weight
    ``dense_init``.  The draws are not the JAX package's (tests carry its
    weights across with ``models.convert``)."""
    model = LM(cfg, device)
    dev = model.final_norm.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, w in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _NORMS:
                w.zero_()
            elif leaf == "embedding":
                w.copy_(torch.randn(w.shape, generator=gen, device=dev)
                        * 0.02)
            else:
                w.copy_(dense_init(gen, tuple(w.shape), device=dev))
    return model


def _is_global_pattern(cfg: ModelConfig) -> list[bool]:
    """Per layer: True where attention is global (not windowed)."""
    if cfg.local_global_ratio:
        # gemma3: every (ratio+1)-th layer is global
        r = cfg.local_global_ratio
        return [i % (r + 1) == r for i in range(cfg.n_layers)]
    return [not cfg.sliding_window] * cfg.n_layers


def _scale_embeds(cfg: ModelConfig, x, dtype):
    if cfg.embed_scale or cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(dtype)
    return x


def _embed_inputs(model: LM, cfg: ModelConfig, batch, dtype):
    x = embed_apply(model.embed, batch["tokens"], dtype)
    if cfg.frontend == "vision_stub":
        img = batch["image_embeds"].to(dtype)
        x = torch.cat([img, x], dim=1)
    return _scale_embeds(cfg, x, dtype)


def _head(model: LM, cfg: ModelConfig, x, dtype):
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return unembed_apply(model.embed, x, dtype, cfg.logit_softcap)


def _zero_aux(device) -> dict:
    return {name: torch.zeros((), dtype=torch.float32, device=device)
            for name in ("load_balance", "router_z", "dropped_frac")}


def _dense_stack(model: LM, cfg: ModelConfig, x, pos, mode: str, cache):
    """The blocks in order.  ``mode`` "train" sums the MoE aux values over
    the layers; "prefill" writes the prefix's keys and values into the
    cache from position 0; "decode" attends one token at ``cache["pos"]``.
    Returns (x, aux)."""
    dtype = cfg.compute_dtype
    aux = _zero_aux(x.device)
    for i, (lp, ig) in enumerate(zip(model.layers, _is_global_pattern(cfg))):
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        if mode == "train":
            a = attn.attention_train(lp.attn, cfg, h, pos, ig, dtype)
        elif mode == "prefill":
            a, k, v = attn.attention_prefill(lp.attn, cfg, h, pos, ig, dtype)
            cache["k"][i, :, :k.shape[1]] = k.to(cache["k"].dtype)
            cache["v"][i, :, :v.shape[1]] = v.to(cache["v"].dtype)
        else:
            a = attn.attention_decode(lp.attn, cfg, h, cache["k"][i],
                                      cache["v"][i], cache["pos"], ig, dtype)
        x = x + a
        h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
        if cfg.family == "moe":
            y, layer_aux = lp.mlp(cfg, h2, dtype)
            if mode == "train":
                aux = {n: aux[n] + layer_aux[n] for n in aux}
        else:
            y = mlp_apply(lp.mlp, h2, dtype)
        x = x + y
    return x, aux


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None, :].expand(b, s)


# ==========================================================================
# public API
# ==========================================================================
@torch.inference_mode()
def forward(model: LM, cfg: ModelConfig, batch, *, remat: str = "none"):
    """Full-sequence forward (dense attention).  Returns (logits, aux): the
    MoE aux values summed over the layers, zeros for a dense model."""
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r}: rematerialisation comes with the training "
            "slice (ROADMAP.md §1, item 2: training)")
    dtype = cfg.compute_dtype
    x = _embed_inputs(model, cfg, batch, dtype)
    x, aux = _dense_stack(model, cfg, x, _positions(x), "train", None)
    return _head(model, cfg, x, dtype), aux


@torch.inference_mode()
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    """Fresh decode caches, stacked over layers, on ``device`` (the GPU
    unless the caller names another); ``pos`` is a host integer."""
    check_family(cfg)
    device = resolve_device(device)
    kvd = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=kvd, device=device),
            "v": torch.zeros(shape, dtype=kvd, device=device),
            "pos": 0}


@torch.inference_mode()
def prefill(model: LM, cfg: ModelConfig, batch, cache: dict):
    """Run the prompt through the model, writing its keys and values into
    ``cache`` in place.  Returns (last-token logits [B, V], cache)."""
    dtype = cfg.compute_dtype
    x = _embed_inputs(model, cfg, batch, dtype)
    if x.shape[1] > cache["k"].shape[2]:
        raise ValueError(f"prefill of {x.shape[1]} positions into a cache "
                         f"of {cache['k'].shape[2]}")
    x, _ = _dense_stack(model, cfg, x, _positions(x), "prefill", cache)
    logits = _head(model, cfg, x[:, -1:, :], dtype)
    return logits[:, 0], dict(cache, pos=cache["pos"] + x.shape[1])


@torch.inference_mode()
def decode_step(model: LM, cfg: ModelConfig, tokens, cache: dict):
    """One decoding step at ``cache["pos"]`` (raises past the cache's
    length).  tokens: [B, 1].  Returns (logits [B, V], cache)."""
    dtype = cfg.compute_dtype
    x = _scale_embeds(cfg, embed_apply(model.embed, tokens, dtype), dtype)
    x, _ = _dense_stack(model, cfg, x, None, "decode", cache)
    logits = _head(model, cfg, x, dtype)
    return logits[:, 0], dict(cache, pos=cache["pos"] + 1)
