"""Model assembly: init / forward / prefill / decode for every family.

The port of the JAX package's ``models/model.py``.  One decoder skeleton,
pluggable mixers:

  dense   — [LN → attention → LN → SwiGLU] × L
  moe     — [LN → attention → LN → MoE(+shared)] × L
  rwkv6   — [RWKV block (time mix + channel mix)] × L
  mamba2  — [LN → Mamba2 mixer] × L
  hybrid  — zamba2: groups of ``shared_attn_every`` Mamba2 layers, each
            group preceded by ONE weight-shared attention+MLP block (7
            applications for 38 layers, each with its own KV cache)

The reference scans one block over weights stacked ``[L, ...]``; here each
layer is a module in an ``nn.ModuleList`` and a Python loop runs them.
The decode caches stay stacked over layers (or the shared block's
applications) as the reference's are, and are written in place; their
position is a host integer, so no step reads the device to learn it.

``forward`` records gradients for the weights that require them (a model
becomes trainable through ``training.init_train_state``), and takes the
reference's three rematerialisation policies per block (``REMAT``): each
transformer block, each application of the hybrid's shared block, each
RWKV block and each Mamba2 layer is one ``torch.utils.checkpoint``.
``prefill``, ``decode_step`` and ``init_decode_state`` run under
``torch.inference_mode``.

``forward`` of a dense or MoE model also runs on a mesh, on DTensor
weights (the mesh train step): the embedded inputs take the reference's
``("batch", "seq", "act_embed")`` annotation, the residual stream keeps
that placement (each block's attention and MLP or MoE outputs are put in
it and summed into it), and the layers compute on each rank's blocks
(``models.layers``, ``models.moe``).

So do ``prefill`` and ``decode_step`` of a dense or MoE model under
``use_mesh``, as GSPMD partitions the reference's serving: on its placed
weights (``launch.inputs.place_params``) and on KV caches placed by
``decode_state_specs`` (``launch.inputs.place_cache``), whose batch takes
the data-parallel axes and whose KV heads, head dim or sequence takes
"model" (the sequence takes the data-parallel axes at batch 1).  Every
rank calls them with the same whole inputs, or with inputs placed by the
batch rule.  The prefill writes each rank's block of the caches from the
attention's k and v, which are whole along the sequence there
(``models.attention.attention_prefill``), and takes the last position's
row from the rank that holds it (``_last_position``); a decode step
writes the new token's k and v into the block that holds ``pos`` and
scores each rank's block (``models.attention._decode_placed``).  The
logits come back cut over the vocabulary (``lm_serving.greedy_tokens``
takes the greedy token from the blocks).  A MoE block's attention is the
dense block's, and its MoE layer the placed layer of the mesh train step
(``models.moe._placed_moe``): these calls set the row blocks of the batch
(``_serving_row_blocks``), so that the capacity and the first-come
positions are the whole batch's (``b·s`` tokens in a prefill, ``b`` in a
decode step, in (row, position) order); at batch 1 no axis cuts the
rows and no count table is exchanged.  On a mesh these run under
``torch.no_grad`` in place of ``torch.inference_mode`` (``serving``):
DTensor's view ops, and writes into a placed cache, raise on inference
tensors.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.distributed.sharding import (
    batch_row_blocks,
    current_mesh,
    current_row_blocks,
    current_rules,
    match,
    row_blocks,
    shard,
    use_mesh,
    write_block,
)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rk
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Embed,
    add_rms_norm,
    dense_init,
    embed_apply,
    mlp_apply,
    param,
    rms_norm,
    unembed_apply,
)

DEFAULT_DEVICE = "cuda"
# leaves the reference initialises to a constant, by leaf name: the norms,
# rwkv6's token-shift mixes, decay bias and bonus, mamba2's A_log, D and
# dt_bias (every other leaf but the embedding is ``dense_init``)
_CONSTANT_LEAVES = {
    "ln1": 0.0, "ln2": 0.0, "final_norm": 0.0, "q_norm": 0.0, "k_norm": 0.0,
    "norm_w": 0.0, "mu": 0.5, "ffn_mu": 0.5, "w_bias": -6.0, "u": 0.0,
    "A_log": 0.0, "D": 1.0, "dt_bias": 0.0,
}


# the reference's policies (its ``REMAT_POLICIES``): "full" saves nothing of
# a block and recomputes it in the backward, "dots" saves its matmuls'
# outputs and recomputes the rest
REMAT = ("none", "full", "dots")
_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default}


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run(remat: str, fn, *args):
    """``fn(*args)``, a block of ``forward``, under the policy ``remat``.
    Under a mesh the block re-enters the caller's mesh, rules and row
    blocks each time it runs: its recomputation runs in the backward, which
    autograd runs on a thread of its own for a CUDA device (``use_mesh``
    and ``row_blocks`` are per thread)."""
    if remat == "none":
        return fn(*args)
    mesh = current_mesh()
    if mesh is not None:
        fn = functools.partial(_on_mesh, mesh, current_rules(),
                               current_row_blocks(), fn)
    extra = {} if remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_matmuls)}
    return checkpoint(fn, *args, use_reentrant=False, **extra)


def _on_mesh(mesh, rules, blocks, fn, *args):
    with use_mesh(mesh, rules), row_blocks(blocks):
        return fn(*args)


def resolve_device(device) -> torch.device:
    """``device``, or the GPU where the caller names none; a CUDA device
    without a card raises rather than falling back to the CPU."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "model on the CPU")
    return device


class Block(nn.Module):
    """A transformer block: a dense or MoE layer, or the hybrid's shared
    attention+MLP block."""
    SPECS = {"ln1": (None,), "ln2": (None,)}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = param(cfg.d_model, device=device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = param(cfg.d_model, device=device)
        self.mlp = (moe_mod.MoE(cfg, device) if cfg.family == "moe"
                    else MLP(cfg.d_model, cfg.d_ff, device))


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.mixer = rk.RWKV6(cfg, device)


class MambaLayer(nn.Module):
    SPECS = {"ln1": (None,)}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.mixer = m2.Mamba2(cfg, device)
        self.ln1 = param(cfg.d_model, device=device)


_LAYERS = {"dense": Block, "moe": Block, "rwkv6": RWKVLayer,
           "mamba2": MambaLayer, "hybrid": MambaLayer}


class LM(nn.Module):
    """Uninitialised weights of one model, named as the JAX package's
    parameter tree (``layers.3.attn.wq`` is ``layers/attn/wq``'s row 3;
    the hybrid's unstacked ``shared/attn/wq`` is ``shared.attn.wq``), and
    the config they were made for (``cfg``)."""
    SPECS = {"final_norm": (None,)}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in _LAYERS:
            raise ValueError(cfg.family)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                           device)
        self.final_norm = param(cfg.d_model, device=device)
        self.layers = nn.ModuleList(_LAYERS[cfg.family](cfg, device)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = Block(cfg, device)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """A model with seeded random weights on ``device`` (the GPU unless the
    caller names another), drawn by a ``torch.Generator`` on that device,
    each leaf as the reference's initialiser draws it: the constants of
    ``_CONSTANT_LEAVES``, the embedding normal × 0.02, every other weight
    ``dense_init`` (× 0.1 for rwkv6's ``ww``).  The draws are not the JAX
    package's (tests carry its weights across with ``models.convert``)."""
    model = LM(cfg, device)
    dev = model.final_norm.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, w in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _CONSTANT_LEAVES:
                w.fill_(_CONSTANT_LEAVES[leaf])
            elif leaf == "embedding":
                w.copy_(torch.randn(w.shape, generator=gen, device=dev)
                        * 0.02)
            else:
                w.copy_(dense_init(gen, tuple(w.shape), device=dev))
                if leaf == "ww":   # rwkv6's decay projection: decay near 1
                    w.mul_(0.1)
    return model


def param_specs(cfg: ModelConfig) -> dict:
    """The spec half of the reference's ``init_params``: the logical-axis
    tuple of every leaf of its parameter tree, as nested dicts by the
    leaf's path, ``layers/...`` leaves led by ``"layers"`` (stacked over
    the layers).  Each module declares its leaves' axes (``SPECS``)."""
    model = LM(cfg, "meta")
    tree: dict = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        axes = model.get_submodule(".".join(parts[:-1])).SPECS[parts[-1]]
        if parts[0] == "layers":
            parts, axes = ["layers"] + parts[2:], ("layers",) + axes
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = axes
    return tree


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
    return shard(_scale_embeds(cfg, x, dtype), "batch", "seq", "act_embed")


def _head(model: LM, cfg: ModelConfig, x, dtype):
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return unembed_apply(model.embed, x, dtype, cfg.logit_softcap)


def _zero_aux(device) -> dict:
    return {name: torch.zeros((), dtype=torch.float32, device=device)
            for name in ("load_balance", "router_z", "dropped_frac")}


def _block(bp: Block, cfg: ModelConfig, x, pos, is_global: bool, mode: str,
           cache, slot: int, dtype):
    """One transformer block.  "prefill" writes the prefix's keys and
    values into the cache's ``slot`` (a layer, or an application of the
    hybrid's shared block) from position 0; "decode" attends one token at
    ``cache["pos"]``.  Returns (x, the MoE aux values or None)."""
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    if mode == "train":
        a = attn.attention_train(bp.attn, cfg, h, pos, is_global, dtype)
    elif mode == "prefill":
        a, k, v = attn.attention_prefill(bp.attn, cfg, h, pos, is_global,
                                         dtype)
        for name, t in (("k", k), ("v", v)):
            layer = cache[name][slot]
            if isinstance(layer, DTensor):
                # each rank's block, from the attention's k and v, which
                # are whole along the sequence: no collective
                write_block(layer, t, 1, 0)
            else:
                layer[:, :t.shape[1]] = t.to(layer.dtype)
    else:
        a = attn.attention_decode(bp.attn, cfg, h, cache["k"][slot],
                                  cache["v"][slot], cache["pos"], is_global,
                                  dtype)
    x, h2 = add_rms_norm(x, match(a, x), bp.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = bp.mlp(cfg, h2, dtype)
        return x + match(y, x), aux
    return x + match(mlp_apply(bp.mlp, h2, dtype), x), None


def _dense_stack(model: LM, cfg: ModelConfig, x, pos, mode: str, cache,
                 remat: str = "none"):
    """The blocks in order; "train" sums the MoE aux values over the
    layers (on a mesh DTensors in the layers' placements), zeros for a
    dense model.  Returns (x, aux)."""
    dtype = cfg.compute_dtype
    aux = None
    for i, (lp, ig) in enumerate(zip(model.layers, _is_global_pattern(cfg))):
        x, layer_aux = _run(remat, _block, lp, cfg, x, pos, ig, mode, cache,
                            i, dtype)
        if mode == "train" and layer_aux is not None:
            aux = layer_aux if aux is None else {
                n: aux[n] + layer_aux[n] for n in aux}
    return x, _zero_aux(x.device) if aux is None else aux


def _rwkv_stack(model: LM, cfg: ModelConfig, x, pos, mode: str, cache,
                remat: str = "none"):
    """The RWKV blocks in order: "train" and "prefill" run the chunked form
    from a zero state (prefill writes each layer's final state into the
    cache), "decode" the recurrence from the cache.  Returns (x, None)."""
    dtype = cfg.compute_dtype
    for i, lp in enumerate(model.layers):
        if mode == "decode":
            x, carry = rk.rwkv6_decode(lp.mixer, cfg, x, (
                cache["wkv"][i], cache["tok"][i], cache["ffn"][i]), dtype)
        else:
            x, carry = _run(remat, rk.rwkv6_apply, lp.mixer, cfg, x, dtype)
        if mode != "train":
            for name, t in zip(("wkv", "tok", "ffn"), carry):
                cache[name][i] = t
    return x, None


def _mamba_block(lp: MambaLayer, cfg: ModelConfig, x, dtype):
    """``x + mixer(LN1(x))`` over a whole sequence from a zero state.
    Returns (x, (ssm state, conv state))."""
    y, states = m2.mamba2_apply(lp.mixer, cfg,
                                rms_norm(x, lp.ln1, cfg.norm_eps), dtype)
    return x + y, states


def _mamba_layers(model: LM, cfg: ModelConfig, x, mode: str, cache,
                  layers: range, remat: str = "none"):
    """Mamba2 layers ``layers`` in order, each ``x + mixer(LN1(x))``; the
    ssm and conv states as ``_rwkv_stack`` treats the RWKV ones."""
    dtype = cfg.compute_dtype
    for i in layers:
        lp = model.layers[i]
        if mode == "decode":
            y, (ssm, conv) = m2.mamba2_decode(
                lp.mixer, cfg, rms_norm(x, lp.ln1, cfg.norm_eps),
                cache["ssm"][i], cache["conv"][i], dtype)
            x = x + y
        else:
            x, (ssm, conv) = _run(remat, _mamba_block, lp, cfg, x, dtype)
        if mode != "train":
            cache["ssm"][i] = ssm
            cache["conv"][i] = conv
    return x


def _mamba_stack(model: LM, cfg: ModelConfig, x, pos, mode: str, cache,
                 remat: str = "none"):
    return _mamba_layers(model, cfg, x, mode, cache, range(cfg.n_layers),
                         remat), None


def _hybrid_groups(cfg: ModelConfig) -> list[int]:
    """The sizes of the hybrid's groups of Mamba2 layers, each preceded by
    one application of the shared block: ``shared_attn_every`` layers a
    group, the last one shorter where they do not divide."""
    every, n = cfg.shared_attn_every, cfg.n_layers
    return [min(every, n - off) for off in range(0, n, every)]


def _hybrid_stack(model: LM, cfg: ModelConfig, x, pos, mode: str, cache,
                  remat: str = "none"):
    """For each group: the shared block (global attention; application
    ``gi`` keeps its own KV cache slot ``gi``), then the group's Mamba2
    layers ``off .. off + size``.  Returns (x, None)."""
    off = 0
    for gi, size in enumerate(_hybrid_groups(cfg)):
        x, _ = _run(remat, _block, model.shared, cfg, x, pos, True, mode,
                    cache, gi, cfg.compute_dtype)
        x = _mamba_layers(model, cfg, x, mode, cache, range(off, off + size),
                          remat)
        off += size
    return x, None


_STACKS = {
    "dense": _dense_stack,
    "moe": _dense_stack,
    "rwkv6": _rwkv_stack,
    "mamba2": _mamba_stack,
    "hybrid": _hybrid_stack,
}


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None, :].expand(b, s)


# ==========================================================================
# public API
# ==========================================================================
def forward(model: LM, cfg: ModelConfig, batch, *, remat: str = "none"):
    """Full-sequence forward (dense attention in the attention blocks),
    recording gradients for the weights that require them, each block
    under the rematerialisation policy ``remat`` (``REMAT``; all three
    give the same values and gradients).  Returns (logits, aux): the MoE
    aux values summed over the layers, zeros for a dense model, None for
    the rwkv6, mamba2 and hybrid families."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: one of {REMAT}")
    dtype = cfg.compute_dtype
    x = _embed_inputs(model, cfg, batch, dtype)
    x, aux = _STACKS[cfg.family](model, cfg, x, _positions(x), "train", None,
                                 remat)
    return _head(model, cfg, x, dtype), aux


@torch.inference_mode()
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    """Fresh decode caches on ``device`` (the GPU unless the caller names
    another); ``pos`` is a host integer.  Attention KV caches ``k``/``v``
    [L or applications, B, max_len, KV, hd]; rwkv6's float32 ``wkv``
    [L, B, h, hd, hd] and last tokens ``tok``/``ffn`` [L, B, d]; mamba2's
    float32 ``ssm`` [L, B, H, P, N] and ``conv`` [L, B, conv_width - 1,
    d_inner + 2N].  Everything but the float32 states is in the KV dtype
    (bfloat16 for a bfloat16 model)."""
    if cfg.family not in _STACKS:
        raise ValueError(cfg.family)
    device = resolve_device(device)
    kvd = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    L = cfg.n_layers

    def zeros(*shape, dtype=kvd):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {}
    if cfg.family in ("dense", "moe", "hybrid"):
        n = L if cfg.family != "hybrid" else len(_hybrid_groups(cfg))
        state["k"] = zeros(n, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        state["v"] = zeros(n, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    if cfg.family == "rwkv6":
        hd = cfg.ssm_head_dim
        state["wkv"] = zeros(L, batch, cfg.d_model // hd, hd, hd,
                             dtype=torch.float32)
        state["tok"] = zeros(L, batch, cfg.d_model)
        state["ffn"] = zeros(L, batch, cfg.d_model)
    if cfg.family in ("mamba2", "hybrid"):
        state["ssm"] = zeros(L, batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state, dtype=torch.float32)
        state["conv"] = zeros(L, batch, cfg.conv_width - 1,
                              cfg.d_inner + 2 * cfg.ssm_state)
    state["pos"] = 0
    return state


def decode_state_specs(cfg: ModelConfig) -> dict:
    """The decode caches' logical axes, leaf for leaf the reference's (its
    in_shardings): a dense or MoE cache names its head dim
    ``kv_head_dim``, which may take "model" when the KV-head count cannot;
    the hybrid's names it ``head_dim``; ``pos`` is a scalar."""
    if cfg.family in ("dense", "moe"):
        return {"k": ("stack", "batch", "kv_seq", "kv_heads", "kv_head_dim"),
                "v": ("stack", "batch", "kv_seq", "kv_heads", "kv_head_dim"),
                "pos": ()}
    if cfg.family == "rwkv6":
        return {"wkv": ("stack", "batch", "heads", None, None),
                "tok": ("stack", "batch", None),
                "ffn": ("stack", "batch", None),
                "pos": ()}
    if cfg.family == "mamba2":
        return {"ssm": ("stack", "batch", "heads", None, None),
                "conv": ("stack", "batch", None, "ssm_inner"),
                "pos": ()}
    if cfg.family == "hybrid":
        return {"k": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
                "v": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
                "ssm": ("stack", "batch", "heads", None, None),
                "conv": ("stack", "batch", None, "ssm_inner"),
                "pos": ()}
    raise ValueError(cfg.family)


def serving(fn):
    """``fn`` under ``torch.inference_mode``, or under ``torch.no_grad``
    where a mesh is current: DTensor's view ops (the reshapes of placed
    activations, a layer of a placed cache, a slice of the logits) raise
    on inference tensors ("Cannot set version_counter for inference
    tensor"), and so does a write into a placed cache made there."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with (torch.no_grad() if current_mesh() is not None
              else torch.inference_mode()):
            return fn(*args, **kwargs)
    return run


def _serving_row_blocks(cfg: ModelConfig, rows: int):
    """Where a mesh is current and the model is a MoE model: the row
    blocks of its batch of ``rows`` rows (``sharding.batch_row_blocks``:
    the batch rule that places the residual stream's rows), so that each
    MoE layer's capacity and first-come positions are the whole batch's,
    as the reference's ``moe_apply`` reads the global ``[B, S, D]``.  Set
    here, at the entry point, as the mesh train step sets them: every
    rank calls it, and the batch group is built once, outside the layers.
    A no-op otherwise."""
    if cfg.family != "moe" or current_mesh() is None:
        return contextlib.nullcontext()
    return row_blocks(batch_row_blocks(rows))


def _last_position(x):
    """``x[:, -1:, :]``.  On a mesh that cuts the sequence, DTensor would
    gather the whole residual for it: each rank's last row is gathered
    instead (one row a block of the sequence) and the last one kept."""
    if not isinstance(x, DTensor) or not any(p.is_shard(1)
                                             for p in x.placements):
        return x[:, -1:, :]
    mesh, pl = x.device_mesh, x.placements
    blocks = math.prod(n for n, p in zip(mesh.shape, pl) if p.is_shard(1))
    rows = DTensor.from_local(
        x.to_local()[:, -1:, :], mesh, pl, run_check=False,
        shape=(x.shape[0], blocks, x.shape[2]),
        stride=(blocks * x.shape[2], x.shape[2], 1))
    whole = tuple(Replicate() if p.is_shard(1) else p for p in pl)
    last = rows.redistribute(mesh, whole).to_local()[:, -1:, :]
    return DTensor.from_local(last, mesh, whole, run_check=False,
                              shape=(x.shape[0], 1, x.shape[2]),
                              stride=(x.shape[2], x.shape[2], 1))


@serving
def prefill(model: LM, cfg: ModelConfig, batch, cache: dict):
    """Run the prompt through the model from a fresh state (an incoming
    recurrent state is not read, as in the reference), writing every state
    into ``cache`` in place.  A KV cache bounds the prompt's length; the
    recurrent families have no bound.  Returns (last-token logits [B, V],
    cache)."""
    dtype = cfg.compute_dtype
    x = _embed_inputs(model, cfg, batch, dtype)
    if "k" in cache and x.shape[1] > cache["k"].shape[2]:
        raise ValueError(f"prefill of {x.shape[1]} positions into a cache "
                         f"of {cache['k'].shape[2]}")
    with _serving_row_blocks(cfg, x.shape[0]):
        x, _ = _STACKS[cfg.family](model, cfg, x, _positions(x), "prefill",
                                   cache)
    logits = _head(model, cfg, _last_position(x), dtype)
    return logits[:, 0], dict(cache, pos=cache["pos"] + x.shape[1])


@serving
def decode_step(model: LM, cfg: ModelConfig, tokens, cache: dict):
    """One decoding step at ``cache["pos"]`` (an attention block raises
    past its cache's length).  tokens: [B, 1].  Returns (logits [B, V],
    cache)."""
    dtype = cfg.compute_dtype
    x = _scale_embeds(cfg, embed_apply(model.embed, tokens, dtype), dtype)
    with _serving_row_blocks(cfg, x.shape[0]):
        x, _ = _STACKS[cfg.family](model, cfg, x, None, "decode", cache)
    logits = _head(model, cfg, x, dtype)
    return logits[:, 0], dict(cache, pos=cache["pos"] + 1)
