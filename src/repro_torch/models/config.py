"""Unified model configuration covering all 10 assigned architectures.

The JAX package's ``ModelConfig``, field for field (a config carries
across as ``ModelConfig(**dataclasses.asdict(cfg))``); ``compute_dtype``
is a torch dtype here.  Fields that steer only the JAX package's
compilation or sharding (``dispatch_reshard``, ``probe_unroll``) are kept
and have no effect in the port.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | mamba2 | rwkv6 | hybrid
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128

    # attention flavour
    qk_norm: bool = False
    sliding_window: int | None = None      # SWA width (mistral-style)
    local_global_ratio: int = 0            # gemma3: N local per 1 global
    local_window: int = 1024
    rope_theta: float = 10_000.0
    attn_chunk: int = 1024                 # flash-style KV chunk (train)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # §Perf knob: re-shard the dispatch buffer to expert-major before the
    # expert einsum (True = baseline) or let SPMD propagate (False)
    dispatch_reshard: bool = True

    # SSM (Mamba2 / RWKV6)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    conv_width: int = 4

    # hybrid (zamba2): one shared attention+MLP block every k layers
    shared_attn_every: int = 0

    # modality frontend (assignment: stubs for audio/vision)
    frontend: str = "tokens"               # tokens | vision_stub
    num_patches: int = 0                   # pixtral: prepended embeddings

    # numerics
    embed_scale: bool = False              # multiply embeddings by sqrt(d)
    dtype: str = "bfloat16"
    # roofline probes: fully unroll every lax.scan so cost_analysis counts
    # each iteration (a while body is otherwise counted once — DESIGN.md §9)
    probe_unroll: bool = False
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    tie_embeddings: bool = False

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:              # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family in ("mamba2", "rwkv6")

    @property
    def subquadratic(self) -> bool:
        """Can serve 500k-token contexts (assignment: SSM/hybrid/linear)."""
        return self.family in ("mamba2", "rwkv6", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (roofline MODEL_FLOPS uses this)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.family in ("dense", "moe"):
            hd = self.d_head
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            if self.family == "moe":
                per_layer += self.n_experts * 3 * d * f
                per_layer += d * self.n_experts          # router
                per_layer += self.n_shared_experts * 3 * d * f
            else:
                per_layer += 3 * d * f
            per_layer += 2 * d                            # norms
            n += L * per_layer
        elif self.family == "mamba2":
            di, st, h = self.d_inner, self.ssm_state, self.n_ssm_heads
            proj_in = d * (2 * di + 2 * st + h)
            per_layer = proj_in + self.conv_width * (di + 2 * st) \
                + di * d + 2 * h + d + di
            n += L * per_layer + L * 3 * d * f if f else L * per_layer
        elif self.family == "rwkv6":
            h = d // self.ssm_head_dim
            per_layer = 6 * d * d + 2 * d * f + 4 * d  # r,k,v,w,g,out + ffn
            n += L * per_layer
        elif self.family == "hybrid":
            di, st, h = self.d_inner, self.ssm_state, self.n_ssm_heads
            mamba_layer = d * (2 * di + 2 * st + h) \
                + self.conv_width * (di + 2 * st) + di * d + 2 * h + d + di
            hd = self.d_head
            shared = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d + 3 * d * f + 2 * d
            n += L * mamba_layer + shared
        return n

    def active_param_count(self) -> int:
        """MoE: params touched per token (6·N_active·D roofline)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_n = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * f)
        return dense_n + self.n_layers * (self.top_k * 3 * d * f)
