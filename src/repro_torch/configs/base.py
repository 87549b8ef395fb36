"""Config system: architecture + RetroInfer knobs.

Port of ``repro/configs/base.py`` (dataclasses only, no JAX). Field names,
defaults and derived methods (``param_count``, ``active_param_count``) are
kept identical so a test can compare the two packages field by field;
``InputShape`` / ``INPUT_SHAPES`` are the assigned shape suite.
``attn_impl`` is the default decode-attention implementation ("jnp", "fused" or "pallas"); ``offload`` (host-offload
serving), ``cache_clusters``, ``cache_frac`` and ``cache_policy`` (its
device block cache) are the serve engine's defaults. Engines and launchers
may override each per run.

Port-only fields follow the reference's in each dataclass, each with a
default that gives the reference's model (every config the reference has
keeps them at their defaults): on ``AttnConfig`` the ring cache of sliding
layers, the per-head QK norm and where RoPE applies; on ``MoEConfig`` the
router's scoring, the shared expert, the routed scale, the published
expert count and the first expert held here (an expert-parallel share); on
``ModelConfig`` the norm placement and the leading dense layers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    softcap: Optional[float] = None          # gemma2 logit softcapping
    sliding_window: Optional[int] = None     # window width for "local" layers
    # layer pattern, cycled over depth: "g" global, "l" local(sliding window)
    pattern: Tuple[str, ...] = ("g",)
    # ---- port-only ----
    # "l" layers keep only their last ``sliding_window`` keys and values in
    # a ring under the retro runtime (exact attention), not a wave index
    ring_window: bool = False
    qk_norm: bool = False                    # per-head RMSNorm of q and k
    rope_layers: str = "all"                 # "all" | "l" (global: NoPE)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # ---- port-only: the expert-parallel share layer (``scoring="sigmoid"``,
    # ``models/moe.py::share_apply``) ----
    scoring: str = "softmax"                 # "softmax" | "sigmoid"
    d_shared: int = 0                        # shared expert width (0: none)
    routed_scale: float = 1.0                # on the renormalised weights
    n_routed: int = 0                        # experts routed over (0: all held)
    expert_lo: int = 0                       # first expert held here

    @property
    def routed(self) -> int:
        """Experts the router scores: the published count."""
        return self.n_routed or self.num_experts

    @property
    def share(self) -> bool:
        """Whether the layer is the expert-parallel share layer
        (``models/moe.py::share_apply``), which the sigmoid router selects;
        the softmax router runs the capacity-padded ``moe_apply``."""
        return self.scoring == "sigmoid"


@dataclass(frozen=True)
class SSMConfig:
    kind: str                                # "rwkv6" | "mamba2"
    state_size: int = 64                     # mamba2 N / rwkv head_dim
    head_dim: int = 64
    expand: int = 2                          # mamba2 inner expansion
    conv_kernel: int = 4
    dt_rank: int = 0                         # 0 => heads-many scalar dts (mamba2)


@dataclass(frozen=True)
class RetroConfig:
    """Wave-index geometry (paper Sec. 4.2, 5.1 defaults)."""
    avg_cluster: int = 16                    # 1 centroid per 16 tokens
    cluster_cap: int = 32                    # fixed capacity (2x avg)
    prefill_segment: int = 8192              # segmented clustering segment
    update_segment: int = 1024               # decode-time flush granularity
    sink: int = 4                            # steady zone: initial tokens
    local: int = 64                          # steady zone: local window
    retrieval_frac: float = 0.018            # retrieval zone budget (1.8%)
    estimation_frac: float = 0.232           # estimation zone budget (23.2%)
    kmeans_iters: int = 10
    centering: bool = True                   # MagicPIG-style mean centering
    distributed_retrieval: bool = False
    serial_prefill_segments: bool = False
    attn_impl: str = "jnp"
    offload: bool = False
    cache_clusters: int = 0
    cache_frac: float = 0.2
    cache_policy: str = "lru"

    def n_clusters(self, seq_len: int) -> int:
        return max(1, seq_len // self.avg_cluster)

    def r_clusters(self, seq_len: int) -> int:
        m = self.n_clusters(seq_len)
        return max(1, int(round(m * self.retrieval_frac)))

    def e_clusters(self, seq_len: int) -> int:
        m = self.n_clusters(seq_len)
        return max(1, int(round(m * self.estimation_frac)))


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                              # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None          # moe family: the expert FFN
    ssm: Optional[SSMConfig] = None          # ssm / hybrid: the recurrence
    # hybrid (zamba2): one shared attention block applied every k SSM blocks
    shared_attn_every: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # vlm: number of stub patch-embedding tokens prepended to the text prompt
    num_patch_tokens: int = 0
    act: str = "silu"                        # "silu" | "gelu" (tanh approx)
    # MoE dispatch groups: each group of tokens is routed and packed on its
    # own (1 = one global dispatch)
    moe_dispatch_groups: int = 1
    sparse_prefill_blocks: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"                  # param/compute dtype
    retro: RetroConfig = field(default_factory=RetroConfig)
    source: str = ""                         # citation
    # ---- port-only ----
    # "pre": x + f(norm(x)); "post": x + norm(f(x)), no input norm
    norm_placement: str = "pre"
    dense_layers: int = 0                    # leading MLP layers of a moe model

    @property
    def n_heads(self) -> int:
        return self.attn.n_heads if self.attn else 0

    @property
    def n_kv_heads(self) -> int:
        return self.attn.n_kv_heads if self.attn else 0

    @property
    def head_dim(self) -> int:
        return self.attn.head_dim if self.attn else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention kind ('g'/'l') cycled from the pattern."""
        if self.attn is None:
            return tuple("s" for _ in range(self.n_layers))
        p = self.attn.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), the
        reference's formula."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        per_layer = 0
        if self.attn is not None:
            a = self.attn
            qkv = d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim
            per_layer += qkv + a.n_heads * a.head_dim * d
        if self.moe is not None:
            per_layer += self.moe.num_experts * 3 * d * self.moe.d_expert
            per_layer += d * self.moe.routed  # router
            per_layer += 3 * d * self.moe.d_shared
        elif self.ssm is not None and self.attn is None:
            per_layer += 8 * d * d  # rough ssm block size
        else:
            per_layer += 3 * d * self.d_ff
        n += per_layer * L
        if self.moe is not None and self.dense_layers:
            n += self.dense_layers * (3 * d * self.d_ff - 3 * d * (
                self.moe.num_experts * self.moe.d_expert + self.moe.d_shared)
                - d * self.moe.routed)
        if self.shared_attn_every and self.attn is not None:
            a = self.attn
            n += (d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim
                  + a.n_heads * a.head_dim * d + 3 * d * self.d_ff)
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        expert = (self.n_layers - self.dense_layers) * 3 * self.d_model \
            * self.moe.d_expert
        return (self.param_count() - expert * self.moe.num_experts
                + expert * self.moe.top_k)


@dataclass(frozen=True)
class InputShape:
    """One input shape of the assigned suite: ``kind`` is train, prefill
    or decode (one new token against ``seq_len`` tokens of context)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
