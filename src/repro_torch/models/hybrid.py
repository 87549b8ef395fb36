"""Zamba2-style hybrid backbone (arXiv:2411.15242): a stack of Mamba-2
blocks with ONE shared attention block (one weight set) applied after every
``shared_attn_every``-th block. The wave index applies to the
shared-attention sites only: each site has its own KV / index state (same
weights, different depth, so different K/V).

Port of ``repro/models/hybrid.py``: the training forward and the serving
path. The reference scans groups of (``shared_attn_every`` mamba blocks +
the shared block) and a mamba-only tail; the port runs the same order as
a Python loop over the layers, and its training forward checkpoints each
group and each tail block, as the reference does. Each site's state is a
``WaveState`` (retro runtime: built by ``prefill_build``, appended by
``append_token`` and attended through ``wave_attention_decode`` under any
impl) or a ``DenseCache`` (full runtime). The decode step updates every
state tensor in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as wa
from repro_torch.core.wave_index import append_token, maybe_flush
from repro_torch.core.zones import ZonePlan, plan_zones
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models.transformer import (build_kv, embed_tokens,
                                           init_kv_state, torch_dtype,
                                           unembed)


def attn_sites(cfg: ModelConfig) -> List[int]:
    """The layers after which the shared block runs."""
    k = cfg.shared_attn_every
    return [i for i in range(cfg.n_layers) if i % k == k - 1]


def init_hybrid(cfg: ModelConfig, gen: torch.Generator,
                device) -> Dict[str, Any]:
    a, d, dt = cfg.attn, cfg.d_model, torch_dtype(cfg)
    layers = [mamba2.init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    shared = {"ln1": torch.zeros((d,), dtype=dt, device=device),
              "ln2": torch.zeros((d,), dtype=dt, device=device),
              "attn": L.init_attention(gen, d, a.n_heads, a.n_kv_heads,
                                       a.head_dim, dt, device),
              "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, device)}
    return {"embed": L.dense_init(gen, (cfg.vocab, d), dt, device,
                                  scale=d ** -0.5),
            "layers": layers, "shared": shared,
            "final_norm": torch.zeros((d,), dtype=dt, device=device)}


def _shared_block_seq(sp, cfg: ModelConfig, x, positions):
    """The shared attention + MLP block over a whole prompt; returns (x,
    (k, v)) with k, v (B, T, Hkv, hd) post-RoPE."""
    a = cfg.attn
    B, T, _ = x.shape
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(sp["attn"], h, a.n_heads, a.n_kv_heads,
                              a.head_dim, positions, a.rope_theta)
    o = L.flash_attention_jnp(q, k, v, causal=True, softcap=a.softcap)
    x = x + o.reshape(B, T, -1) @ sp["attn"]["wo"]
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(sp["mlp"], h, cfg.act), (k, v)


def _group_seq(sp, cfg: ModelConfig, lps, x, positions):
    """A group of the training forward: the mamba blocks ``lps``, then the
    shared block."""
    for lp in lps:
        x = mamba2.layer_apply_seq(lp, cfg, x)
    return _shared_block_seq(sp, cfg, x, positions)[0]


def forward(params, cfg: ModelConfig, tokens):
    """Training forward: tokens (B, T) -> (hidden (B, T, D), aux 0.0).
    Groups of ``shared_attn_every`` mamba blocks + the shared block, then
    the mamba-only tail, each group and tail block checkpointed."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    G = cfg.shared_attn_every
    n = cfg.n_layers // G * G
    layers = params["layers"]
    for g in range(0, n, G):
        x = checkpoint(_group_seq, params["shared"], cfg, layers[g:g + G], x,
                       positions, use_reentrant=False)
    for lp in layers[n:]:
        x = checkpoint(mamba2.layer_apply_seq, lp, cfg, x,
                       use_reentrant=False)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0


def _shared_block_step(sp, cfg: ModelConfig, kst, x, *, runtime, plan,
                       inline_flush, active, impl):
    """The shared block at one site for one decode token; ``kst`` (the
    site's WaveState or DenseCache) is appended in place."""
    a, retro = cfg.attn, cfg.retro
    B = x.shape[0]
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(sp["attn"], h[:, None, :], a.n_heads,
                              a.n_kv_heads, a.head_dim,
                              kst.length[:, None], a.rope_theta)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    if runtime == "retro":
        kst = append_token(kst, k, v, active=active)
        o = wa.wave_attention_decode(q, kst, retro, plan, softcap=a.softcap,
                                     impl=impl).out
        if inline_flush:
            kst = maybe_flush(kst, retro)
    else:
        kst = wa.dense_cache_append(kst, k, v, active=active)
        o = wa.full_attention_decode(q, kst, softcap=a.softcap)
    x = x + o.reshape(B, -1) @ sp["attn"]["wo"]
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(sp["mlp"], h, cfg.act), kst


class HybridServeState(NamedTuple):
    mamba: List[mamba2.Mamba2LayerState]    # one per layer
    attn_kv: List[Any]                      # one WaveState / DenseCache a site


def prefill(params, cfg: ModelConfig, tokens, *, runtime: str = "retro",
            plan: Optional[ZonePlan] = None, gen_headroom: int = 4096,
            cache_len: Optional[int] = None):
    """Whole-prompt prefill; returns (last-position logits, the serve
    state). Every row consumes all T tokens."""
    n = tokens.shape[1]
    if plan is None:
        plan = plan_zones(n, cfg.retro, gen_headroom)
    total = cache_len if cache_len is not None else n + gen_headroom
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(n, device=tokens.device)
    sites = set(attn_sites(cfg))
    m_states, kv_states = [], []
    for i, lp in enumerate(params["layers"]):
        x, mst = mamba2.layer_apply_seq(lp, cfg, x, return_state=True)
        m_states.append(mst)
        if i in sites:
            x, (k, v) = _shared_block_seq(params["shared"], cfg, x, positions)
            kv_states.append(build_kv(cfg, k, v, runtime=runtime, plan=plan,
                                      total=total))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x[:, -1]), HybridServeState(
        mamba=m_states, attn_kv=kv_states)


def decode_step(params, cfg: ModelConfig, state: HybridServeState, token, *,
                runtime: str = "retro", plan: ZonePlan,
                inline_flush: bool = False,
                active: Optional[torch.Tensor] = None,
                attn_impl: Optional[str] = None):
    """One generation step. token: (B,) -> (logits (B, V) f32, state);
    every state tensor is updated in place."""
    impl = wa.resolve_attn_impl(attn_impl or cfg.retro.attn_impl)
    x = embed_tokens(params, cfg, token)
    sites = attn_sites(cfg)
    kv = list(state.attn_kv)
    for i, (lp, mst) in enumerate(zip(params["layers"], state.mamba)):
        x, _ = mamba2.layer_decode_step(lp, cfg, mst, x)
        if i in sites:
            s = sites.index(i)
            x, kv[s] = _shared_block_step(
                params["shared"], cfg, kv[s], x, runtime=runtime, plan=plan,
                inline_flush=inline_flush, active=active, impl=impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), HybridServeState(mamba=state.mamba,
                                                     attn_kv=kv)


def init_serve_state(cfg: ModelConfig, B: int, seq_len: int, *,
                     runtime: str = "retro", gen_headroom: int = 4096,
                     zero_fill: bool = False,
                     device="cuda") -> HybridServeState:
    return HybridServeState(
        mamba=[mamba2.init_layer_state(cfg, B, device)
               for _ in range(cfg.n_layers)],
        attn_kv=[init_kv_state(cfg, B, seq_len, runtime=runtime,
                               gen_headroom=gen_headroom,
                               zero_fill=zero_fill, device=device)
                 for _ in attn_sites(cfg)])
