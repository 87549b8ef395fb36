"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

Port of ``repro/models/encdec.py``: the training forward (teacher-forced
decoder, each decoder layer checkpointed, as in the reference) and the
serving path. The mel-spectrogram
and conv feature extractor are a stub, as in the reference: a request
brings precomputed frame embeddings (B, frames, D). The encoder is
bidirectional over the frames (sinusoidal positions added, RoPE in the
attention); the decoder has causal self-attention, whose serve state is
the wave index (retro) or a dense cache (full), and cross-attention to the
encoder output. The cross K/V are computed once at prefill, and decode
attends to all frames exactly (plain PyTorch). The decode step updates the
self-attention states in place and reads the cross K/V as they are.
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
from repro_torch.models.transformer import (build_kv, embed_tokens,
                                           init_kv_state, torch_dtype,
                                           unembed)


def _init_block(gen, cfg: ModelConfig, device, cross: bool):
    a, d, dt = cfg.attn, cfg.d_model, torch_dtype(cfg)
    attn = lambda: L.init_attention(gen, d, a.n_heads, a.n_kv_heads,
                                    a.head_dim, dt, device)
    p = {"ln1": torch.zeros((d,), dtype=dt, device=device),
         "ln2": torch.zeros((d,), dtype=dt, device=device),
         "attn": attn(), "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, device)}
    if cross:
        p["ln_x"] = torch.zeros((d,), dtype=dt, device=device)
        p["xattn"] = attn()
    return p


def init_encdec(cfg: ModelConfig, gen: torch.Generator,
                device) -> Dict[str, Any]:
    d, dt = cfg.d_model, torch_dtype(cfg)
    return {"embed": L.dense_init(gen, (cfg.vocab, d), dt, device,
                                  scale=d ** -0.5),
            "enc_layers": [_init_block(gen, cfg, device, False)
                           for _ in range(cfg.encoder_layers)],
            "dec_layers": [_init_block(gen, cfg, device, True)
                           for _ in range(cfg.n_layers)],
            "enc_norm": torch.zeros((d,), dtype=dt, device=device),
            "final_norm": torch.zeros((d,), dtype=dt, device=device)}


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, F, D) stub embeddings -> encoder hidden (B, F, D)."""
    B, F, D = frames.shape
    a, dt = cfg.attn, torch_dtype(cfg)
    x = frames.to(dt) + L.sinusoidal_positions(F, D, frames.device).to(dt)
    positions = torch.arange(F, device=frames.device)
    for lp in params["enc_layers"]:
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], h, a.n_heads, a.n_kv_heads,
                                  a.head_dim, positions, a.rope_theta)
        o = L.flash_attention_jnp(q, k, v, causal=False)
        x = x + o.reshape(B, F, -1) @ lp["attn"]["wo"]
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h, cfg.act)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(params, cfg: ModelConfig, enc_out):
    """Per decoder layer, the cross K and V (B, F, Hkv, hd) of the encoder
    output: two lists."""
    a = cfg.attn
    B, F, _ = enc_out.shape
    shape = (B, F, a.n_kv_heads, a.head_dim)
    ks = [(enc_out @ lp["xattn"]["wk"]).reshape(shape)
          for lp in params["dec_layers"]]
    vs = [(enc_out @ lp["xattn"]["wv"]).reshape(shape)
          for lp in params["dec_layers"]]
    return ks, vs


class EncDecServeState(NamedTuple):
    self_kv: List[Any]              # one WaveState / DenseCache a layer
    cross_k: List[torch.Tensor]     # one (B, F, Hkv, hd) a layer
    cross_v: List[torch.Tensor]


def _cross_attend(lp, cfg: ModelConfig, x, k_x, v_x):
    """x: (B, T, D) queries against all frames of (k_x, v_x)."""
    a = cfg.attn
    B, n, _ = x.shape
    h = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    qx = (h @ lp["xattn"]["wq"]).reshape(B, n, a.n_heads, a.head_dim)
    ox = L.flash_attention_jnp(qx, k_x, v_x, causal=False)
    return x + ox.reshape(B, n, -1) @ lp["xattn"]["wo"]


def _dec_layer_seq(lp, cfg: ModelConfig, x, k_x, v_x, positions):
    """A decoder layer over a whole sequence x (B, T, D): causal
    self-attention, cross-attention to (k_x, v_x), the MLP. Returns (x,
    (k, v)), the self-attention's K/V post-RoPE."""
    a = cfg.attn
    B, n, _ = x.shape
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(lp["attn"], h, a.n_heads, a.n_kv_heads,
                              a.head_dim, positions, a.rope_theta)
    o = L.flash_attention_jnp(q, k, v, causal=True)
    x = x + o.reshape(B, n, -1) @ lp["attn"]["wo"]
    x = _cross_attend(lp, cfg, x, k_x, v_x)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], h, cfg.act), (k, v)


def _dec_layer_train(lp, cfg: ModelConfig, x, k_x, v_x, positions):
    return _dec_layer_seq(lp, cfg, x, k_x, v_x, positions)[0]


def forward(params, cfg: ModelConfig, tokens, frames):
    """Training forward, teacher-forced: tokens (B, T) with cross-attention
    to the encoded ``frames`` (B, F, D) -> (hidden (B, T, D), aux 0.0);
    each decoder layer checkpointed."""
    ck, cv = _cross_kv(params, cfg, encode(params, cfg, frames))
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp, k_x, v_x in zip(params["dec_layers"], ck, cv):
        x = checkpoint(_dec_layer_train, lp, cfg, x, k_x, v_x, positions,
                       use_reentrant=False)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0


def prefill(params, cfg: ModelConfig, tokens, frames, *,
            runtime: str = "retro", plan: Optional[ZonePlan] = None,
            gen_headroom: int = 4096, cache_len: Optional[int] = None):
    """Encode ``frames`` and prefill the decoder prompt ``tokens`` (B, T);
    returns (last-position logits, the serve state)."""
    n = tokens.shape[1]
    if plan is None:
        plan = plan_zones(n, cfg.retro, gen_headroom)
    total = cache_len if cache_len is not None else n + gen_headroom
    ck, cv = _cross_kv(params, cfg, encode(params, cfg, frames))
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(n, device=tokens.device)
    kv = []
    for lp, k_x, v_x in zip(params["dec_layers"], ck, cv):
        x, (k, v) = _dec_layer_seq(lp, cfg, x, k_x, v_x, positions)
        kv.append(build_kv(cfg, k, v, runtime=runtime, plan=plan,
                           total=total))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x[:, -1]), EncDecServeState(
        self_kv=kv, cross_k=ck, cross_v=cv)


def decode_step(params, cfg: ModelConfig, state: EncDecServeState, token, *,
                runtime: str = "retro", plan: ZonePlan,
                inline_flush: bool = False,
                active: Optional[torch.Tensor] = None,
                attn_impl: Optional[str] = None):
    """One generation step. token: (B,) -> (logits (B, V) f32, state); the
    self-attention states are updated in place."""
    a, retro = cfg.attn, cfg.retro
    impl = wa.resolve_attn_impl(attn_impl or retro.attn_impl)
    x = embed_tokens(params, cfg, token)
    B = x.shape[0]
    kv = []
    for lp, lstate, k_x, v_x in zip(params["dec_layers"], state.self_kv,
                                    state.cross_k, state.cross_v):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], h[:, None, :], a.n_heads,
                                  a.n_kv_heads, a.head_dim,
                                  lstate.length[:, None], a.rope_theta)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        if runtime == "retro":
            lstate = append_token(lstate, k, v, active=active)
            o = wa.wave_attention_decode(q, lstate, retro, plan,
                                         impl=impl).out
            if inline_flush:
                lstate = maybe_flush(lstate, retro)
        else:
            lstate = wa.dense_cache_append(lstate, k, v, active=active)
            o = wa.full_attention_decode(q, lstate)
        x = x + o.reshape(B, -1) @ lp["attn"]["wo"]
        x = _cross_attend(lp, cfg, x[:, None], k_x, v_x)[:, 0]
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h, cfg.act)
        kv.append(lstate)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), EncDecServeState(
        self_kv=kv, cross_k=state.cross_k, cross_v=state.cross_v)


def init_serve_state(cfg: ModelConfig, B: int, seq_len: int, *,
                     runtime: str = "retro", gen_headroom: int = 4096,
                     zero_fill: bool = False,
                     device="cuda") -> EncDecServeState:
    a, dt = cfg.attn, torch_dtype(cfg)
    cross = lambda: torch.zeros((B, cfg.encoder_frames, a.n_kv_heads,
                                 a.head_dim), dtype=dt, device=device)
    return EncDecServeState(
        self_kv=[init_kv_state(cfg, B, seq_len, runtime=runtime,
                                 gen_headroom=gen_headroom,
                                 zero_fill=zero_fill, device=device)
                 for _ in range(cfg.n_layers)],
        cross_k=[cross() for _ in range(cfg.n_layers)],
        cross_v=[cross() for _ in range(cfg.n_layers)])
