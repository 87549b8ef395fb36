"""GQA transformer: dense (gemma/minitron), MoE
(mixtral/kimi: ``models/moe.py`` in place of the MLP) and VLM (the llava
backbone: patch embeddings replace the first positions' token embeddings).

Port of ``repro/models/transformer.py``: init, the training forward
(every layer checkpointed, the MoE aux loss summed), the monolithic prefill
of blocking admission (flash or block-sparse attention, then
``prefill_build``), chunked prefill (exact chunk attention against an
admission cache while the wave index is built incrementally) and its
finalize, the decode step with any of the decode-attention impls
(``attn_impl``: "jnp", "fused", "pallas") and its hot/cold split
(``decode_step_split``, sharded retrieval with a process group), and the
two halves of the
host-offload decode layer with its flush. The JAX layer scan becomes a
Python loop over per-layer parameter dicts and per-layer states.

Serve-time attention runtime, as in the reference:
  * "retro": the wave index (the paper's technique);
  * "full": a dense KV cache and exact attention (the paper's baseline).

Port-only options of the block (``configs/base.py``; their defaults give the
reference's block): post-sublayer norms (``norm_placement="post"``: x + n(f(x))
with no input norm), a per-head RMSNorm of q and k (``attn.qk_norm``), RoPE
on the sliding layers only (``attn.rope_layers="l"``), leading dense MLP
layers in a moe model (``dense_layers``), the share layer of
``models/moe.py`` (``moe.share``: the sigmoid router), and under the retro
runtime a ring of the last ``sliding_window`` keys and values on sliding layers
(``attn.ring_window``: ``core/attention.py::RingCache``, exact attention)
in place of their wave index.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as wa
from repro_torch.core.distributed import distributed_wave_attention
from repro_torch.core.sparse_prefill import block_sparse_attention
from repro_torch.core.wave_index import (WaveState, append_token,
                                         flush_segment_offload,
                                         init_chunked_prefill, init_wave_state,
                                         maybe_flush, prefill_append_chunk,
                                         prefill_build, prefill_finalize,
                                         scatter_chunk_rows)
from repro_torch.core.zones import ZonePlan, plan_zones
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_apply_grouped, share_apply

GLOBAL_WINDOW = 1.0e9   # "no sliding window" sentinel


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_windows(cfg: ModelConfig) -> List[float]:
    return [float(cfg.attn.sliding_window) if kind == "l" else GLOBAL_WINDOW
            for kind in cfg.layer_kinds()]


def ring_layers(cfg: ModelConfig, runtime: str = "retro") -> List[bool]:
    """Per layer: whether it keeps a ring of its window (a sliding layer of
    a config with ``attn.ring_window``, under the retro runtime)."""
    ring = runtime == "retro" and cfg.attn is not None \
        and cfg.attn.ring_window
    return [ring and kind == "l" for kind in cfg.layer_kinds()]


def refuse_ring(cfg: ModelConfig, what: str, runtime: str = "retro") -> None:
    """Ring layers have no chunked admission and no host offload."""
    if any(ring_layers(cfg, runtime)):
        raise ValueError(f"{what} does not support the ring cache of "
                         f"sliding layers (attn.ring_window, config "
                         f"{cfg.arch_id!r}); use blocking admission and the "
                         f"direct store")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_transformer(cfg: ModelConfig, generator: torch.Generator,
                     device) -> Dict[str, Any]:
    """Random parameters with the reference's distributions: normal scaled
    by 1/sqrt(fan_in), embedding by d_model^-0.5, zero norms, tied
    embeddings; a MoE layer's router in f32 and its experts stacked
    (``moe.init_moe``). ``generator`` must live on ``device``."""
    a, d, dt = cfg.attn, cfg.d_model, torch_dtype(cfg)

    def dense(shape, scale=None):
        return L.dense_init(generator, shape, dt, device, scale)

    norms = ("ln_post_attn", "ln_post_ffn") \
        if cfg.norm_placement == "post" else ("ln1", "ln2")
    layers = []
    for i in range(cfg.n_layers):
        lp = {norms[0]: torch.zeros((d,), dtype=dt, device=device),
              norms[1]: torch.zeros((d,), dtype=dt, device=device),
              "attn": L.init_attention(generator, d, a.n_heads, a.n_kv_heads,
                                       a.head_dim, dt, device)}
        if a.qk_norm:
            for n in ("q_norm", "k_norm"):
                lp["attn"][n] = torch.zeros((a.head_dim,), dtype=dt,
                                            device=device)
        if cfg.moe is not None and i >= cfg.dense_layers:
            lp["moe"] = init_moe(generator, d, cfg.moe, dt, device)
        else:
            lp["mlp"] = L.init_mlp(generator, d, cfg.d_ff, dt, device)
        layers.append(lp)
    params = {"embed": dense((cfg.vocab, d), scale=d ** -0.5),
              "layers": layers, "window": layer_windows(cfg),
              "final_norm": torch.zeros((d,), dtype=dt, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab))
    return params


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens, patch_embeds=None):
    """Scaled token embeddings; (B, P, D) ``patch_embeds`` (vlm) replace
    the first P positions, cast to the activation dtype and not scaled."""
    x = params["embed"][tokens]
    x = x * L.rounded(math.sqrt(cfg.d_model), x.dtype)
    if patch_embeds is not None:
        P = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def unembed(params, cfg: ModelConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).float()


def _ffn(lp, x, cfg: ModelConfig, *, step: bool = False, active=None,
         counts=None):
    """x: (..., D) -> ((..., D), aux loss): the MLP (aux 0.0), or the MoE
    FFN over every token of the call (its load-balance loss, f32; the serve
    paths drop it), or the share layer (aux 0.0; ``step``, ``active`` and
    ``counts``: ``moe.share_apply``'s, for a decode step)."""
    if "moe" not in lp:
        return L.mlp_apply(lp["mlp"], x, cfg.act), 0.0
    flat = x.reshape(-1, x.shape[-1])
    if cfg.moe.share:
        return share_apply(lp["moe"], flat, cfg.moe, cfg.act, step=step,
                           active=active, counts=counts).view(x.shape), 0.0
    y, aux = moe_apply_grouped(lp["moe"], flat, cfg.moe, cfg.act,
                               groups=cfg.moe_dispatch_groups)
    return y.view(x.shape), aux


def _norm_in(lp, x, name: str, cfg: ModelConfig):
    """A sublayer's input: the residual stream normed by ``lp[name]``
    ("ln1" before attention, "ln2" before the FFN), or under post-norm the
    stream itself."""
    if cfg.norm_placement == "post":
        return x
    return L.rms_norm(x, lp[name], cfg.norm_eps)


def _add(lp, x, y, which: str, cfg: ModelConfig):
    """x + y, or x + n(y) under post-norm (``which``: "attn" or "ffn")."""
    if cfg.norm_placement == "post":
        y = L.rms_norm(y, lp["ln_post_" + which], cfg.norm_eps)
    return x + y


def _qkv(lp, cfg: ModelConfig, kind: str, h, positions):
    """``L.attention_qkv`` with the config's per-head QK norm, and RoPE on
    the layers ``attn.rope_layers`` names."""
    a = cfg.attn
    return L.attention_qkv(lp["attn"], h, a.n_heads, a.n_kv_heads,
                           a.head_dim, positions, a.rope_theta,
                           qk_eps=cfg.norm_eps if a.qk_norm else None,
                           rope=a.rope_layers in ("all", kind))


# ---------------------------------------------------------------------------
# training / scoring forward (full attention, chunked online softmax)
# ---------------------------------------------------------------------------

def _train_layer(lp, window, cfg: ModelConfig, x, positions, kind="g"):
    """One layer of ``forward``: -> (x, the layer's aux loss)."""
    a = cfg.attn
    B, T, _ = x.shape
    h = _norm_in(lp, x, "ln1", cfg)
    q, k, v = _qkv(lp, cfg, kind, h, positions)
    o = L.flash_attention_jnp(q, k, v, causal=True, window=window,
                              softcap=a.softcap)
    x = _add(lp, x, o.reshape(B, T, -1) @ lp["attn"]["wo"], "attn", cfg)
    y, aux = _ffn(lp, _norm_in(lp, x, "ln2", cfg), cfg)
    return _add(lp, x, y, "ffn", cfg), aux


def forward(params, cfg: ModelConfig, tokens, patch_embeds=None):
    """tokens: (B, T) -> (hidden (B, T, D), aux loss), every layer
    checkpointed (recomputed in the backward pass), as the reference's
    ``jax.checkpoint`` does. ``params["window"]``: per-layer floats, or the
    (L,) f32 tensor of a training state."""
    x = embed_tokens(params, cfg, tokens, patch_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = 0.0
    for lp, window, kind in zip(params["layers"], params["window"],
                                cfg.layer_kinds()):
        x, aux_l = checkpoint(_train_layer, lp, window, cfg, x, positions,
                              kind, use_reentrant=False)
        aux = aux + aux_l
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def build_kv(cfg: ModelConfig, k, v, *, runtime: str, plan: ZonePlan,
             total: int, lengths: Optional[torch.Tensor] = None,
             ring: bool = False):
    """One attention layer's serve state from its prompt K/V (B, T, Hkv,
    hd), post-RoPE: the wave index (retro), a ring of the last
    ``sliding_window`` positions (``ring``) or a dense cache of ``total``
    slots holding the prompt (full). ``lengths``: optional (B,) true
    lengths of right-padded rows."""
    B, T = k.shape[:2]
    dt = torch_dtype(cfg)
    if ring:
        return wa.ring_from_prompt(k, v, cfg.attn.sliding_window, dt,
                                   lengths=lengths)
    if runtime == "retro":
        return prefill_build(k, v, cfg.retro, plan.m_max, dtype=dt,
                             lengths=lengths)
    if total < T:
        raise ValueError(f"cache length {total} below the prompt length {T}")
    cache = wa.init_dense_cache(B, k.shape[2], total, k.shape[3], dt,
                                k.device)
    cache.k[:, :, :T] = k.transpose(1, 2)
    cache.v[:, :, :T] = v.transpose(1, 2)
    return cache._replace(
        length=torch.full((B,), T, dtype=torch.int32, device=k.device)
        if lengths is None else lengths.clone())


class ServeState(NamedTuple):
    """Per-layer KV state of the decode batch: ``WaveState``s (retro
    runtime; ``RingCache``s on ring layers) or ``DenseCache``s (full
    runtime)."""
    kv: List[Any]


def prefill(params, cfg: ModelConfig, tokens, patch_embeds=None, *,
            runtime: str = "retro", plan: Optional[ZonePlan] = None,
            gen_headroom: int = 4096,
            lengths: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, ServeState]:
    """Process a whole prompt (blocking admission); returns (last-position
    logits, serve state).

    ``lengths``: optional (B,) true prompt lengths of right-padded rows:
    causality keeps real queries blind to pad keys, the wave index keeps
    pads out of its stores, and the logits are taken at each row's own last
    real position. ``cache_len``: the full runtime's dense-cache slots
    (default T + gen_headroom); the engine sizes every slot's prefill to the
    decode batch's capacity so the state grafts into it.
    ``cfg.sparse_prefill_blocks > 0`` (and T a multiple of 128) runs
    block-sparse attention instead of the dense flash attention.
    ``patch_embeds``: (B, P, D) vlm patch embeddings of the first P
    positions. Each layer is a device span (``repro_torch.spans``),
    ``prefill.layer``, with children ``prefill.attn`` (the attention) and
    ``prefill.index`` (``build_kv``), and ``prefill.moe`` around the share
    layer's FFN (``moe.scoring="sigmoid"``)."""
    a, retro = cfg.attn, cfg.retro
    x = embed_tokens(params, cfg, tokens, patch_embeds)
    B, T, _ = x.shape
    dev = tokens.device
    positions = torch.arange(T, device=dev)
    if plan is None:
        plan = plan_zones(T, retro, gen_headroom)
    lens = None if lengths is None else lengths.to(device=dev,
                                                   dtype=torch.int32)
    total = cache_len if cache_len is not None else T + gen_headroom
    use_sparse = cfg.sparse_prefill_blocks > 0 and T % 128 == 0
    kv = []
    kinds, rings = cfg.layer_kinds(), ring_layers(cfg, runtime)
    for i, (lp, window) in enumerate(zip(params["layers"], params["window"])):
        with spans.device("prefill.layer", layer=i):
            h = _norm_in(lp, x, "ln1", cfg)
            q, k, v = _qkv(lp, cfg, kinds[i], h, positions)
            with spans.device("prefill.attn", layer=i):
                if use_sparse:
                    o = block_sparse_attention(
                        q, k, v, block=128,
                        topk_blocks=cfg.sparse_prefill_blocks,
                        window=window, softcap=a.softcap)
                else:
                    o = L.flash_attention_jnp(q, k, v, causal=True,
                                              window=window,
                                              softcap=a.softcap)
            x = _add(lp, x, o.reshape(B, T, -1) @ lp["attn"]["wo"], "attn",
                     cfg)
            h = _norm_in(lp, x, "ln2", cfg)
            share = "moe" in lp and cfg.moe.share
            with spans.device("prefill.moe", layer=i) if share \
                    else nullcontext():
                y = _ffn(lp, h, cfg)[0]
            x = _add(lp, x, y, "ffn", cfg)
            del y           # not held across the next layer's attention
            with spans.device("prefill.index", layer=i):
                kv.append(build_kv(cfg, k, v, runtime=runtime, plan=plan,
                                   total=total, lengths=lens,
                                   ring=rings[i]))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lens is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=dev), (lens - 1).long()]
    return unembed(params, cfg, last), ServeState(kv=kv)


# ---------------------------------------------------------------------------
# Chunked prefill — admission interleaved with decode.
# ---------------------------------------------------------------------------


class PrefillChunkState(NamedTuple):
    """Admission-time state, one entry per layer: the exact K/V of the
    prompt so far (``cache``) and the streaming wave-index build (``wave``;
    None under the full runtime)."""
    cache: List[wa.DenseCache]
    wave: List[Any]


def init_prefill_chunk_state(cfg: ModelConfig, B: int, max_ctx: int, *,
                             runtime: str = "retro", chunk: int,
                             gen_headroom: int = 4096,
                             device="cuda") -> PrefillChunkState:
    """``max_ctx`` pins the admission geometry to the engine's decode state
    so the finalized state grafts into the shared batch. The full runtime's
    cache holds ``max_ctx + gen_headroom`` slots (it becomes the serve
    state); the retro admission cache only needs the prompt."""
    refuse_ring(cfg, "chunked admission", runtime)
    a, retro, dt = cfg.attn, cfg.retro, torch_dtype(cfg)
    plan = plan_zones(max_ctx, retro, gen_headroom)
    cache_len = max_ctx if runtime == "retro" else max_ctx + gen_headroom
    caches, waves = [], []
    for _ in range(cfg.n_layers):
        caches.append(wa.init_dense_cache(B, a.n_kv_heads, cache_len,
                                          a.head_dim, dt, device))
        waves.append(init_chunked_prefill(B, a.n_kv_heads, a.head_dim,
                                          plan.m_max, retro, chunk, dt,
                                          device=device)
                     if runtime == "retro" else None)
    return PrefillChunkState(cache=caches, wave=waves)


def _cache_append_chunk(cache: wa.DenseCache, k, v, clens) -> wa.DenseCache:
    """Append a (B, C, Hkv, hd) chunk at each row's cursor, in place; only
    each row's valid prefix is written."""
    B, C = k.shape[:2]
    cap = cache.k.shape[2]
    j = torch.arange(C, dtype=torch.int32, device=k.device)[None, :]
    idx = torch.where(j < clens[:, None], cache.length[:, None] + j,
                      torch.full_like(j, cap))
    scatter_chunk_rows(cache.k, k.transpose(1, 2), idx)
    scatter_chunk_rows(cache.v, v.transpose(1, 2), idx)
    cache.length.add_(clens)
    return cache


def _chunk_attention(q, cache: wa.DenseCache, t0, clens, *, window=None,
                     softcap=None):
    """Exact causal attention of chunk queries against the admission cache
    (which already holds the chunk), in f32. q: (B, C, Hq, hd); t0: (B,)
    absolute position of q[:, 0]."""
    B, C, Hq, hd = q.shape
    Hkv = cache.k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, C, Hkv, G, hd)
    s = torch.einsum("bchgd,bhtd->bhgct", qg.float(), cache.k.float()) * scale
    s = L.soft_cap(s, softcap)
    kpos = torch.arange(cache.k.shape[2], device=q.device)
    q_abs = t0[:, None] + torch.arange(C, device=q.device)     # (B, C)
    ok = (kpos[None, None, :] <= q_abs[:, :, None]) \
        & (kpos[None, None, :] < (t0 + clens)[:, None, None])
    if window is not None:
        ok = ok & (kpos[None, None, :].float()
                   > q_abs[:, :, None].float() - window)
    s = torch.where(ok[:, None, None, :, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgct,bhtd->bhgcd", p, cache.v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, hd).to(q.dtype)


def prefill_chunk(params, cfg: ModelConfig, tokens, state: PrefillChunkState,
                  *, runtime: str = "retro", chunk_lens=None,
                  patch_embeds=None) -> Tuple[torch.Tensor, PrefillChunkState]:
    """Process the next prompt chunk. tokens: (B, C) right-padded; returns
    (logits at each row's last valid chunk position, new state).
    ``patch_embeds``: the request's whole (B, P, D) vlm patch embeddings;
    the chunk positions below P take theirs in place of the token
    embeddings."""
    a, retro = cfg.attn, cfg.retro
    B, C = tokens.shape
    dev = tokens.device
    clens = torch.full((B,), C, dtype=torch.int32, device=dev) \
        if chunk_lens is None else chunk_lens.to(torch.int32)
    # a copy: the cache appends below advance the lengths in place
    t0 = state.cache[0].length.clone()                       # (B,)
    positions = t0[:, None] + torch.arange(C, device=dev)    # (B, C)
    x = embed_tokens(params, cfg, tokens)
    if patch_embeds is not None:
        P = patch_embeds.shape[1]
        at = positions.clamp(0, P - 1).long()[..., None] \
            .expand(-1, -1, x.shape[-1])
        pe = torch.gather(patch_embeds, 1, at).to(x.dtype)
        x = torch.where((positions < P)[..., None], pe, x)
    caches, waves = [], []
    for lp, cache_l, wave_l, window, kind in zip(
            params["layers"], state.cache, state.wave, params["window"],
            cfg.layer_kinds()):
        h = _norm_in(lp, x, "ln1", cfg)
        q, k, v = _qkv(lp, cfg, kind, h, positions)
        cache_l = _cache_append_chunk(cache_l, k, v, clens)
        o = _chunk_attention(q, cache_l, t0, clens, window=window,
                             softcap=a.softcap)
        x = _add(lp, x, o.reshape(B, C, -1) @ lp["attn"]["wo"], "attn", cfg)
        h = _norm_in(lp, x, "ln2", cfg)
        y = _ffn(lp, h, cfg)[0]
        if runtime == "retro":
            wave_l = prefill_append_chunk(wave_l, k, v, retro, clens)
        waves.append(wave_l)
        caches.append(cache_l)
        x = _add(lp, x, y, "ffn", cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = torch.clamp(clens - 1, min=0).long()
    x_last = x[torch.arange(B, device=dev), last]
    return unembed(params, cfg, x_last), PrefillChunkState(cache=caches,
                                                           wave=waves)


def finalize_prefill_chunk(cfg: ModelConfig, state: PrefillChunkState, *,
                           runtime: str = "retro",
                           total_len: int) -> ServeState:
    """Close a chunked admission: the retro runtime clusters the tail and
    installs the local window of every layer's wave index (the state
    ``prefill_build`` gives); the full runtime's admission cache is the
    serve state as it is."""
    if runtime != "retro":
        return ServeState(kv=state.cache)
    return ServeState(kv=[prefill_finalize(w, cfg.retro, total_len)
                          for w in state.wave])


def decode_step(params, cfg: ModelConfig, state: ServeState, token, *,
                runtime: str = "retro", plan: ZonePlan,
                inline_flush: bool = False,
                active: Optional[torch.Tensor] = None,
                attn_impl: Optional[str] = None, group=None,
                moe_counts: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ServeState]:
    """One generation step. token: (B,) -> logits (B, V) f32.

    ``active``: optional (B,) bool slot mask — free rows skip the KV append;
    their logits are discarded. ``attn_impl`` (retro runtime): "jnp",
    "fused" or "pallas"; None defers to ``cfg.retro.attn_impl``.
    ``inline_flush=True`` runs the staging-buffer flush inside the step
    (``maybe_flush``); the serve engine flushes between steps instead.
    The full runtime's attention reads the whole dense cache, as the
    reference's compiled step does (no length readback, so the step can be
    captured). Every state update is in place, so the returned state holds
    the argument's tensors. ``group`` (retro runtime): a
    ``torch.distributed`` process group over which the cluster axis of
    every layer's state is sharded (``core.distributed.shard_state``); the
    attention is then ``distributed_wave_attention``, which runs the "jnp"
    path only, so any other impl raises. A ring layer (``RingCache``)
    appends in place at its position mod the window and attends exactly.
    ``moe_counts``: the share layers' int64 (2,) row counters
    (``moe.share_apply``), added to in place."""
    a, retro = cfg.attn, cfg.retro
    impl = wa.resolve_attn_impl(attn_impl or retro.attn_impl)
    if group is not None:
        check_group_impl(runtime, impl)
    x = embed_tokens(params, cfg, token)                       # (B, D)
    B = x.shape[0]
    kv = []
    for lp, lstate, window, kind in zip(params["layers"], state.kv,
                                        params["window"], cfg.layer_kinds()):
        pos = lstate.length                                    # (B,)
        h = _norm_in(lp, x, "ln1", cfg)
        q, k, v = _qkv(lp, cfg, kind, h[:, None, :], pos[:, None])
        q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # (B, H*, hd)
        if isinstance(lstate, wa.RingCache):
            lstate = wa.ring_append(lstate, k, v, active=active)
            o = wa.ring_attention_decode(q, lstate, softcap=a.softcap)
        elif runtime == "retro":
            lstate = append_token(lstate, k, v, active=active)
            if group is not None:
                o = distributed_wave_attention(q, lstate, retro, plan, group,
                                               window=window,
                                               softcap=a.softcap)
            else:
                o = wa.wave_attention_decode(q, lstate, retro, plan,
                                             window=window, softcap=a.softcap,
                                             impl=impl).out
            if inline_flush:
                lstate = maybe_flush(lstate, retro)
        else:
            lstate = wa.dense_cache_append(lstate, k, v, active=active)
            o = wa.full_attention_decode(q, lstate, window=window,
                                         softcap=a.softcap)
        x = _add(lp, x, o.reshape(B, -1) @ lp["attn"]["wo"], "attn", cfg)
        h = _norm_in(lp, x, "ln2", cfg)
        x = _add(lp, x, _ffn(lp, h, cfg, step=True, active=active,
                             counts=moe_counts)[0], "ffn", cfg)
        kv.append(lstate)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), ServeState(kv=kv)


# ---------------------------------------------------------------------------
# Hot/cold state split. A decode step changes only the steady zone and the
# counters ("hot"); the cluster stores and the meta index ("cold") change at
# a flush. ``decode_step_split`` takes the two apart: it writes the hot
# tensors in place and never writes a cold one, and with a process group
# each rank holds its own block of the cold cluster axis
# (``core/distributed.py``).
# ---------------------------------------------------------------------------

COLD_FIELDS = ("k_store", "v_store", "pos_store", "centroid", "vsum", "size",
               "stored", "max_pos", "n_clusters")
# the fields a decode step changes (the local append)
HOT_FIELDS = ("sink_k", "sink_v", "local_k", "local_v", "local_len", "length")


def split_state(kv: List[WaveState]) -> Tuple[List[Dict], List[Dict]]:
    """Per-layer WaveStates (``ServeState.kv``) -> (cold, hot): per-layer
    dicts of the same tensors (nothing is copied)."""
    return ([{f: getattr(st, f) for f in COLD_FIELDS} for st in kv],
            [{f: getattr(st, f) for f in HOT_FIELDS} for st in kv])


def join_state(cold: Dict, hot: Dict) -> WaveState:
    """One layer's cold and hot dicts -> its WaveState."""
    return WaveState(**cold, **hot)


def check_group_impl(runtime: str, impl: str) -> None:
    """Sharded retrieval runs the plain path only (as the reference's
    ``shard_wave_attention``): a kernel choice beside a group raises rather
    than go unused."""
    if runtime != "retro":
        raise ValueError(f"a process group shards the retro runtime's "
                         f"cluster axis; runtime {runtime!r} has none")
    if impl != "jnp":
        raise ValueError(f"sharded retrieval runs the 'jnp' attention "
                         f"path; attn impl {impl!r} with a process group")


def decode_step_split(params, cfg: ModelConfig, cold: List[Dict],
                      hot: List[Dict], token, *, plan: ZonePlan, group=None,
                      attn_impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, List[Dict]]:
    """Retro decode over the hot/cold split: -> (logits (B, V) f32, hot).

    ``cold`` / ``hot``: per-layer dicts from ``split_state``, joined into the
    state ``decode_step`` takes. That step updates the hot tensors in place
    (the returned dicts hold them) and only reads the cold ones; with
    ``attn_impl="fused"`` the paged kernel reads the cluster stores where
    they lie. ``group``: see ``decode_step`` (the reference's ``mesh``).
    The reference's ``unroll`` has no counterpart: the layer loop is always
    a Python loop over per-layer state."""
    state = ServeState(kv=[join_state(c, h) for c, h in zip(cold, hot)])
    logits, state = decode_step(params, cfg, state, token, plan=plan,
                                group=group, attn_impl=attn_impl)
    return logits, split_state(state.kv)[1]


# ---------------------------------------------------------------------------
# Host-offload decode: the cluster PAYLOAD stores (k/v/pos_store) live on the
# host; the device keeps the meta index and steady zones ("live" fields) and
# a block cache. One decode layer is two halves with the control plane
# (cluster id -> cache slot, miss fetch, deferred admissions) in between:
#
#   rank:   qkv + local append + centroid ranking + estimation build
#           -> retrieved cluster ids (the engine reads them back per layer)
#   attend: attention over [device block cache | miss staging tail] through
#           the translated slot ids, then output projection + FFN
#
# The same math as ``decode_step``: block payloads are the same bits.
# ---------------------------------------------------------------------------

PAYLOAD_FIELDS = ("k_store", "v_store", "pos_store")
LIVE_FIELDS = tuple(f for f in WaveState._fields if f not in PAYLOAD_FIELDS)


def live_wave_state(live: Dict[str, torch.Tensor]) -> WaveState:
    """WaveState view over the device-resident fields of the offload
    configuration; the payload stores are ``None``."""
    return WaveState(k_store=None, v_store=None, pos_store=None, **live)


def decode_embed(params, cfg: ModelConfig, token):
    """token: (B,) int32 -> (B, D) embedded decode input."""
    return embed_tokens(params, cfg, token)


def decode_unembed(params, cfg: ModelConfig, x):
    """(B, D) final hidden -> (B, V) logits (final norm + unembed)."""
    return unembed(params, cfg, L.rms_norm(x, params["final_norm"],
                                           cfg.norm_eps))


def offload_decode_rank(lp, window, cfg: ModelConfig, live: Dict, x, *,
                        plan: ZonePlan, active: Optional[torch.Tensor] = None):
    """Control-plane half of one offload decode layer. Returns
    ``(ctx, idx_r, new_live)``: ``idx_r`` (B, Hkv, r) are the retrieved
    cluster ids the engine translates into cache slots; ``ctx`` carries the
    query, the estimation inputs and the retrieval cover to
    :func:`offload_decode_attend`."""
    a, retro = cfg.attn, cfg.retro
    B = x.shape[0]
    lstate = live_wave_state(live)
    pos = lstate.length                                      # (B,)
    h = _norm_in(lp, x, "ln1", cfg)
    kind = "l" if window < GLOBAL_WINDOW else "g"
    q, k, v = _qkv(lp, cfg, kind, h[:, None, :], pos[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                      # (B, H*, hd)
    lstate = append_token(lstate, k, v, active=active)
    qg = q.reshape(B, a.n_kv_heads, a.n_heads // a.n_kv_heads, a.head_dim)
    idx_r, est_logit, cs_e, vs_e, cover = wa.wave_decode_rank(
        qg, lstate, retro, plan, window=window, softcap=a.softcap,
        with_cover=True)
    ctx = (q, est_logit, cs_e, vs_e, cover)
    return ctx, idx_r, {f: getattr(lstate, f) for f in LIVE_FIELDS}


def offload_decode_attend(lp, window, cfg: ModelConfig, live: Dict, x, ctx,
                          cache_k, cache_v, cache_pos, idx_slots, valid, *,
                          plan: ZonePlan, attn_impl: Optional[str] = None):
    """Data-plane half: attention over the steady zone and the slot-addressed
    blocks of the device cache (hits) and its staging tail (misses), then
    output projection + FFN. ``valid`` (B, Hkv, r) int32: 0 marks a cluster
    whose fetch failed this step (masked out, covered by the estimation
    zone). Returns the next hidden state."""
    a, retro = cfg.attn, cfg.retro
    impl = wa.resolve_attn_impl(attn_impl or retro.attn_impl)
    B = x.shape[0]
    q, est_logit, cs_e, vs_e, cover = ctx
    out = wa.wave_attention_attend(
        q, live_wave_state(live), retro, plan, idx_slots, est_logit, cs_e,
        vs_e, kv_src=(cache_k, cache_v, cache_pos), window=window,
        softcap=a.softcap, impl=impl, valid=valid, cover=cover).out
    x = _add(lp, x, out.reshape(B, -1) @ lp["attn"]["wo"], "attn", cfg)
    h = _norm_in(lp, x, "ln2", cfg)
    return _add(lp, x, _ffn(lp, h, cfg, step=True)[0], "ffn", cfg)


def offload_flush(cfg: ModelConfig, lives: List[Dict], rows):
    """Index update of the offload path: per layer, cluster the oldest
    update segment into meta entries on the device and return the payload
    blocks for the host stores. ``rows``: (B,) bool. Returns (new live
    dicts, one ``ClusterResult`` per layer with leading (B, H, k_new));
    the blocks of unflushed rows must be ignored."""
    new, blocks = [], []
    for lv in lives:
        st, res = flush_segment_offload(live_wave_state(lv), cfg.retro,
                                        rows=rows)
        new.append({f: getattr(st, f) for f in LIVE_FIELDS})
        blocks.append(res)
    return new, blocks


def init_kv_state(cfg: ModelConfig, B: int, seq_len: int, *, runtime: str,
                  gen_headroom: int, zero_fill: bool, device,
                  ring: bool = False):
    """One attention layer's zero serve state with the structure a prefill
    of ``seq_len`` tokens gives. ``zero_fill=True`` leaves every per-row
    counter at zero (an all-free continuous batch awaiting per-slot grafts)
    instead of pretending each row holds a full ``seq_len`` context.
    ``ring``: a ring layer's ``RingCache``."""
    a, retro, dt = cfg.attn, cfg.retro, torch_dtype(cfg)
    full = lambda n: torch.full((B,), n, dtype=torch.int32, device=device)
    if ring:
        return wa.init_ring(B, a.n_kv_heads, a.sliding_window, a.head_dim,
                            dt, device, 0 if zero_fill else seq_len)
    if runtime == "retro":
        plan = plan_zones(seq_len, retro, gen_headroom)
        st = init_wave_state(B, a.n_kv_heads, a.head_dim, plan.m_max, retro,
                             dt, device)
        if not zero_fill:
            st = st._replace(length=full(seq_len), local_len=full(retro.local),
                             n_clusters=full(plan.m_max))
        return st
    st = wa.init_dense_cache(B, a.n_kv_heads, seq_len + gen_headroom,
                             a.head_dim, dt, device)
    return st if zero_fill else st._replace(length=full(seq_len))


def init_serve_state(cfg: ModelConfig, B: int, seq_len: int, *,
                     runtime: str = "retro", gen_headroom: int = 4096,
                     zero_fill: bool = False, device="cuda") -> ServeState:
    """Zero-initialised serve state with the structure a prefill gives
    (``init_kv_state`` per layer)."""
    return ServeState(kv=[init_kv_state(cfg, B, seq_len, runtime=runtime,
                                        gen_headroom=gen_headroom,
                                        zero_fill=zero_fill, device=device,
                                        ring=ring)
                          for ring in ring_layers(cfg, runtime)])
