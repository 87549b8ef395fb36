"""Model API of the trainer and the serve engine. Port of
``repro/models/model.py`` (the training and serving API) over every
family — the attention families (dense, moe, vlm: ``transformer``), ssm
(``rwkv6``), hybrid (``hybrid``: mamba2 blocks and a shared attention
block) and audio (``encdec``) — both serve runtimes ("retro": the wave
index; "full": a dense KV cache), blocking and chunked admission:

    params      = init_params(cfg, generator, device)
    logits, aux = apply_train(params, cfg, batch)
    loss        = lm_loss(params, cfg, batch)
    logits, st  = apply_prefill(params, cfg, {"tokens": ...,
                                              "patch_embeds": ...},
                                runtime=..., lengths=..., cache_len=...)
    cs          = make_prefill_chunk_state(cfg, B, max_ctx, chunk=C,
                                           runtime=..., device=...)
    logits, cs  = apply_prefill_chunk(params, cfg, {"tokens": ...}, cs, ...)
    state       = finalize_prefill_chunk(cfg, cs, total_len=L, runtime=...)
    logits, st  = apply_decode(params, cfg, state, token, runtime=...,
                               plan=..., active=..., attn_impl=...)
    state       = flush_state(cfg, state, runtime=...)
    state       = make_serve_state(cfg, B, seq_len, runtime=..., device=...)
    param_specs(cfg), serve_state_specs(cfg, B, seq_len, ...)  # meta trees
    supports_offload(cfg, runtime), offload_decode_fns(cfg)  # host offload

``batch`` keys: tokens (B, T) int; targets (B, T) int and an optional
loss_mask (B, T) (training); patch_embeds (B, P, D) for vlm (in
every chunk's batch of a chunked admission: the chunk takes the slice at
its positions); frames (B, F, D) for audio. As in the reference, the
chunked admission and the offload API exist for the attention families
only (the others raise ``NotImplementedError``; the engine admits them
blocking), the recurrent prefills take no ragged ``lengths``, and ssm
decodes with ``plan=None``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import RingCache
from repro_torch.core.wave_index import flush_segment
from repro_torch.core.zones import ZonePlan, plan_zones
from repro_torch.models import encdec, hybrid, rwkv6, transformer

ATTN_FAMILIES = ("dense", "moe", "vlm")
FAMILIES = ATTN_FAMILIES + ("ssm", "hybrid", "audio")


def _attention_family(cfg: ModelConfig, what: str):
    if cfg.family not in ATTN_FAMILIES:
        raise NotImplementedError(
            f"{what} unsupported for family {cfg.family}")


def _family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random parameters on ``device`` (default ``cuda``). ``generator``
    defaults to one on that device seeded with 0; the meta device draws
    nothing (``param_specs``)."""
    _family(cfg)
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    init = {"ssm": rwkv6.init_rwkv6, "hybrid": hybrid.init_hybrid,
            "audio": encdec.init_encdec}.get(cfg.family,
                                             transformer.init_transformer)
    return init(cfg, generator, dev)


def param_specs(cfg: ModelConfig):
    """The parameter tree with meta tensors for leaves (shape and dtype, no
    storage, no generator): the tree ``init_params`` gives."""
    return init_params(cfg, device="meta")


def _hidden_forward(params, cfg: ModelConfig, batch):
    if cfg.family in ATTN_FAMILIES:
        return transformer.forward(params, cfg, batch["tokens"],
                                   batch.get("patch_embeds"))
    if cfg.family == "ssm":
        return rwkv6.forward(params, cfg, batch["tokens"])
    if cfg.family == "hybrid":
        return hybrid.forward(params, cfg, batch["tokens"])
    return encdec.forward(params, cfg, batch["tokens"], batch["frames"])


def apply_train(params, cfg: ModelConfig, batch):
    """Training forward: -> (logits (B, T, V) f32, aux loss). The attention
    families unembed through their head (tied or ``lm_head``); the others
    through the embedding, as in the reference."""
    _family(cfg)
    x, aux = _hidden_forward(params, cfg, batch)
    if cfg.family in ATTN_FAMILIES:
        return transformer.unembed(params, cfg, x), aux
    return (x @ params["embed"].T).float(), aux


def lm_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean next-token NLL over the tokens (or over the ``loss_mask``
    weights, their sum floored at 1) plus the aux loss; f32 scalar."""
    logits, aux = apply_train(params, cfg, batch)
    targets = batch["targets"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    return nll.sum() / denom + aux


def apply_prefill(params, cfg: ModelConfig, batch, *, runtime: str = "retro",
                  plan: Optional[ZonePlan] = None, gen_headroom: int = 4096,
                  lengths=None, cache_len: Optional[int] = None):
    """Blocking admission: the whole right-padded prompt ``batch['tokens']``
    (B, T) in one pass. ``lengths``: optional (B,) true prompt lengths
    (attention families only: recurrent prefills consume pads).
    ``cache_len``: the full runtime's dense-cache capacity."""
    _family(cfg)
    if cfg.family in ATTN_FAMILIES:
        return transformer.prefill(params, cfg, batch["tokens"],
                                   batch.get("patch_embeds"), runtime=runtime,
                                   plan=plan, gen_headroom=gen_headroom,
                                   lengths=lengths, cache_len=cache_len)
    if lengths is not None:
        raise ValueError("ragged (right-padded) prefill unsupported for "
                         f"family {cfg.family}")
    if cfg.family == "ssm":
        return rwkv6.prefill(params, cfg, batch["tokens"])
    if cfg.family == "hybrid":
        return hybrid.prefill(params, cfg, batch["tokens"], runtime=runtime,
                              plan=plan, gen_headroom=gen_headroom,
                              cache_len=cache_len)
    return encdec.prefill(params, cfg, batch["tokens"], batch["frames"],
                          runtime=runtime, plan=plan,
                          gen_headroom=gen_headroom, cache_len=cache_len)


def supports_chunked_prefill(cfg: ModelConfig, runtime: str = "retro") -> bool:
    """Chunked admission exists for the attention families under both
    runtimes; the recurrent prefills (ssm, hybrid) and the enc-dec decoder
    consume their prompt in one pass, and engines admit them blocking."""
    return cfg.family in ATTN_FAMILIES


def make_prefill_chunk_state(cfg: ModelConfig, B: int, max_ctx: int, *,
                             runtime: str = "retro", chunk: int,
                             gen_headroom: int = 4096, device=None):
    _attention_family(cfg, "chunked prefill")
    return transformer.init_prefill_chunk_state(
        cfg, B, max_ctx, runtime=runtime, chunk=chunk,
        gen_headroom=gen_headroom, device=resolve_device(device))


def apply_prefill_chunk(params, cfg: ModelConfig, batch, state, *,
                        runtime: str = "retro", chunk_lens=None):
    """Consume the next right-padded prompt chunk ``batch['tokens']`` (B, C)
    (and the request's whole ``batch['patch_embeds']``, vlm)."""
    _attention_family(cfg, "chunked prefill")
    return transformer.prefill_chunk(
        params, cfg, batch["tokens"], state, runtime=runtime,
        chunk_lens=chunk_lens, patch_embeds=batch.get("patch_embeds"))


def finalize_prefill_chunk(cfg: ModelConfig, state, *, runtime: str = "retro",
                           total_len: int):
    _attention_family(cfg, "chunked prefill")
    return transformer.finalize_prefill_chunk(cfg, state, runtime=runtime,
                                              total_len=total_len)


def apply_decode(params, cfg: ModelConfig, state, token, *,
                 runtime: str = "retro", plan: Optional[ZonePlan] = None,
                 seq_len: Optional[int] = None, gen_headroom: int = 4096,
                 inline_flush: bool = False, active=None,
                 attn_impl: Optional[str] = None, moe_counts=None):
    """``active``: optional (B,) bool slot mask. ``attn_impl`` (retro
    runtime): "jnp" (reference execution-buffer path), "fused" (paged
    kernel) or "pallas" (gathered-buffer kernel); None defers to
    ``cfg.retro.attn_impl``. ssm needs no plan (its state has no KV).
    ``moe_counts``: the share layers' row counters (attention families;
    ``transformer.decode_step``)."""
    _family(cfg)
    if cfg.family == "ssm":
        return rwkv6.decode_step(params, cfg, state, token)
    if plan is None:
        if seq_len is None:
            raise ValueError("need plan or seq_len")
        plan = plan_zones(seq_len, cfg.retro, gen_headroom)
    step = {"hybrid": hybrid.decode_step,
            "audio": encdec.decode_step}.get(cfg.family,
                                             transformer.decode_step)
    kw = {} if moe_counts is None else {"moe_counts": moe_counts}
    return step(params, cfg, state, token, runtime=runtime, plan=plan,
                inline_flush=inline_flush, active=active, attn_impl=attn_impl,
                **kw)


def supports_offload(cfg: ModelConfig, runtime: str = "retro") -> bool:
    """The host-offload wave buffer needs cluster stores to offload: the
    retro runtime on an attention family (without ring layers)."""
    return runtime == "retro" and cfg.family in ATTN_FAMILIES \
        and not any(transformer.ring_layers(cfg, runtime))


def offload_decode_fns(cfg: ModelConfig):
    """The pieces of the offload decode step: ``(embed, rank, attend,
    unembed, flush)`` (``transformer.offload_decode_rank`` /
    ``offload_decode_attend`` / ``offload_flush``). The engine owns the
    control plane between the two halves."""
    _attention_family(cfg, "host-offload decode")
    return (transformer.decode_embed, transformer.offload_decode_rank,
            transformer.offload_decode_attend, transformer.decode_unembed,
            transformer.offload_flush)


KV_FIELD = {"hybrid": "attn_kv", "audio": "self_kv"}


def kv_states(cfg: ModelConfig, state) -> list:
    """The per-attention-layer KV states of a serve state (WaveStates or
    DenseCaches): every layer's (attention families), every shared-attention
    site's (hybrid), every decoder layer's self-attention (audio); none for
    ssm."""
    if cfg.family == "ssm":
        return []
    return getattr(state, KV_FIELD.get(cfg.family, "kv"))


def flush_state(cfg: ModelConfig, state, *, runtime: str = "retro",
                rows=None):
    """Decode-time segmented-clustering index update of every wave state
    (rows default to those whose staging buffer is full). A no-op for the
    dense caches of the full runtime, for ring layers and for recurrent
    states."""
    _family(cfg)
    if runtime != "retro" or cfg.family == "ssm":
        return state
    return state._replace(**{KV_FIELD.get(cfg.family, "kv"): [
        st if isinstance(st, RingCache) else
        flush_segment(st, cfg.retro, rows=rows)
        for st in kv_states(cfg, state)]})


def needs_flush(cfg: ModelConfig, appended_since_flush: int) -> bool:
    """The staging buffer holds local + update_segment tokens; it must be
    flushed every ``update_segment`` appended tokens."""
    return appended_since_flush >= cfg.retro.update_segment


def make_serve_state(cfg: ModelConfig, B: int, seq_len: int, *,
                     runtime: str = "retro", gen_headroom: int = 4096,
                     zero_fill: bool = False, device=None):
    """Zero serve state with the structure a prefill gives; ``zero_fill``:
    every per-row counter at zero (an all-free batch awaiting grafts)."""
    _family(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return rwkv6.init_serve_state(cfg, B, dev)
    init = {"hybrid": hybrid.init_serve_state,
            "audio": encdec.init_serve_state}.get(
                cfg.family, transformer.init_serve_state)
    return init(cfg, B, seq_len, runtime=runtime, gen_headroom=gen_headroom,
                zero_fill=zero_fill, device=dev)


def serve_state_specs(cfg: ModelConfig, B: int, seq_len: int, *,
                      runtime: str = "retro", gen_headroom: int = 4096):
    """The serve state ``make_serve_state`` allocates, as meta tensors."""
    return make_serve_state(cfg, B, seq_len, runtime=runtime,
                            gen_headroom=gen_headroom, device="meta")
