"""Model API used by the serve engine. Port of ``repro/models/model.py``,
dense family, retro runtime with chunked admission:

    params      = init_params(cfg, generator, device)
    cs          = make_prefill_chunk_state(cfg, B, max_ctx, chunk=C, device=...)
    logits, cs  = apply_prefill_chunk(params, cfg, {"tokens": ...}, cs, ...)
    state       = finalize_prefill_chunk(cfg, cs, total_len=L)
    logits, st  = apply_decode(params, cfg, state, token, plan=..., active=...,
                               attn_impl=...)
    state       = flush_state(cfg, state)
    state       = make_serve_state(cfg, B, seq_len, device=...)
    supports_offload(cfg), offload_decode_fns(cfg)   # host-offload decode

Other families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.wave_index import flush_segment
from repro_torch.core.zones import ZonePlan, plan_zones
from repro_torch.models import transformer

PORTED_FAMILIES = ("dense",)


def _dense_only(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{PORTED_FAMILIES})")


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random parameters on ``device`` (default ``cuda``). ``generator``
    defaults to one on that device seeded with 0."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return transformer.init_transformer(cfg, generator, dev)


def make_prefill_chunk_state(cfg: ModelConfig, B: int, max_ctx: int, *,
                             chunk: int, gen_headroom: int = 4096,
                             device=None):
    _dense_only(cfg)
    return transformer.init_prefill_chunk_state(
        cfg, B, max_ctx, chunk=chunk, gen_headroom=gen_headroom,
        device=resolve_device(device))


def apply_prefill_chunk(params, cfg: ModelConfig, batch, state, *,
                        chunk_lens=None):
    """Consume the next right-padded prompt chunk ``batch['tokens']`` (B, C)."""
    _dense_only(cfg)
    return transformer.prefill_chunk(params, cfg, batch["tokens"], state,
                                     chunk_lens=chunk_lens)


def finalize_prefill_chunk(cfg: ModelConfig, state, *, total_len: int):
    _dense_only(cfg)
    return transformer.finalize_prefill_chunk(cfg, state, total_len=total_len)


def apply_decode(params, cfg: ModelConfig, state, token, *,
                 plan: Optional[ZonePlan] = None,
                 seq_len: Optional[int] = None, gen_headroom: int = 4096,
                 active=None, attn_impl: Optional[str] = None):
    """``active``: optional (B,) bool slot mask. ``attn_impl``: "jnp"
    (reference execution-buffer path), "fused" (paged kernel) or "pallas"
    (gathered-buffer kernel); None defers to ``cfg.retro.attn_impl``."""
    _dense_only(cfg)
    if plan is None:
        if seq_len is None:
            raise ValueError("need plan or seq_len")
        plan = plan_zones(seq_len, cfg.retro, gen_headroom)
    return transformer.decode_step(params, cfg, state, token, plan=plan,
                                   active=active, attn_impl=attn_impl)


def supports_offload(cfg: ModelConfig, runtime: str = "retro") -> bool:
    """The host-offload wave buffer needs cluster stores to offload: the
    retro runtime on an attention family (the port has the dense one)."""
    return runtime == "retro" and cfg.family in PORTED_FAMILIES


def offload_decode_fns(cfg: ModelConfig):
    """The pieces of the offload decode step: ``(embed, rank, attend,
    unembed, flush)`` (``transformer.offload_decode_rank`` /
    ``offload_decode_attend`` / ``offload_flush``). The engine owns the
    control plane between the two halves."""
    _dense_only(cfg)
    return (transformer.decode_embed, transformer.offload_decode_rank,
            transformer.offload_decode_attend, transformer.decode_unembed,
            transformer.offload_flush)


def flush_state(cfg: ModelConfig, state, rows=None):
    """Decode-time segmented-clustering index update of every layer (rows
    default to those whose staging buffer is full)."""
    _dense_only(cfg)
    return state._replace(kv=[flush_segment(st, cfg.retro, rows=rows)
                              for st in state.kv])


def make_serve_state(cfg: ModelConfig, B: int, seq_len: int, *,
                     gen_headroom: int = 4096, device=None):
    _dense_only(cfg)
    return transformer.init_serve_state(cfg, B, seq_len,
                                        gen_headroom=gen_headroom,
                                        device=resolve_device(device))
