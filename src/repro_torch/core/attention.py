"""Tripartite wave attention (paper Sec. 4.2) — decode-step attention.

Port of ``repro/core/attention.py``, fused (``attn_impl="fused"``) branch
only: ranking and the estimation zone run in plain PyTorch on the meta
index; the steady zone, the retrieved clusters and the estimation fold run
in the paged wave-attention kernel (``kernels.wave_attention``). The
execution-buffer merge ("jnp"), the gathered kernel ("pallas"),
``return_parts``, the degraded-decode cover and ``full_attention_decode``
are not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import RetroConfig
from repro_torch.core.wave_index import WaveState
from repro_torch.core.zones import ZonePlan
from repro_torch.kernels.wave_attention import ops as wa_ops
from repro_torch.models.layers import soft_cap

NEG = -1e30


class WaveAttnOut(NamedTuple):
    out: torch.Tensor           # (B, Hq, hd)
    retrieved: torch.Tensor     # (B, Hkv, r) cluster ids


def rank_clusters(q_group, state: WaveState, plan: ZonePlan,
                  window: Optional[float] = None,
                  softcap: Optional[float] = None):
    """Rank clusters by centroid score. q_group: (B, Hkv, G, hd).
    Returns (cscore (B,Hkv,G,M) f32, idx_re (B,Hkv,r+e) int64)."""
    hd = q_group.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    cs = torch.einsum("bhgd,bhmd->bhgm", q_group.float(), state.centroid) * scale
    cs = soft_cap(cs, softcap)
    M = state.centroid.shape[2]
    in_range = torch.arange(M, device=cs.device)[None, :] \
        < state.n_clusters[:, None]                          # (B, M)
    valid = in_range[:, None, :] & (state.size > 0)          # (B, Hkv, M)
    if window is not None:
        # the reference compares in f32 (int position - f32 window)
        q_pos = (state.length - 1).float()
        valid = valid & (state.max_pos.float()
                         > (q_pos - window)[:, None, None])
    cs = torch.where(valid[:, :, None, :], cs, torch.full_like(cs, NEG))
    group_score = cs.amax(dim=2)                             # (B, Hkv, M)
    _, idx_re = torch.topk(group_score, plan.r + plan.e, dim=-1)
    return cs, idx_re


def _take(a, idx):
    """take_along_axis on the cluster axis 2: a (B,H,M,...), idx (B,H,n)."""
    idx = idx.reshape(idx.shape + (1,) * (a.ndim - 3))
    return torch.gather(a, 2, idx.expand(idx.shape[:3] + a.shape[3:]))


def _estimation_zone(state: WaveState, cs, idx_r, idx_e, *,
                     use_estimation: bool = True,
                     overflow_correction: bool = True):
    """Estimation-zone inputs: (est_logit, cs_e (B,H,G,E), vs_e (B,H,E,hd)),
    all meta-index sized. Overflow correction: tokens dropped from retrieved
    stores (size > cap) re-enter through their cluster's estimate."""
    B, Hkv, G = cs.shape[:3]
    hd = state.vsum.shape[-1]
    e = idx_e.shape[2]
    dev = cs.device
    if use_estimation and e > 0:
        cs_e = torch.gather(cs, 3, idx_e[:, :, None, :].expand(B, Hkv, G, e))
        sz_e = _take(state.size, idx_e)                      # (B,H,e)
        vs_e = _take(state.vsum, idx_e)                      # (B,H,e,hd)
        log_sz = torch.log(torch.clamp(sz_e.float(), min=1.0))
        est_logit = cs_e + log_sz[:, :, None, :]
        est_logit = torch.where((sz_e > 0)[:, :, None, :], est_logit,
                                torch.full_like(est_logit, NEG))
    else:
        est_logit = torch.full((B, Hkv, G, 1), NEG, dtype=torch.float32,
                               device=dev)
        cs_e = est_logit
        vs_e = torch.zeros((B, Hkv, 1, hd), dtype=torch.float32, device=dev)

    r = idx_r.shape[2]
    if overflow_correction and use_estimation and r > 0:
        cs_r = torch.gather(cs, 3, idx_r[:, :, None, :].expand(B, Hkv, G, r))
        sz_r = _take(state.size, idx_r)
        st_r = _take(state.stored, idx_r)
        vs_r = _take(state.vsum, idx_r)
        over = torch.clamp(sz_r - st_r, min=0).float()       # (B,H,r)
        frac = over / torch.clamp(sz_r.float(), min=1.0)
        log_over = torch.where(over > 0, torch.log(torch.clamp(over, min=1.0)),
                               torch.full_like(over, NEG))
        est_logit = torch.cat([est_logit, cs_r + log_over[:, :, None, :]], 3)
        cs_e = torch.cat([cs_e, cs_r], 3)
        vs_e = torch.cat([vs_e, vs_r * frac[..., None]], 2)
    return est_logit, cs_e, vs_e


def _local_positions(state: WaveState):
    """Absolute position of every local-buffer slot, -1 for empty. (B, lbuf)."""
    lbuf = state.local_k.shape[2]
    slot = torch.arange(lbuf, dtype=torch.int32, device=state.length.device)
    l0 = state.length - state.local_len                      # (B,)
    local_pos = l0[:, None] + slot[None, :]
    return torch.where(slot[None, :] < state.local_len[:, None], local_pos,
                       torch.full_like(local_pos, -1))


def _fused_wave_attention(qg, state: WaveState, idx_r, est_logit, cs_e, vs_e,
                          *, window, softcap):
    """Hand the raw zones to the paged kernel: sink -> local buffer -> the r
    retrieved clusters read in place -> estimation fold."""
    B, Hkv, G, hd = qg.shape
    r = idx_r.shape[2]
    dev = qg.device
    q_pos = state.length - 1                                  # (B,)
    # per-row bounds: pos <= hi (= q_pos) and pos > lo, where for integer
    # positions p > q_pos - window <=> p > floor(q_pos - window) (in f32)
    hi = q_pos.to(torch.int32)
    if window is None:
        lo = torch.full_like(hi, -1)
    else:
        # f32 arithmetic as in the reference (the window is exact in f32)
        lo = torch.clamp(torch.floor(q_pos.float() - window).to(torch.int32),
                         min=-1)
    rowb = torch.stack([lo, hi], dim=-1)[:, None, :].expand(B, Hkv, 2)
    lbuf = state.local_k.shape[2]
    local_pos = _local_positions(state)[:, None, :].expand(B, Hkv, lbuf)
    if r == 0:            # steady-zone-only plan: one dead retrieval slot
        idx_k = torch.zeros((B, Hkv, 1), dtype=torch.int32, device=dev)
        live = torch.zeros((B, Hkv, 1), dtype=torch.int32, device=dev)
    else:
        idx_k = idx_r.to(torch.int32)
        live = torch.ones((B, Hkv, r), dtype=torch.int32, device=dev)
    return wa_ops.paged_wave_attention(
        qg.float().contiguous(), state.sink_k, state.sink_v, state.local_k,
        state.local_v, local_pos.contiguous(), state.k_store, state.v_store,
        state.pos_store, idx_k.contiguous(), live, rowb.contiguous(),
        est_logit.contiguous(), cs_e.contiguous(), vs_e.float().contiguous(),
        softcap=softcap)


def wave_decode_rank(qg, state: WaveState, retro: RetroConfig, plan: ZonePlan,
                     *, window: Optional[float] = None,
                     softcap: Optional[float] = None,
                     use_estimation: bool = True,
                     overflow_correction: bool = True):
    """Control-plane half of the decode step: rank clusters and build the
    estimation-zone inputs from the meta index. Returns
    (idx_r, est_logit, cs_e, vs_e)."""
    cs, idx_re = rank_clusters(qg, state, plan, window, softcap)
    idx_r, idx_e = idx_re[:, :, :plan.r], idx_re[:, :, plan.r:]
    est_logit, cs_e, vs_e = _estimation_zone(
        state, cs, idx_r, idx_e, use_estimation=use_estimation,
        overflow_correction=overflow_correction)
    return idx_r, est_logit, cs_e, vs_e


def wave_attention_attend(q, state: WaveState, retro: RetroConfig,
                          plan: ZonePlan, idx, est_logit, cs_e, vs_e, *,
                          window: Optional[float] = None,
                          softcap: Optional[float] = None) -> WaveAttnOut:
    """Data-plane half: exact attention over the steady zone and the
    ``idx``-addressed clusters, merged with the estimation zone."""
    B, Hq, hd = q.shape
    Hkv = state.centroid.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    out = _fused_wave_attention(qg, state, idx, est_logit, cs_e, vs_e,
                                window=window, softcap=softcap)
    return WaveAttnOut(out.reshape(B, Hq, hd).to(q.dtype), idx)


def wave_attention_decode(q, state: WaveState, retro: RetroConfig,
                          plan: ZonePlan, *, window: Optional[float] = None,
                          softcap: Optional[float] = None,
                          use_estimation: bool = True,
                          overflow_correction: bool = True) -> WaveAttnOut:
    """One decode step of tripartite attention. q: (B, Hq, hd) at position
    state.length - 1 (its K/V already appended to the local buffer)."""
    B, Hq, hd = q.shape
    Hkv = state.centroid.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    idx_r, est_logit, cs_e, vs_e = wave_decode_rank(
        qg, state, retro, plan, window=window, softcap=softcap,
        use_estimation=use_estimation,
        overflow_correction=overflow_correction)
    return wave_attention_attend(q, state, retro, plan, idx_r, est_logit,
                                 cs_e, vs_e, window=window, softcap=softcap)


class DenseCache(NamedTuple):
    """Exact K/V of a prompt: chunked admission's admission cache."""
    k: torch.Tensor            # (B, H, S_max, hd)
    v: torch.Tensor            # (B, H, S_max, hd)
    length: torch.Tensor       # (B,) int32 — valid prefix per row
