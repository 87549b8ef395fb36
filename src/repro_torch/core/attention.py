"""Tripartite wave attention (paper Sec. 4.2) — decode-step attention.

Port of ``repro/core/attention.py``. Ranking and the estimation zone run in
plain PyTorch on the meta index; the merge has the reference's three
implementations (``attn_impl``):

* ``"jnp"`` (the default): the execution buffer — sink, local buffer and the
  retrieved clusters gathered and concatenated — merged in plain PyTorch
  with the reference's cast points (``tripartite_merge_jnp``);
* ``"pallas"``: the same execution buffer merged by the gathered-buffer
  kernel (``kernels.wave_attention`` ``wave_attention_merge``);
* ``"fused"``: the zones handed unconcatenated to the paged kernel, which
  reads the retrieved clusters in place.

The host-offload hooks of the attend half are ported: ``kv_src`` (a device
block cache addressed by cache-slot ids instead of the cluster stores),
``valid`` (degraded decode: clusters whose fetch failed are masked out) and
``cover`` (their mass re-enters through the estimation zone,
``_retrieval_cover``). So are the sharded-retrieval hooks of
``core/distributed.py``: ``cluster_offset`` (a rank's state holds a
contiguous block of the cluster axis), ``include_steady`` (one rank
contributes the steady zone) and ``return_parts`` (the unnormalised
``(num, den, m, idx)`` that ranks combine). The last two take the
execution-buffer path, as in the reference, and only with ``impl="jnp"``:
a kernel impl raises rather than be silently unused.

The dense-cache runtime (``runtime="full"``, the paper's full-attention
comparator) is here too: ``DenseCache``, ``dense_cache_append`` and
``full_attention_decode``, plain code in the reference as in the port.

Port-only: ``RingCache``, the state of a sliding-window layer that keeps
only its window under the retro runtime (``AttnConfig.ring_window``):
``ring_from_prompt``, ``ring_append`` (in place, inside the captured step)
and ``ring_attention_decode`` (exact, f32 accumulation).
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
                  softcap: Optional[float] = None, cluster_offset: int = 0):
    """Rank clusters by centroid score. q_group: (B, Hkv, G, hd).
    Returns (cscore (B,Hkv,G,M) f32, idx_re (B,Hkv,r+e) int64), ids local
    to ``state``. ``cluster_offset``: the global id of the state's cluster
    0 (sharded retrieval: a rank holds M / n consecutive clusters), so a
    local cluster is in range where ``local id + offset < n_clusters``."""
    hd = q_group.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    cs = torch.einsum("bhgd,bhmd->bhgm", q_group.float(), state.centroid) * scale
    cs = soft_cap(cs, softcap)
    M = state.centroid.shape[2]
    in_range = torch.arange(M, device=cs.device)[None, :] + cluster_offset \
        < state.n_clusters[:, None]                          # (B, M)
    valid = in_range[:, None, :] & (state.size > 0)          # (B, Hkv, M)
    if window is not None:
        # the reference compares in f32 (int position - f32 window)
        q_pos = (state.length - 1).float()
        valid = valid & (state.max_pos.float()
                         > (q_pos - window)[:, None, None])
    cs = torch.where(valid[:, :, None, :], cs, torch.full_like(cs, NEG))
    group_score = cs.amax(dim=2)                             # (B, Hkv, M)
    # lax.top_k's order: descending, equal scores (the NEG-masked clusters)
    # by lower id, which a stable sort keeps; the offload path's cache
    # lookups follow this order
    _, order = torch.sort(group_score, dim=-1, descending=True, stable=True)
    return cs, order[..., :plan.r + plan.e]


def _take(a, idx):
    """take_along_axis on the cluster axis 2: a (B,H,M,...), idx (B,H,n)."""
    idx = idx.long().reshape(idx.shape + (1,) * (a.ndim - 3))
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


def _retrieval_cover(state: WaveState, cs, idx_r):
    """Estimation-zone cover of the retrieved clusters (degraded decode):
    per retrieved cluster, the estimate of its STORED tokens,
    ``cov_logit = cs + log(stored_eff)`` and ``cov_vs = vsum * stored_frac``
    (the overflow share is left to ``_estimation_zone``'s overflow entry, so
    the two together equal the whole cluster's estimate). Dead or empty
    clusters get ``cov_logit = NEG``. Meta index only. Returns
    ``(cov_logit (B,H,G,r), cs_r (B,H,G,r), cov_vs (B,H,r,hd))``."""
    B, Hkv, G = cs.shape[:3]
    r = idx_r.shape[2]
    cs_r = torch.gather(cs, 3, idx_r[:, :, None, :].long()
                        .expand(B, Hkv, G, r))
    sz_r = _take(state.size, idx_r)
    st_r = _take(state.stored, idx_r)
    vs_r = _take(state.vsum, idx_r)
    over = torch.clamp(sz_r - st_r, min=0).float()           # (B,H,r)
    st_eff = sz_r.float() - over                             # stored part
    frac = st_eff / torch.clamp(sz_r.float(), min=1.0)
    log_st = torch.where(st_eff > 0, torch.log(torch.clamp(st_eff, min=1.0)),
                         torch.full_like(st_eff, NEG))
    cov_logit = torch.where(st_eff[:, :, None, :] > 0,
                            cs_r + log_st[:, :, None, :],
                            torch.full_like(cs_r, NEG))
    return cov_logit, cs_r, vs_r * frac[..., None]


def _local_positions(state: WaveState):
    """Absolute position of every local-buffer slot, -1 for empty. (B, lbuf)."""
    lbuf = state.local_k.shape[2]
    slot = torch.arange(lbuf, dtype=torch.int32, device=state.length.device)
    l0 = state.length - state.local_len                      # (B,)
    local_pos = l0[:, None] + slot[None, :]
    return torch.where(slot[None, :] < state.local_len[:, None], local_pos,
                       torch.full_like(local_pos, -1))


ATTN_IMPLS = ("jnp", "fused", "pallas")


def resolve_attn_impl(impl: Optional[str]) -> str:
    """Normalize an attention-impl selection: ``None`` -> "jnp"."""
    impl = impl or "jnp"
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn impl {impl!r}; expected {ATTN_IMPLS}")
    return impl


def _gather_clusters(state: WaveState, idx):
    """Gather cluster blocks. idx: (B, Hkv, r) -> stores (B, Hkv, r, cap, ...)."""
    return (_take(state.k_store, idx), _take(state.v_store, idx),
            _take(state.pos_store, idx))


def _fused_wave_attention(qg, state: WaveState, idx_r, est_logit, cs_e, vs_e,
                          *, window, softcap, kv_src=None, valid=None):
    """Hand the raw zones to the paged kernel: sink -> local buffer -> the r
    retrieved clusters read in place -> estimation fold. ``kv_src``: optional
    ``(k_blocks, v_blocks, pos_blocks)`` replacing the cluster stores as the
    block source (``idx_r`` then holds its slot ids); ``valid``: optional
    (B, Hkv, r) mask riding the kernel's ``live`` operand (a 0 cluster is
    skipped like a dead slot)."""
    B, Hkv, G, hd = qg.shape
    k_blk, v_blk, p_blk = kv_src if kv_src is not None else (
        state.k_store, state.v_store, state.pos_store)
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
        live = valid.to(torch.int32) if valid is not None else \
            torch.ones((B, Hkv, r), dtype=torch.int32, device=dev)
    return wa_ops.paged_wave_attention(
        qg.float().contiguous(), state.sink_k, state.sink_v, state.local_k,
        state.local_v, local_pos.contiguous(), k_blk, v_blk, p_blk,
        idx_k.contiguous(), live.contiguous(), rowb.contiguous(),
        est_logit.contiguous(), cs_e.contiguous(), vs_e.float().contiguous(),
        softcap=softcap)


def wave_decode_rank(qg, state: WaveState, retro: RetroConfig, plan: ZonePlan,
                     *, window: Optional[float] = None,
                     softcap: Optional[float] = None,
                     use_estimation: bool = True,
                     overflow_correction: bool = True,
                     cluster_offset: int = 0, with_cover: bool = False):
    """Control-plane half of the decode step: rank clusters and build the
    estimation-zone inputs from the meta index (never the payload stores,
    which the offload path keeps on the host). Returns
    (idx_r, est_logit, cs_e, vs_e), plus the ``_retrieval_cover`` triple
    with ``with_cover``. ``cluster_offset``: see ``rank_clusters``."""
    cs, idx_re = rank_clusters(qg, state, plan, window, softcap,
                               cluster_offset)
    idx_r, idx_e = idx_re[:, :, :plan.r], idx_re[:, :, plan.r:]
    est_logit, cs_e, vs_e = _estimation_zone(
        state, cs, idx_r, idx_e, use_estimation=use_estimation,
        overflow_correction=overflow_correction)
    if with_cover:
        return idx_r, est_logit, cs_e, vs_e, _retrieval_cover(state, cs, idx_r)
    return idx_r, est_logit, cs_e, vs_e


def wave_attention_attend(q, state: WaveState, retro: RetroConfig,
                          plan: ZonePlan, idx, est_logit, cs_e, vs_e, *,
                          kv_src=None, window: Optional[float] = None,
                          softcap: Optional[float] = None, impl: str = "jnp",
                          include_steady: bool = True,
                          return_parts: bool = False,
                          valid=None, cover=None):
    """Data-plane half: exact attention over the steady zone and the
    ``idx``-addressed clusters, merged with the estimation zone.

    ``kv_src``: optional ``(k_blocks, v_blocks, pos_blocks)`` with leading
    (B, Hkv, N) replacing the cluster stores (the offload path's device
    block cache; ``idx`` then holds its slot ids). ``valid``: optional
    (B, Hkv, r) mask: a 0 cluster is masked out of the retrieval zone and,
    with ``cover`` (from ``wave_decode_rank(..., with_cover=True)``), its
    mass re-enters through the estimation zone. An all-ones mask gates
    every cover entry to (NEG, 0).

    Sharded retrieval: ``include_steady=False`` masks the steady zone (sink
    and local buffer) out; ``return_parts`` returns ``(num, den, m, idx)``
    of ``tripartite_merge_parts_jnp`` in place of a ``WaveAttnOut``. Both
    need ``impl="jnp"``."""
    B, Hq, hd = q.shape
    Hkv = state.centroid.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    r = idx.shape[2]
    impl = resolve_attn_impl(impl)
    if (return_parts or not include_steady) and impl != "jnp":
        raise ValueError(
            "return_parts and include_steady=False take the execution-buffer "
            f"path (impl 'jnp'); impl {impl!r} would go unused")

    # ---- degraded decode: estimation-cover the masked-out clusters ---------
    if valid is not None and cover is not None and r > 0:
        v_ok = valid > 0                                     # (B, Hkv, r)
        cov_logit, cov_cs, cov_vs = cover
        cov_logit = torch.where(v_ok[:, :, None, :],
                                torch.full_like(cov_logit, NEG), cov_logit)
        cov_vs = torch.where(v_ok[..., None], torch.zeros_like(cov_vs),
                             cov_vs)
        est_logit = torch.cat([est_logit, cov_logit], 3)
        cs_e = torch.cat([cs_e, cov_cs], 3)
        vs_e = torch.cat([vs_e, cov_vs], 2)

    if impl == "fused":
        out = _fused_wave_attention(qg, state, idx, est_logit, cs_e, vs_e,
                                    window=window, softcap=softcap,
                                    kv_src=kv_src, valid=valid)
        return WaveAttnOut(out.reshape(B, Hq, hd).to(q.dtype), idx)

    # ---- execution buffer: steady zone + retrieved blocks ------------------
    if kv_src is None:
        kb, vb, pb = _gather_clusters(state, idx)            # (B,H,r,cap,hd)
    else:
        kb, vb, pb = (_take(a, idx) for a in kv_src)
    cap = kb.shape[3]
    sink_pos = torch.arange(retro.sink, dtype=torch.int32, device=q.device)
    sink_pos = sink_pos.expand(B, Hkv, retro.sink)
    lbuf = state.local_k.shape[2]
    local_pos = _local_positions(state)[:, None, :].expand(B, Hkv, lbuf)
    k_exec = torch.cat([state.sink_k, state.local_k,
                        kb.reshape(B, Hkv, r * cap, hd)], 2)
    v_exec = torch.cat([state.sink_v, state.local_v,
                        vb.reshape(B, Hkv, r * cap, hd)], 2)
    p_exec = torch.cat([sink_pos, local_pos, pb.reshape(B, Hkv, r * cap)], 2)

    # ---- validity mask over the execution buffer (per-row q_pos) -----------
    qp = (state.length - 1)[:, None, None]
    ok = (p_exec >= 0) & (p_exec <= qp)
    if window is not None:
        # the reference compares in f32 (int position - f32 window)
        ok = ok & (p_exec.float() > qp.float() - window)
    if valid is not None and r > 0:        # degraded decode: mask failed
        # each cluster's flag over its cap tokens (an expand: no host
        # sync, so a CUDA graph can capture it)
        ret_ok = (valid > 0)[..., None].expand(B, Hkv, r, cap) \
            .reshape(B, Hkv, r * cap)
        n_steady = p_exec.shape[2] - r * cap
        ok = ok & torch.cat([torch.ones((B, Hkv, n_steady), dtype=torch.bool,
                                        device=ok.device), ret_ok], 2)
    if not include_steady:            # another rank contributes the steady zone
        ok[:, :, :retro.sink + lbuf] = False
    if return_parts:
        num, den, m = tripartite_merge_parts_jnp(
            qg, k_exec, v_exec, ok, est_logit, cs_e, vs_e, softcap=softcap)
        return num, den, m, idx
    out = tripartite_merge(qg, k_exec, v_exec, ok, est_logit, cs_e, vs_e,
                           softcap=softcap, impl=impl)
    return WaveAttnOut(out.reshape(B, Hq, hd).to(q.dtype), idx)


def tripartite_merge_parts_jnp(qg, k_exec, v_exec, valid, est_logit, cs_e,
                               vs_e, *, softcap: Optional[float] = None):
    """Unnormalized merge: (num (B,H,G,hd), den (B,H,G), m (B,H,G)), with
    num/den scaled by exp(-m). The reference keeps K/V in their storage
    dtype, rounds q (and later p) to it, and accumulates in f32: so do the
    products here (``_f32_product``: f32 outputs from storage-dtype operands
    on the card; the CPU upcasts, exactly, since products of bf16 values are
    exact in f32)."""
    hd = qg.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    s = _f32_product(qg.to(k_exec.dtype), k_exec.transpose(2, 3)) * scale
    s = soft_cap(s, softcap)
    s = torch.where(valid[:, :, None, :], s, torch.full_like(s, NEG))
    m = torch.maximum(s.amax(dim=-1), est_logit.amax(dim=-1))  # (B,H,G)
    m = torch.clamp(m, min=-1e20)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    num = _f32_product(p.to(v_exec.dtype), v_exec)
    live = est_logit > NEG / 2
    zero = torch.zeros_like(est_logit)
    w_den = torch.where(live, torch.exp(est_logit - m[..., None]), zero)
    w_num = torch.where(live, torch.exp(cs_e - m[..., None]), zero)
    den = den + w_den.sum(dim=-1)
    num = num + torch.einsum("bhge,bhed->bhgd", w_num, vs_e.to(f32))
    return num, den, m


def tripartite_merge_jnp(qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e, *,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Reference exact-attention + estimation merge. qg: (B,H,G,hd);
    k_exec/v_exec: (B,H,T,hd); valid: (B,H,T) bool; est_logit/cs_e:
    (B,H,G,E) f32 (NEG-masked); vs_e: (B,H,E,hd). Returns (B,H,G,hd) f32."""
    num, den, _ = tripartite_merge_parts_jnp(
        qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e, softcap=softcap)
    return num / torch.clamp(den, min=1e-30)[..., None]


def tripartite_merge(qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e, *,
                     softcap: Optional[float] = None, impl: str = "jnp"):
    """"jnp" -> plain PyTorch; "pallas" -> the gathered-buffer kernel."""
    if impl == "jnp":
        return tripartite_merge_jnp(qg, k_exec, v_exec, valid, est_logit,
                                    cs_e, vs_e, softcap=softcap)
    return wa_ops.wave_attention_merge(qg, k_exec, v_exec, valid, est_logit,
                                       cs_e, vs_e, softcap=softcap)


def wave_attention_decode(q, state: WaveState, retro: RetroConfig,
                          plan: ZonePlan, *, window: Optional[float] = None,
                          softcap: Optional[float] = None,
                          use_estimation: bool = True,
                          overflow_correction: bool = True,
                          impl: str = "jnp", cluster_offset: int = 0,
                          include_steady: bool = True,
                          return_parts: bool = False):
    """One decode step of tripartite attention. q: (B, Hq, hd) at position
    state.length - 1 (its K/V already appended to the local buffer).
    ``impl``: "jnp", "fused" or "pallas" (see the module docstring).
    ``cluster_offset``, ``include_steady``, ``return_parts``: the
    sharded-retrieval hooks (``rank_clusters``, ``wave_attention_attend``)."""
    B, Hq, hd = q.shape
    Hkv = state.centroid.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    impl = resolve_attn_impl(impl)
    idx_r, est_logit, cs_e, vs_e = wave_decode_rank(
        qg, state, retro, plan, window=window, softcap=softcap,
        use_estimation=use_estimation,
        overflow_correction=overflow_correction,
        cluster_offset=cluster_offset)
    return wave_attention_attend(q, state, retro, plan, idx_r, est_logit,
                                 cs_e, vs_e, window=window, softcap=softcap,
                                 impl=impl, include_steady=include_steady,
                                 return_parts=return_parts)


class DenseCache(NamedTuple):
    """Exact K/V per row: the chunked admission cache, and the serve state
    of the full runtime."""
    k: torch.Tensor            # (B, H, S_max, hd)
    v: torch.Tensor            # (B, H, S_max, hd)
    length: torch.Tensor       # (B,) int32 — valid prefix per row


def init_dense_cache(B, H, S_max, hd, dtype=torch.bfloat16,
                     device="cuda") -> DenseCache:
    z = lambda: torch.zeros((B, H, S_max, hd), dtype=dtype, device=device)
    return DenseCache(z(), z(), torch.zeros((B,), dtype=torch.int32,
                                            device=device))


def dense_cache_append(cache: DenseCache, k_new, v_new,
                       active: Optional[torch.Tensor] = None) -> DenseCache:
    """Append (B, H, hd) K/V at each row's own cursor, in place (the
    ``length`` counter too).

    ``active``: optional (B,) bool; inactive rows (free slots) are left
    untouched. A row at capacity drops the append and keeps its cursor, so
    ``length`` never claims a token the cache does not hold. The reference
    routes both kinds of row to an out-of-range index that XLA drops; an
    out-of-range index faults in torch, so here every row writes its
    (clamped) cursor slot, and the rows that must not append write back
    what the slot holds."""
    B, _, S_max, _ = cache.k.shape
    ar = torch.arange(B, device=k_new.device)
    write = cache.length < S_max
    if active is not None:
        write = write & active
    idx = torch.clamp(cache.length.long(), max=S_max - 1)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf[ar, :, idx] = torch.where(write[:, None, None],
                                      new.to(buf.dtype), buf[ar, :, idx])
    cache.length.add_(write.to(torch.int32))
    return cache


def _f32_product(a, b):
    """Batched ``a @ b`` over the same leading dims with f32 accumulation
    and an f32 output, the reference's ``preferred_element_type=f32``. On
    the card, 16-bit operands are read as they are (``torch.bmm(...,
    out_dtype=float32)``, no f32 copy; ``b`` may be a strided view of a
    cache). The CPU, which has no kernel for that product, and f32 operands
    upcast to f32 (exact: products of bf16 or f16 values are exact in
    f32)."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape((-1,) + a.shape[-2:]),
                    b.reshape((-1,) + b.shape[-2:]), out_dtype=torch.float32)
    return out.reshape(lead + out.shape[-2:])


def full_attention_decode(q, cache: DenseCache, *, window=None, softcap=None,
                          span: Optional[int] = None):
    """q: (B, Hq, hd) against the dense cache: an exact softmax over each
    row's valid positions (``pos < length``, and the sliding window).

    The reference's cast points: q is cast to the cache dtype, scores and
    P @ V accumulate in f32, and p is rounded to the cache dtype before the
    P @ V product; the output is cast to q's dtype. On the card a 16-bit
    cache is read as it is, both products giving f32 (``_f32_product``);
    the CPU, which has no kernel for that product, and an f32 cache upcast
    the operands instead (exact). Only the first ``span`` slots are read
    (default: the whole cache, as the decode step reads it); past the
    longest row's length every position is masked anyway."""
    B, Hq, hd = q.shape
    Hkv = cache.k.shape[1]
    G = Hq // Hkv
    T = cache.k.shape[2] if span is None else min(span, cache.k.shape[2])
    scale = 1.0 / math.sqrt(hd)
    dt = cache.k.dtype
    k, v = cache.k[:, :, :T], cache.v[:, :, :T]
    qg = q.reshape(B, Hkv, G, hd).to(dt)
    s = soft_cap(_f32_product(qg, k.transpose(2, 3)) * scale, softcap)
    pos = torch.arange(T, device=q.device)
    ok = pos[None, :] < cache.length[:, None]                    # (B, T)
    if window is not None:
        ok = ok & (pos[None, :] > (cache.length - 1)[:, None] - window)
    s = torch.where(ok[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1).to(dt)
    out = _f32_product(p, v)
    return out.reshape(B, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the ring of a sliding-window layer (port-only)
# ---------------------------------------------------------------------------

class RingCache(NamedTuple):
    """The last W keys and values of each row: slot s holds the newest
    position p with p % W == s (``pos``; -1 where none yet)."""
    k: torch.Tensor            # (B, H, W, hd)
    v: torch.Tensor            # (B, H, W, hd)
    pos: torch.Tensor          # (B, W) int32
    length: torch.Tensor       # (B,) int32 — tokens seen per row


def init_ring(B, H, W, hd, dtype, device, length: int = 0) -> RingCache:
    z = lambda: torch.zeros((B, H, W, hd), dtype=dtype, device=device)
    return RingCache(z(), z(),
                     torch.full((B, W), -1, dtype=torch.int32, device=device),
                     torch.full((B,), length, dtype=torch.int32,
                                device=device))


def ring_from_prompt(k, v, W: int, dtype, lengths=None) -> RingCache:
    """The ring after a prompt: k, v (B, T, H, hd) post-RoPE; ``lengths``
    (B,) true lengths of right-padded rows (default T). Slot s takes the
    prompt's last position p < length with p % W == s."""
    B, T = k.shape[:2]
    dev = k.device
    n = torch.full((B,), T, dtype=torch.int32, device=dev) \
        if lengths is None else lengths.to(device=dev, dtype=torch.int32)
    s = torch.arange(W, device=dev)
    p = (n[:, None] - 1) - torch.remainder(n[:, None] - 1 - s, W)   # (B, W)
    ok = p >= 0
    at = p.clamp(min=0).long()
    ar = torch.arange(B, device=dev)[:, None]
    take = lambda x: torch.where(ok[..., None, None], x[ar, at], 0) \
        .to(dtype).transpose(1, 2).contiguous()                     # (B,H,W,hd)
    return RingCache(take(k), take(v),
                     torch.where(ok, p, -1).to(torch.int32), n.clone())


def ring_append(ring: RingCache, k_new, v_new,
                active: Optional[torch.Tensor] = None) -> RingCache:
    """Append (B, H, hd) K/V at slot length % W of each row, in place
    (``pos`` and ``length`` too); ``active``: optional (B,) bool, inactive
    rows keep their bits."""
    B, _, W, _ = ring.k.shape
    ar = torch.arange(B, device=k_new.device)
    slot = torch.remainder(ring.length, W).long()
    write = torch.ones((B,), dtype=torch.bool, device=k_new.device) \
        if active is None else active
    for buf, new in ((ring.k, k_new), (ring.v, v_new)):
        buf[ar, :, slot] = torch.where(write[:, None, None],
                                       new.to(buf.dtype), buf[ar, :, slot])
    ring.pos[ar, slot] = torch.where(write, ring.length, ring.pos[ar, slot])
    ring.length.add_(write.to(torch.int32))
    return ring


def ring_attention_decode(q, ring: RingCache, *, softcap=None):
    """q: (B, Hq, hd) -> (B, Hq, hd) in q's dtype: an exact softmax over
    the ring's valid slots (within the window of the row's newest
    position). Scores accumulate in f32 (``_f32_product``: on the card the
    16-bit ring is read as it is); the probabilities stay f32, and the
    values are widened to f32 for their product."""
    B, Hq, hd = q.shape
    Hkv, W = ring.k.shape[1], ring.k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).to(ring.k.dtype)
    s = soft_cap(_f32_product(qg, ring.k.transpose(2, 3))
                 * (1.0 / math.sqrt(hd)), softcap)                 # (B,H,G,W)
    ok = (ring.pos >= 0) & (ring.pos > (ring.length - 1)[:, None] - W)
    p = torch.softmax(torch.where(ok[:, None, None, :], s, NEG), dim=-1)
    out = torch.matmul(p, ring.v.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
