"""Wave index: attention-aware cluster index over the KV cache (paper Sec. 4.2).

Port of ``repro/core/wave_index.py``. Per attention layer the state
holds, for every (batch, kv_head): fixed-capacity cluster stores, the meta
index (centroid, value sum, size), the sink zone and a local-window buffer
that doubles as the staging area of decode-time clustering.

Sequence bookkeeping (``length``, ``local_len``, ``n_clusters``) is per row,
so one state holds ragged requests at different positions.

In place: where the JAX code returns a new state from a donated buffer
(``append_token``, the cluster writes, the stage scatters, the decode-time
flush), this port writes into the existing tensors, the per-row counters
included, and returns the state. So a decode state's tensors keep their
addresses from step to step, which a captured CUDA graph needs
(``serving/graphs.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import RetroConfig
from repro_torch.core.clustering import (ClusterResult, cluster_segment,
                                         segmented_cluster)


class WaveState(NamedTuple):
    """Per-layer wave-index state. Leading dims: (B, Hkv, ...)."""
    k_store: torch.Tensor      # (B, H, M, cap, hd)
    v_store: torch.Tensor      # (B, H, M, cap, hd)
    pos_store: torch.Tensor    # (B, H, M, cap) int32, -1 = pad
    centroid: torch.Tensor     # (B, H, M, hd) f32
    vsum: torch.Tensor         # (B, H, M, hd) f32
    size: torch.Tensor         # (B, H, M) int32
    stored: torch.Tensor       # (B, H, M) int32
    max_pos: torch.Tensor      # (B, H, M) int32
    n_clusters: torch.Tensor   # (B,) int32 — active clusters per row
    sink_k: torch.Tensor       # (B, H, sink, hd)
    sink_v: torch.Tensor       # (B, H, sink, hd)
    local_k: torch.Tensor      # (B, H, Lbuf, hd) ring/staging buffer
    local_v: torch.Tensor      # (B, H, Lbuf, hd)
    local_len: torch.Tensor    # (B,) int32 — valid tail of the local buffer
    length: torch.Tensor       # (B,) int32 — total tokens seen per row


STORE_FIELDS = ("k_store", "v_store", "pos_store", "centroid", "vsum", "size",
                "stored", "max_pos")


def local_buffer_size(retro: RetroConfig) -> int:
    return retro.local + retro.update_segment


def prefill_layout(seq_len: int, retro: RetroConfig) -> Tuple[int, int, int]:
    """(n_full_segments, tail_len, n_prefill_clusters) for a prompt of seq_len.
    Clustered region = [sink, seq_len - local), clamped to >= 0."""
    region = max(0, seq_len - retro.sink - retro.local)
    n_full = region // retro.prefill_segment
    tail = region - n_full * retro.prefill_segment
    m = n_full * (retro.prefill_segment // retro.avg_cluster)
    if tail > 0:
        m += max(1, tail // retro.avg_cluster)
    return n_full, tail, m


def max_clusters(seq_len: int, retro: RetroConfig, gen_headroom: int = 4096,
                 pad_multiple: int = 256) -> int:
    """Static cluster-store size: prefill clusters + decode-flush headroom,
    rounded up to ``pad_multiple``."""
    _, _, m = prefill_layout(seq_len, retro)
    m = m + (gen_headroom // retro.update_segment) * (
        retro.update_segment // retro.avg_cluster)
    return max(pad_multiple, ((m + pad_multiple - 1) // pad_multiple) * pad_multiple)


def init_wave_state(B: int, H: int, hd: int, M: int, retro: RetroConfig,
                    dtype=torch.bfloat16, device="cuda") -> WaveState:
    cap, sink, lbuf = retro.cluster_cap, retro.sink, local_buffer_size(retro)
    i32, f32 = torch.int32, torch.float32

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def neg(shape):
        return torch.full(shape, -1, dtype=i32, device=device)

    return WaveState(
        k_store=z((B, H, M, cap, hd), dtype), v_store=z((B, H, M, cap, hd), dtype),
        pos_store=neg((B, H, M, cap)),
        centroid=z((B, H, M, hd), f32), vsum=z((B, H, M, hd), f32),
        size=z((B, H, M), i32), stored=z((B, H, M), i32),
        max_pos=neg((B, H, M)), n_clusters=z((B,), i32),
        sink_k=z((B, H, sink, hd), dtype), sink_v=z((B, H, sink, hd), dtype),
        local_k=z((B, H, lbuf, hd), dtype), local_v=z((B, H, lbuf, hd), dtype),
        local_len=z((B,), i32), length=z((B,), i32))


def _cluster_rows(k, v, pos, retro: RetroConfig, valid=None,
                  segment: Optional[int] = None) -> ClusterResult:
    """Cluster one segment per (row, head), or, with ``segment``, a span of
    whole segments through ``segmented_cluster``. k/v: (B, H, n, hd); pos
    and the optional ``valid`` mask: (B, n). Returns a ClusterResult with
    leading (B, H, k_new). The chunked and the monolithic builds both come
    here, with K/V made contiguous, so they cluster the same bits the same
    way."""
    B, H, n, hd = k.shape

    def rows(a):
        return a[:, None].expand((B, H) + a.shape[1:]).reshape(
            (B * H,) + a.shape[1:])

    args = (k.reshape(B * H, n, hd).contiguous(),
            v.reshape(B * H, n, hd).contiguous(), rows(pos))
    vm = None if valid is None else rows(valid)
    common = (retro.avg_cluster, retro.cluster_cap, retro.kmeans_iters,
              retro.centering)
    if segment is None:
        res = cluster_segment(*args, *common, valid=vm)
    else:
        res = segmented_cluster(*args, segment, *common,
                                serial=retro.serial_prefill_segments, valid=vm)
    return ClusterResult(*(a.reshape((B, H) + a.shape[1:]) for a in res))


def _write_clusters(state: WaveState, res: ClusterResult, offset,
                    rows: Optional[torch.Tensor] = None) -> WaveState:
    """Write a block of freshly clustered segments at per-row cluster
    ``offset`` (B,), in place. ``rows``: optional (B,) bool — unselected rows
    keep their old bits (their slots are rewritten with what they held).
    ``None`` payload stores (the host-offload live view) are skipped: only
    the meta index is written."""
    B, _, M = state.size.shape
    k_new = res.size.shape[2]
    dev = state.size.device
    # the reference's dynamic_update_slice clamps the start to M - k_new
    off = torch.clamp(offset.long(), min=0, max=M - k_new)
    idx = off[:, None] + torch.arange(k_new, device=dev)             # (B, k)
    bidx = torch.arange(B, device=dev)[:, None]
    for f in STORE_FIELDS:
        if getattr(state, f) is None:                    # host-resident store
            continue
        dst = getattr(state, f).transpose(1, 2)          # (B, M, H, ...) view
        new = getattr(res, f).transpose(1, 2).to(dst.dtype)
        if rows is not None:
            sel = rows.reshape((B, 1) + (1,) * (new.ndim - 2))
            new = torch.where(sel, new, dst[bidx, idx])
        dst[bidx, idx] = new
    step = k_new if rows is None else rows.to(torch.int32) * k_new
    state.n_clusters.add_(step)
    return state


def prefill_build(k, v, retro: RetroConfig, M: int, dtype=None,
                  lengths: Optional[torch.Tensor] = None) -> WaveState:
    """Build the wave index from a whole prompt's K/V (blocking admission).

    k, v: (B, S, H, hd) post-RoPE. The sink zone takes the first ``sink``
    tokens, the local window each row's last ``local`` real tokens, and the
    region between them is clustered: ``prefill_segment``-sized segments
    through ``segmented_cluster``, then the partial tail segment.

    ``lengths``: optional (B,) true lengths of right-padded rows; only
    tokens in [sink, lengths[b] - local) enter clusters, so padding never
    reaches a store. Needs lengths[b] >= sink + local. None: every row uses
    all S tokens. For the same K/V the store is the chunked build's
    (``prefill_append_chunk`` + ``prefill_finalize``) bit for bit.
    """
    B, S, H, hd = k.shape
    dtype = dtype or k.dtype
    sink = retro.sink
    if S <= sink:
        raise ValueError(
            f"prompt length {S} must exceed the sink width {sink}")
    dev = k.device
    local = min(retro.local, max(S - sink, 0))
    n_full, tail, _ = prefill_layout(S, retro)
    state = init_wave_state(B, H, hd, M, retro, dtype, dev)
    kbh = k.transpose(1, 2).contiguous()                     # (B, H, S, hd)
    vbh = v.transpose(1, 2).contiguous()
    if lengths is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        valid = None
    else:
        lens = lengths.to(device=dev, dtype=torch.int32)
        # cluster-valid tokens: [sink, lens - local) per row
        valid = torch.arange(S, device=dev)[None, :] < (lens - local)[:, None]

    # per-row local window: the last ``local`` real tokens; the reference's
    # dynamic_slice clamps the start to S - local
    win0 = torch.clamp(lens - local, min=0, max=S - local).long()
    idx = (win0[:, None] + torch.arange(local, device=dev))[:, None, :, None]
    idx = idx.expand(B, H, local, hd)
    state.sink_k.copy_(kbh[:, :, :sink])
    state.sink_v.copy_(vbh[:, :, :sink])
    state.local_k[:, :, :local] = kbh.gather(2, idx)
    state.local_v[:, :, :local] = vbh.gather(2, idx)
    state = state._replace(
        local_len=torch.full((B,), local, dtype=torch.int32, device=dev),
        length=lens.clone())

    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :].expand(B, S)
    seg = retro.prefill_segment
    for t0, n, segment in ((sink, n_full * seg, seg),
                           (sink + n_full * seg, tail, None)):
        if n == 0:
            continue
        res = _cluster_rows(kbh[:, :, t0:t0 + n], vbh[:, :, t0:t0 + n],
                            pos[:, t0:t0 + n], retro,
                            None if valid is None else valid[:, t0:t0 + n],
                            segment=segment)
        state = _write_clusters(state, res, state.n_clusters)
    return state


# ---------------------------------------------------------------------------
# Chunked (streaming) prefill build — admission interleaved with decode.
# Segment boundaries are position- (not chunk-) aligned, and a full segment
# is only clustered once ``local`` further tokens have arrived, so the final
# state equals the monolithic build for any chunk split.
# ---------------------------------------------------------------------------


class ChunkedPrefill(NamedTuple):
    """Streaming prefill-build state. Row b's staged tokens sit at absolute
    positions [seen[b] - staged[b], seen[b])."""
    state: WaveState
    stage_k: torch.Tensor      # (B, H, stage_cap, hd)
    stage_v: torch.Tensor
    staged: torch.Tensor       # (B,) int32 — valid tokens in the staging buffer
    seen: torch.Tensor         # (B,) int32 — prompt tokens consumed so far


def stage_capacity(retro: RetroConfig, chunk: int) -> int:
    return retro.prefill_segment + retro.local + chunk


def init_chunked_prefill(B: int, H: int, hd: int, M: int, retro: RetroConfig,
                         chunk: int, dtype=torch.bfloat16, stage_dtype=None,
                         device="cuda") -> ChunkedPrefill:
    cap = stage_capacity(retro, chunk)
    sd = dtype if stage_dtype is None else stage_dtype
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return ChunkedPrefill(
        state=init_wave_state(B, H, hd, M, retro, dtype, device),
        stage_k=z((B, H, cap, hd), sd), stage_v=z((B, H, cap, hd), sd),
        staged=z((B,), torch.int32), seen=z((B,), torch.int32))


def scatter_chunk_rows(buf, chunk, idx):
    """Per-row scatter of a token chunk into a buffer's token axis, in place.

    buf: (B, H, N, hd); chunk: (B, H, C, hd); idx: (B, C) target slots —
    entries >= N are dropped. Returns ``buf``.

    No host sync: a dropped entry is redirected to repeat its row's first
    kept write (same slot, same value), or, in a row with nothing to keep,
    to rewrite slot 0 with what it holds; duplicate writes of equal values
    leave a well-defined result."""
    B, H, N, hd = buf.shape
    C = idx.shape[1]
    idx = idx.long()
    keep = idx < N
    has = keep.any(dim=1)                                   # (B,)
    first = keep.to(torch.int32).argmax(dim=1, keepdim=True)  # (B, 1)
    src = torch.where(keep, torch.arange(C, device=idx.device)[None, :], first)
    dst = torch.where(keep, idx, idx.gather(1, first))
    dst = torch.where(has[:, None], dst, torch.zeros_like(dst))
    vals = chunk.gather(2, src[:, None, :, None].expand(B, H, C, hd))
    vals = torch.where(has[:, None, None, None], vals.to(buf.dtype),
                       buf[:, :, :1].expand(B, H, C, hd))
    rows = torch.arange(B, device=idx.device)[:, None]
    buf.transpose(1, 2)[rows, dst] = vals.transpose(1, 2)
    return buf


def _roll_rows(buf, shift: int, rows):
    """In place: rows selected by the (B,) bool ``rows`` roll their token
    axis left by ``shift``; the others keep their bits."""
    sel = rows.reshape(-1, 1, 1, 1)
    buf.copy_(torch.where(sel, torch.roll(buf, -shift, dims=2), buf))


def _flush_stage(cp: ChunkedPrefill, retro: RetroConfig) -> ChunkedPrefill:
    """Cluster the oldest full prefill segment of each staging buffer that
    holds prefill_segment + local tokens; other rows are bit-unchanged.
    The any-row check reads the counters back (one small host sync) so that
    chunks that complete no segment run no k-means."""
    seg = retro.prefill_segment
    rows = cp.staged >= seg + retro.local
    if not bool(rows.any()):  # retrolint: sync(chunk completes a segment?)
        return cp
    start = cp.seen - cp.staged                  # abs position of stage[0]
    pos = start[:, None] + torch.arange(seg, dtype=torch.int32,
                                        device=start.device)[None, :]
    res = _cluster_rows(cp.stage_k[:, :, :seg], cp.stage_v[:, :, :seg], pos,
                        retro)
    _write_clusters(cp.state, res, cp.state.n_clusters, rows)
    _roll_rows(cp.stage_k, seg, rows)
    _roll_rows(cp.stage_v, seg, rows)
    cp.staged.sub_(rows.to(torch.int32) * seg)
    return cp


def prefill_append_chunk(cp: ChunkedPrefill, k_chunk, v_chunk,
                         retro: RetroConfig, chunk_lens=None) -> ChunkedPrefill:
    """Extend a streaming build with the next (B, C, H, hd) chunk of prompt
    K/V, in place (counters too). Positions < sink fill the sink zone, the
    rest append to the staging buffer; full segments are clustered as they
    become safe. ``chunk_lens``: optional (B,) valid prefix of this chunk
    per row."""
    B, C, H, hd = k_chunk.shape
    dev = k_chunk.device
    sink = retro.sink
    clens = torch.full((B,), C, dtype=torch.int32, device=dev) \
        if chunk_lens is None else chunk_lens.to(torch.int32)
    kc = k_chunk.transpose(1, 2)                            # (B, H, C, hd)
    vc = v_chunk.transpose(1, 2)

    j = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    p = cp.seen[:, None] + j                                # (B, C) abs pos
    valid = j < clens[:, None]

    sink_idx = torch.where(valid & (p < sink), p, torch.full_like(p, sink))
    j0 = torch.clamp(sink - cp.seen, 0, C)                  # first staged j
    stage_cap = cp.stage_k.shape[2]
    stage_idx = torch.where(valid & (p >= sink),
                            cp.staged[:, None] + j - j0[:, None],
                            torch.full_like(p, stage_cap))

    st = cp.state
    scatter_chunk_rows(st.sink_k, kc, sink_idx)
    scatter_chunk_rows(st.sink_v, vc, sink_idx)
    scatter_chunk_rows(cp.stage_k, kc, stage_idx)
    scatter_chunk_rows(cp.stage_v, vc, stage_idx)
    cp.staged.add_(clens - torch.minimum(torch.clamp(sink - cp.seen, min=0),
                                         clens))
    cp.seen.add_(clens)
    for _ in range(-(-C // retro.prefill_segment)):
        cp = _flush_stage(cp, retro)
    return cp


def prefill_finalize(cp: ChunkedPrefill, retro: RetroConfig,
                     total_len: int) -> WaveState:
    """Close a streaming build: cluster the partial tail segment and install
    the local window. ``total_len`` must equal every row's ``cp.seen``."""
    if total_len <= retro.sink:
        raise ValueError(
            f"prompt length {total_len} must exceed the sink width {retro.sink}")
    local = min(retro.local, total_len - retro.sink)
    _, tail, _ = prefill_layout(total_len, retro)
    state = cp.state
    B = state.local_k.shape[0]
    dev = state.local_k.device

    if tail > 0:
        start = cp.seen - cp.staged
        pos = start[:, None] + torch.arange(tail, dtype=torch.int32,
                                            device=dev)[None, :]
        res = _cluster_rows(cp.stage_k[:, :, :tail], cp.stage_v[:, :, :tail],
                            pos, retro)
        state = _write_clusters(state, res, state.n_clusters)

    state.local_k[:, :, :local] = cp.stage_k[:, :, tail:tail + local]
    state.local_v[:, :, :local] = cp.stage_v[:, :, tail:tail + local]
    return state._replace(
        local_len=torch.full((B,), local, dtype=torch.int32, device=dev),
        length=cp.seen.clone())


def append_token(state: WaveState, k_new, v_new,
                 active: Optional[torch.Tensor] = None) -> WaveState:
    """Append one generated token's (B, H, hd) K/V at each row's
    ``local_len`` cursor, in place (counters too). ``active``: optional
    (B,) bool — inactive rows keep their bits and counters."""
    B = k_new.shape[0]
    lbuf = state.local_k.shape[2]
    dev = k_new.device
    ar = torch.arange(B, device=dev)
    # the reference's dynamic_update_slice clamps the start index
    idx = torch.clamp(state.local_len.long(), max=lbuf - 1)
    for buf, new in ((state.local_k, k_new), (state.local_v, v_new)):
        new = new.to(buf.dtype)
        if active is not None:
            new = torch.where(active[:, None, None], new, buf[ar, :, idx])
        buf[ar, :, idx] = new
    step = 1 if active is None else active.to(torch.int32)
    state.local_len.add_(step)
    state.length.add_(step)
    return state


def flush_segment(state: WaveState, retro: RetroConfig,
                  rows: Optional[torch.Tensor] = None) -> WaveState:
    """Cluster the oldest ``update_segment`` tokens of each full local buffer
    into new clusters and slide the remaining ``local`` tokens to the front.
    ``rows`` (default: buffer full) selects the rows; the rest keep their
    bits. Writes in place."""
    return flush_segment_offload(state, retro, rows=rows)[0]


def flush_segment_offload(state: WaveState, retro: RetroConfig,
                          rows: Optional[torch.Tensor] = None
                          ) -> Tuple[WaveState, ClusterResult]:
    """``flush_segment`` that also returns the freshly clustered
    ``ClusterResult`` of every row (callers apply ``rows`` themselves). The
    host-offload configuration passes a state whose payload stores are
    ``None``: only the meta index is written, and the returned blocks are
    what the host control plane appends at each flushed row's old
    ``n_clusters`` offset."""
    useg = retro.update_segment
    lbuf = local_buffer_size(retro)
    if rows is None:
        rows = state.local_len >= lbuf
    start = state.length - state.local_len                 # abs pos of buffer[0]
    pos = start[:, None] + torch.arange(useg, dtype=torch.int32,
                                        device=start.device)[None, :]
    res = _cluster_rows(state.local_k[:, :, :useg], state.local_v[:, :, :useg],
                        pos, retro)
    state = _write_clusters(state, res, state.n_clusters, rows)
    _roll_rows(state.local_k, useg, rows)
    _roll_rows(state.local_v, useg, rows)
    state.local_len.sub_(rows.to(torch.int32) * useg)
    return state, res


def maybe_flush(state: WaveState, retro: RetroConfig) -> WaveState:
    """Flush (per-row masked) iff any row's staging buffer is full. The
    reference decides inside jit with ``lax.cond``; here the check reads one
    flag back."""
    if bool((state.local_len >= local_buffer_size(retro)).any()):  # retrolint: sync(flush flag)
        return flush_segment(state, retro)
    return state
