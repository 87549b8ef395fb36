"""Segmented spherical k-means (paper Sec. 4.2, "segmented clustering").

Port of ``repro/core/clustering.py`` (with its Fig. 19b helpers
``clustering_recall`` and ``positions_to_local``). The JAX module works on one
(batch, head) segment and is vmapped by its callers; here every function is
batched over a leading segment axis S (callers flatten (B, H) into it). The
reference computes this in jnp outside any Pallas kernel (its k-means kernel
has no centering and no ragged mask, and no path calls it from here), so it
stays plain PyTorch here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ClusterResult(NamedTuple):
    """Fixed-capacity cluster stores for S segments of k clusters each.

    k_store/v_store: (S, k, cap, hd)  padded member keys/values
    pos_store:       (S, k, cap) int32 member positions, -1 where padded
    centroid:        (S, k, hd) f32    mean of ALL assigned raw keys
    vsum:            (S, k, hd) f32    sum of ALL assigned values
    size:            (S, k) int32      total assigned count (incl. overflow)
    stored:          (S, k) int32      members physically stored (<= cap)
    max_pos:         (S, k) int32      max member position
    """
    k_store: torch.Tensor
    v_store: torch.Tensor
    pos_store: torch.Tensor
    centroid: torch.Tensor
    vsum: torch.Tensor
    size: torch.Tensor
    stored: torch.Tensor
    max_pos: torch.Tensor


def _normalize(x, eps=1e-8):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def _one_hot(assign, k):
    """(S, n) int -> (S, n, k) f32; ids outside [0, k) give a zero row."""
    return (assign[..., None] == torch.arange(k, device=assign.device)).float()


def spherical_kmeans(keys, k: int, iters: int, centering: bool = True,
                     valid: Optional[torch.Tensor] = None):
    """keys: (S, n, hd) -> assign (S, n) int64.

    Centroids are L2-normalized before each assignment step (inner-product
    similarity). ``valid``: optional (S, n) bool; invalid tokens never move
    a centroid. (The reference also returns the raw-space centroids, which
    no caller uses; ``build_cluster_stores`` computes the stored ones.)
    """
    S, n, hd = keys.shape
    kf = keys.float()
    if valid is None:
        mu = kf.mean(dim=1, keepdim=True)
        w = None
    else:
        w = valid.float()[..., None]                         # (S, n, 1)
        mu = (kf * w).sum(dim=1, keepdim=True) / torch.clamp(
            w.sum(dim=1, keepdim=True), min=1.0)
    x = kf - mu if centering else kf

    # deterministic strided init: every (n//k)-th (centered) key
    stride = max(1, n // k)
    init_idx = torch.clamp(torch.arange(k, device=keys.device) * stride,
                           max=n - 1)
    cent = x[:, init_idx]                                    # (S, k, hd)

    for _ in range(iters):
        sim = x @ _normalize(cent).transpose(1, 2)           # (S, n, k)
        oh = _one_hot(sim.argmax(dim=-1), k)
        if w is not None:
            oh = oh * w
        counts = oh.sum(dim=1)                               # (S, k)
        sums = oh.transpose(1, 2) @ x                        # (S, k, hd)
        cent = torch.where(counts[..., None] > 0,
                           sums / torch.clamp(counts[..., None], min=1.0),
                           cent)
    return (x @ _normalize(cent).transpose(1, 2)).argmax(dim=-1)


def build_cluster_stores(keys, values, positions, assign, k: int, cap: int,
                         valid: Optional[torch.Tensor] = None) -> ClusterResult:
    """Scatter the tokens of S segments into fixed-capacity cluster stores.

    keys/values: (S, n, hd); positions: (S, n) int; assign: (S, n) in [0, k).
    Tokens beyond a cluster's capacity are dropped from the store but still
    counted in centroid/vsum/size (the estimation zone covers them). Invalid
    tokens are excluded from every store and statistic.
    """
    S, n, hd = keys.shape
    dev = keys.device
    kf, vf = keys.float(), values.float()
    if valid is not None:
        assign = torch.where(valid, assign, torch.full_like(assign, k))

    oh = _one_hot(assign, k)                                 # (S, n, k)
    size = oh.sum(dim=1).to(torch.int32)
    ohT = oh.transpose(1, 2)                                 # (S, k, n)
    centroid = (ohT @ kf) / torch.clamp(size[..., None].float(), min=1.0)
    vsum = ohT @ vf
    neg = torch.full_like(positions, -1)
    max_pos = torch.where(ohT > 0, positions[:, None, :].expand(S, k, n),
                          neg[:, None, :]).amax(dim=-1).to(torch.int32)

    # stable rank of each token within its cluster (token order), which is
    # what the reference's stable argsort grouping yields
    oh_all = (assign[..., None]
              == torch.arange(k + 1, device=dev)).to(torch.int32)
    rank = oh_all.cumsum(dim=1).gather(2, assign[..., None])[..., 0] - 1

    k_store = torch.zeros((S, k * cap + 1, hd), dtype=keys.dtype, device=dev)
    v_store = torch.zeros((S, k * cap + 1, hd), dtype=values.dtype, device=dev)
    pos_store = torch.full((S, k * cap + 1), -1, dtype=torch.int32, device=dev)
    # overflow (rank >= cap) and invalid tokens all land in the extra slot
    # k*cap, which is cut off below (the reference's dropped scatter)
    slot = torch.where((rank < cap) & (assign < k), assign * cap + rank,
                       torch.full_like(rank, k * cap))
    k_store.scatter_(1, slot[..., None].expand(S, n, hd), keys)
    v_store.scatter_(1, slot[..., None].expand(S, n, hd), values)
    pos_store.scatter_(1, slot, positions.to(torch.int32))
    stored = torch.clamp(size, max=cap)
    return ClusterResult(
        k_store[:, :k * cap].reshape(S, k, cap, hd),
        v_store[:, :k * cap].reshape(S, k, cap, hd),
        pos_store[:, :k * cap].reshape(S, k, cap),
        centroid, vsum, size, stored, max_pos)


def cluster_segment(keys, values, positions, avg_cluster: int, cap: int,
                    iters: int, centering: bool,
                    valid: Optional[torch.Tensor] = None) -> ClusterResult:
    """Cluster S segments of n tokens into k = n // avg_cluster clusters each."""
    n = keys.shape[1]
    k = max(1, n // avg_cluster)
    assign = spherical_kmeans(keys, k, iters, centering, valid=valid)
    return build_cluster_stores(keys, values, positions, assign, k, cap,
                                valid=valid)


def segmented_cluster(keys, values, positions, segment: int, avg_cluster: int,
                      cap: int, iters: int, centering: bool,
                      serial: bool = False,
                      valid: Optional[torch.Tensor] = None) -> ClusterResult:
    """Cluster S sequences of n tokens segment by segment (n must divide by
    ``segment``): keys/values (S, n, hd), positions (S, n), optional valid
    (S, n) bool. Returns leading (S, n // avg_cluster) clusters, ordered
    segment-major.

    ``serial=False`` clusters every segment in one batched call (the
    reference's ``vmap``); ``serial=True`` one segment at a time (its
    ``lax.map``), so the k-means working set (similarities, one-hots) is held
    for one segment only. Both give the same result: each segment is
    clustered on its own."""
    S, n, hd = keys.shape
    if n % segment:
        raise ValueError(f"sequence length {n} does not divide by the "
                         f"segment {segment}")
    n_seg = n // segment

    def one(k, v, p, w):
        return cluster_segment(k.contiguous(), v.contiguous(), p, avg_cluster,
                               cap, iters, centering, valid=w)

    if serial:
        parts = [one(keys[:, i * segment:(i + 1) * segment],
                     values[:, i * segment:(i + 1) * segment],
                     positions[:, i * segment:(i + 1) * segment],
                     None if valid is None
                     else valid[:, i * segment:(i + 1) * segment])
                 for i in range(n_seg)]
        return ClusterResult(*(torch.cat(f, dim=1) for f in zip(*parts)))
    res = one(keys.reshape(S * n_seg, segment, hd),
              values.reshape(S * n_seg, segment, hd),
              positions.reshape(S * n_seg, segment),
              None if valid is None else valid.reshape(S * n_seg, segment))
    return ClusterResult(*(a.reshape((S, -1) + a.shape[2:]) for a in res))


def _top_k(x, k: int):
    """The ids of the k largest entries, descending; equal values by lower
    id, as ``lax.top_k`` orders them (a stable descending sort)."""
    return torch.sort(x, descending=True, stable=True)[1][:k]


def clustering_recall(q, keys, result: ClusterResult, r: int,
                      topk: int = 100):
    """Recall@topk of the retrieval zone vs the exact top attention scores
    (the paper's Fig. 19b analysis): the share of the ``topk`` keys with the
    largest ``<key, q>`` whose position lies in one of the ``r`` clusters
    with the largest ``<centroid, q>``.

    q: (hd,); keys: (n, hd); ``result``: one sequence's stores (a leading
    cluster axis: index a batched ``ClusterResult`` by its row first).
    Returns a 0-dim f32 tensor."""
    n = keys.shape[0]
    scores = keys.float() @ q.float()
    true_top = _top_k(scores, topk)
    top_c = _top_k(result.centroid.float() @ q.float(), r)
    pos0 = positions_to_local(result.pos_store[top_c].reshape(-1), n)
    sel = torch.zeros(n + 1, dtype=torch.bool, device=keys.device)
    sel[pos0.long().clamp(0, n)] = True          # slot n: the dropped ones
    return sel[:n][true_top].float().mean()


def positions_to_local(pos, n: int):
    """Map absolute positions to [0, n) assuming the segmenting started at
    0; the -1 pads map to n (out of range: dropped)."""
    return torch.where(pos >= 0, pos, torch.full_like(pos, n))
