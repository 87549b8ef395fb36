"""Plain PyTorch twin of the segmented k-means step kernel.

Port of ``repro/kernels/kmeans/ref.py``.
"""
from __future__ import annotations

import torch


def kmeans_update_ref(x, assign, k: int):
    """One-hot cluster sums and counts of given assignments.
    x: (S, n, d) f32; assign: (S, n) -> (sums (S, k, d), counts (S, k))."""
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(x.dtype)
    return torch.einsum("snk,snd->skd", onehot, x), onehot.sum(dim=1)


def cluster_order_ref(assign, k: int):
    """The point ids of each segment in cluster order, ascending within a
    cluster, and the clusters' offsets into that order: the permutation the
    CUDA kernel's ``order_kernel`` writes. assign: (S, n) in [0, k) ->
    (order (S, n) int64, offsets (S, k + 1) int64); cluster c's members are
    ``order[s, offsets[s, c]:offsets[s, c + 1]]``."""
    order = torch.sort(assign.long(), dim=1, stable=True).indices
    counts = torch.nn.functional.one_hot(assign.long(), k).sum(dim=1)
    offsets = torch.nn.functional.pad(counts.cumsum(dim=1), (1, 0))
    return order, offsets


def ordered_update_ref(x, assign, k: int):
    """The CUDA kernel's deterministic update: each cluster's sum adds its
    members' rows one at a time in ascending point order, starting from
    zero, in f32. Its sums are the kernel's bit for bit on the same
    assignments (IEEE adds in the same order); against the one-hot sums of
    ``kmeans_update_ref`` they differ only by the order of the additions.
    x: (S, n, d); assign: (S, n) -> (sums (S, k, d), counts (S, k))."""
    S, n, d = x.shape
    order, offsets = cluster_order_ref(assign, k)
    counts = offsets[:, 1:] - offsets[:, :-1]
    sums = torch.zeros((S, k, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(S, device=x.device)[:, None]
    for j in range(int(counts.max()) if n else 0):
        live = counts > j                                   # (S, k)
        at = torch.clamp(offsets[:, :-1] + j, max=n - 1)
        pts = order.gather(1, at)                           # (S, k)
        sums += torch.where(live[..., None], x[rows, pts], 0.0)
    return sums, counts.to(x.dtype)


def kmeans_similarity_ref(x, cent):
    """(S, n, k) inner products of x with the L2-normalised centroids."""
    cn = cent * torch.rsqrt(torch.clamp((cent * cent).sum(-1, keepdim=True),
                                        min=1e-16))
    return torch.einsum("snd,skd->snk", x, cn)


def kmeans_step_ref(x, cent):
    """x: (S, n, d); cent: (S, k, d) -> (sums, counts, assign int32)."""
    assign = kmeans_similarity_ref(x, cent).argmax(dim=-1).to(torch.int32)
    sums, counts = kmeans_update_ref(x, assign, cent.shape[1])
    return sums, counts, assign


def kmeans_ref(x, cent0, iters: int):
    """Full loop: returns (final centroids, assign)."""
    cent = cent0
    for _ in range(iters):
        sums, counts, _ = kmeans_step_ref(x, cent)
        cent = torch.where(counts[..., None] > 0,
                           sums / torch.clamp(counts[..., None], min=1.0), cent)
    _, _, assign = kmeans_step_ref(x, cent)
    return cent, assign


def kmeans_step_check(x, cent, sums, counts, assign):
    """Hold one step's outputs (from the kernel) against the twin, on the
    same inputs. With u = 2^-24:

    * an assignment may differ from the twin's only where the twin's top-2
      similarity gap is under eps = 4 d u |x|, the bound on two f32 dot
      products of length d taken in different orders;
    * sums are recomputed by the twin from the kernel's OWN assignments and
      must agree within 2 c u sum|x| per cluster of c points: any order of
      c f32 additions is off by at most (c - 1) u sum|x|, and both sides
      round (the kernel adds in point order, the twin's matmul in its own);
    * counts are integers below 2^24: exact.

    Returns the measures and ``ok``."""
    u = 2.0 ** -24
    k, d = cent.shape[1], x.shape[2]
    sim = kmeans_similarity_ref(x, cent)
    want = sim.argmax(dim=-1)
    if k > 1:
        top2 = sim.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
    else:
        gap = torch.full_like(sim[..., 0], float("inf"))
    eps = 4 * d * u * torch.linalg.vector_norm(x, dim=-1)
    miss = assign.long() != want
    rs, rc = kmeans_update_ref(x, assign, k)
    mag, _ = kmeans_update_ref(x.abs(), assign, k)
    tol = 2 * rc[..., None] * u * mag
    err = (sums - rs).abs()
    worst = int(torch.argmax(err - tol))
    res = dict(mismatches=int(miss.sum()),
               mismatches_beyond_eps=int((miss & (gap >= eps)).sum()),
               sums_max_abs_err=float(err.max()),
               sums_err_at_worst=float(err.flatten()[worst]),
               sums_tol_at_worst=float(tol.flatten()[worst]),
               counts_max_abs_err=float((counts - rc).abs().max()))
    res["ok"] = (res["mismatches_beyond_eps"] == 0
                 and bool((err <= tol).all())
                 and res["counts_max_abs_err"] == 0.0)
    return res
