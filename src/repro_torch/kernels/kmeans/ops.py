"""Wrappers around the segmented k-means step kernel.

Port of ``repro/kernels/kmeans/ops.py``: ``kmeans_step`` is one
assignment + update step over S stacked segments, ``segmented_kmeans_op``
the full loop (a Python loop in place of ``lax.scan``). For a step:

* CPU tensors go to the plain twin ``ref.kmeans_step_ref``;
* CUDA tensors go to the CUDA kernel ``csrc/kmeans_step.cu`` (built at
  first use, loaded with ctypes) — it launches or raises.

``kmeans_step.launches`` counts wrapper calls that launch the kernel (one
per step, though a step is four device launches; never twin runs). No
serving path calls these: the port's clustering, like the reference's, is
plain tensor code (``core/clustering.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kmeans.ref import kmeans_step_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans_step.cu"
# the kernel's centroid tile (BN) and dim chunk (BK) in csrc/kmeans_step.cu:
# the normalised-centroid scratch is padded to multiples of them
CENT_TILE, DIM_TILE = 256, 32


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.kmeans_step
    fn.restype = I
    # x, cent; scratch cn, order, offs; sums, counts, assign;
    # S, n, k, d, kp, dp; stream
    fn.argtypes = [P] * 8 + [I] * 6 + [P]
    return lib


def _check(x, cent):
    if x.dim() != 3 or cent.dim() != 3 or cent.shape[0] != x.shape[0] \
            or cent.shape[2] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and cent {tuple(cent.shape)}: "
                         f"expected (S, n, d) and (S, k, d)")
    if x.dtype != torch.float32 or cent.dtype != torch.float32:
        raise TypeError("x and cent must be float32")
    if cent.device != x.device:
        raise ValueError(f"cent on {cent.device}, x on {x.device}")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def kmeans_step_plain(x, cent):
    """The plain twin on the wrapper's arguments, on any device."""
    _check(x, cent)
    return kmeans_step_ref(x, cent)


def kmeans_step(x, cent):
    """x: (S, n, d) f32 (pre-centred keys); cent: (S, k, d) f32 ->
    (sums (S, k, d) f32, counts (S, k) f32, assign (S, n) int32): spherical
    assignment (lowest index on ties) and the clusters' sums and counts.
    On the card each cluster's sum adds its members in ascending point
    order (``ref.ordered_update_ref``): two calls give the same bits."""
    dev = x.device
    if dev.type == "cpu":
        return kmeans_step_plain(x, cent)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(x, cent)
    S, n, d = x.shape
    k = cent.shape[1]
    if S > 65535:
        raise ValueError(f"kernel takes at most 65535 segments, got {S}")
    x, cent = x.contiguous(), cent.contiguous()
    kp, dp = _round_up(k, CENT_TILE), _round_up(d, DIM_TILE)
    cn = torch.empty(2 * S * kp * dp, dtype=torch.float32, device=dev)
    order = torch.empty((S, max(n, 1)), dtype=torch.int32, device=dev)
    offs = torch.empty((S, k + 1), dtype=torch.int32, device=dev)
    sums = torch.empty((S, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((S, k), dtype=torch.float32, device=dev)
    assign = torch.empty((S, n), dtype=torch.int32, device=dev)
    err = _lib().kmeans_step(
        x.data_ptr(), cent.data_ptr(), cn.data_ptr(), order.data_ptr(),
        offs.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        assign.data_ptr(), S, n, k, d, kp, dp,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_step kernel launch failed: cudaError {err}")
    kmeans_step.launches += 1
    return sums, counts, assign


kmeans_step.launches = 0


def segmented_kmeans_op(x, cent0, *, iters: int):
    """x: (S, n, d) f32; cent0: (S, k, d) f32 -> (centroids, assign) after
    ``iters`` steps and a final assignment. An empty cluster keeps its
    centroid."""
    cent = cent0
    for _ in range(iters):
        sums, counts, _ = kmeans_step(x, cent)
        cent = torch.where(counts[..., None] > 0,
                           sums / torch.clamp(counts[..., None], min=1.0), cent)
    _, _, assign = kmeans_step(x, cent)
    return cent, assign
