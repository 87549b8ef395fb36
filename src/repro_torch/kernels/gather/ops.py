"""Wrapper around the block-gather kernel.

Port of ``repro/kernels/gather/ops.py::block_gather_op``. It keeps the
reference's (B, H, ...) layout, flattens (B, H) into BH as views, and then:

* CPU tensors go to the plain twin ``ref.block_gather_ref``;
* CUDA tensors go to the CUDA kernel ``csrc/block_gather.cu`` (built at
  first use, loaded with ctypes) — it launches or raises.

``block_gather_op.launches`` counts kernel launches (never twin runs).
No decode path calls it: the reference's execution buffer gathers with XLA,
and so does the port's (``core.attention._gather_clusters``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather.ref import block_gather_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_gather.cu"
# bytes one CTA moves with one bulk copy in and one out
CHUNK_BYTES = 8192


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.block_gather
    fn.restype = I
    # idx, k_store, v_store, k_out, v_out; BH, M, r, block_bytes,
    # chunk_bytes; stream
    fn.argtypes = [P] * 5 + [I] * 5 + [P]
    return lib


def _check(idx, k_store, v_store):
    B, H, r = idx.shape
    if k_store.dim() != 5 or k_store.shape[:2] != (B, H):
        raise ValueError(f"k_store has shape {tuple(k_store.shape)}, expected "
                         f"({B}, {H}, M, cap, hd)")
    if v_store.shape != k_store.shape or v_store.dtype != k_store.dtype:
        raise ValueError("v_store must match k_store in shape and dtype")
    for t in (k_store, v_store):
        if t.device != idx.device:
            raise ValueError(f"store on {t.device}, ids on {idx.device}")


def block_gather_plain(idx, k_store, v_store):
    """The plain twin on the wrapper's arguments, on any device."""
    _check(idx, k_store, v_store)
    B, H, r = idx.shape
    M, cap, hd = k_store.shape[2:]
    ko, vo = block_gather_ref(idx.reshape(B * H, r),
                              k_store.reshape(B * H, M, cap, hd),
                              v_store.reshape(B * H, M, cap, hd))
    return ko.view(B, H, r, cap, hd), vo.view(B, H, r, cap, hd)


def block_gather_op(idx, k_store, v_store):
    """idx: (B, H, r) cluster ids in [0, M) (repeats allowed); stores:
    (B, H, M, cap, hd) of one dtype -> (k, v) blocks (B, H, r, cap, hd).
    The kernel copies bytes, so any dtype whose (cap, hd) block is a
    multiple of 16 bytes works; it zero-fills the block of an id outside
    [0, M) instead of reading out of bounds."""
    dev = idx.device
    if dev.type == "cpu":
        return block_gather_plain(idx, k_store, v_store)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(idx, k_store, v_store)
    B, H, r = idx.shape
    M, cap, hd = k_store.shape[2:]
    block_bytes = cap * hd * k_store.element_size()
    if block_bytes % 16:
        raise ValueError(f"a (cap, hd) block of {block_bytes} bytes is not a "
                         f"multiple of 16")
    for name, t in (("k_store", k_store), ("v_store", v_store)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    ids = idx.to(torch.int32).contiguous()
    ko = torch.empty((B, H, r, cap, hd), dtype=k_store.dtype, device=dev)
    vo = torch.empty_like(ko)
    err = _lib().block_gather(
        ids.data_ptr(), k_store.data_ptr(), v_store.data_ptr(), ko.data_ptr(),
        vo.data_ptr(), B * H, M, r, block_bytes, CHUNK_BYTES,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_gather kernel launch failed: cudaError "
                           f"{err}")
    block_gather_op.launches += 1
    return ko, vo


block_gather_op.launches = 0
