"""Plain PyTorch twin of the block-gather kernel.

Port of ``repro/kernels/gather/ref.py::block_gather_ref``.
"""
from __future__ import annotations

import torch


def block_gather_ref(idx, k_store, v_store):
    """idx: (BH, r); stores: (BH, M, cap, hd) -> (BH, r, cap, hd) pair."""
    i = idx.long()[:, :, None, None].expand(idx.shape + k_store.shape[2:])
    return torch.gather(k_store, 1, i), torch.gather(v_store, 1, i)


def block_gather_chunked(idx, k_store, v_store, chunk_bytes: int):
    """The CUDA kernel's decomposition, in plain code: each (row, slot) K
    and V block is moved as the kernel's CTAs move it, one chunk of
    ``chunk_bytes`` (the last may be shorter) at a time, as raw bytes; a
    chunk whose id lies outside [0, M) is written as zeros. Same arguments
    and result as ``block_gather_ref``, which it equals for ids in range.
    Returns (outputs, number of chunks = the kernel's grid)."""
    BH, M = k_store.shape[:2]
    r = idx.shape[1]
    stores = [t.contiguous().view(torch.uint8).reshape(BH, M, -1)
              for t in (k_store, v_store)]
    block_bytes = stores[0].shape[2]
    parts = -(-block_bytes // chunk_bytes)
    outs = [torch.empty((BH, r, block_bytes), dtype=torch.uint8,
                        device=k_store.device) for _ in range(2)]
    for b in range(BH * r * 2 * parts):
        part, kv, slot = b % parts, (b // parts) % 2, b // parts // 2
        row, j = divmod(slot, r)
        c = int(idx[row, j])
        lo = part * chunk_bytes
        hi = min(lo + chunk_bytes, block_bytes)
        if 0 <= c < M:
            outs[kv][row, j, lo:hi] = stores[kv][row, c, lo:hi]
        else:
            outs[kv][row, j, lo:hi] = 0
    shape = (BH, r) + tuple(k_store.shape[2:])
    return tuple(o.view(k_store.dtype).reshape(shape) for o in outs), \
        BH * r * 2 * parts
