"""Plain PyTorch twin of the block-gather kernel.

Port of ``repro/kernels/gather/ref.py::block_gather_ref``.
"""
from __future__ import annotations

import torch


def block_gather_ref(idx, k_store, v_store):
    """idx: (BH, r); stores: (BH, M, cap, hd) -> (BH, r, cap, hd) pair."""
    i = idx.long()[:, :, None, None].expand(idx.shape + k_store.shape[2:])
    return torch.gather(k_store, 1, i), torch.gather(v_store, 1, i)
