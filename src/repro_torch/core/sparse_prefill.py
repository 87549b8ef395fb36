"""Block-sparse prefill attention (paper Sec. 5.2, "Compatibility with
Sparse Prefilling", Fig. 12).

Port of ``repro/core/sparse_prefill.py``. Keys are summarised per block
(mean key); each query block keeps its top-k key blocks by the score of its
mean query against them (the sink blocks and the local diagonal band are
always kept), and exact attention runs over the kept blocks only. The wave
index build is unaffected: it consumes the same K/V. The reference writes
this in plain jnp, so its port is plain PyTorch. Only the blocking
admission runs it (``ModelConfig.sparse_prefill_blocks > 0``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import soft_cap

NEG = -1e30


def block_sparse_attention(q, k, v, *, block: int = 128,
                           topk_blocks: int = 16, sink_blocks: int = 1,
                           local_blocks: int = 2,
                           window: Optional[float] = None,
                           softcap: Optional[float] = None):
    """Causal block-sparse attention.

    q: (B, T, Hq, hd); k, v: (B, T, Hkv, hd); T % block == 0. Selection is
    per (kv-head, query block). The selected blocks are the first ``sel`` of
    a stable descending sort of the block scores: ``lax.top_k``'s order,
    which breaks ties (the forced ``+inf`` blocks, the ``NEG`` non-causal
    ones) by lower block id, and the order of the selected blocks sets the
    order of the f32 sums. Each query head reads its kv-head's blocks (the
    reference repeats K/V to Hq heads first: the same values). Returns
    (B, T, Hq, hd) in q's dtype.
    """
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if T % block:
        raise ValueError(f"sequence length {T} does not divide by the block "
                         f"{block}")
    nb = T // block
    sel = min(nb, topk_blocks + sink_blocks + local_blocks)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    # block summaries (f32, after a mean in the input dtype, as in the
    # reference): mean query of each kv-head's group, mean key
    qb = q.reshape(B, nb, block, Hq, hd).mean(dim=2).float()
    kb = k.reshape(B, nb, block, Hkv, hd).mean(dim=2).float()
    # the reference's contraction sums the key summaries over every kv-head
    # ("bqhd,bkgd->bhqk"): kept as it is
    s_blk = torch.einsum("bqhd,bkgd->bhqk",
                         qb.reshape(B, nb, Hkv, G, hd).mean(dim=3),
                         kb) * scale                        # (B, Hkv, nb, nb)
    qi = torch.arange(nb, device=dev)[:, None]
    ki = torch.arange(nb, device=dev)[None, :]
    s_blk = torch.where(ki <= qi, s_blk, NEG)
    forced = (ki < sink_blocks) | ((ki <= qi) & (ki > qi - local_blocks))
    s_blk = torch.where(forced, math.inf, s_blk)
    blk_idx = torch.sort(s_blk, dim=-1, descending=True,
                         stable=True).indices[..., :sel]    # (B, Hkv, nb, sel)

    # gather the selected K/V blocks per (row, kv-head, query block)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    hi = torch.arange(Hkv, device=dev)[None, :, None, None]
    k4 = k.reshape(B, nb, block, Hkv, hd).permute(0, 3, 1, 2, 4)
    v4 = v.reshape(B, nb, block, Hkv, hd).permute(0, 3, 1, 2, 4)
    ks = k4[bi, hi, blk_idx].float()                 # (B, Hkv, nb, sel, blk, hd)
    vs = v4[bi, hi, blk_idx].float()

    qf = q.reshape(B, nb, block, Hkv, G, hd).permute(0, 3, 4, 1, 2, 5).float()
    s = torch.einsum("bhgnqd,bhnskd->bhgnqsk", qf, ks) * scale
    s = soft_cap(s, softcap)

    # causal + window masking at token granularity
    q_pos = torch.arange(nb * block, device=dev).reshape(nb, block)
    k_pos = blk_idx[..., None] * block + torch.arange(block, device=dev)
    kp = k_pos[:, :, None, :, None, :, :]              # (B,Hkv,1,nb,1,sel,blk)
    qp = q_pos[None, None, None, :, :, None, None]     # (1,1,1,nb,blk,1,1)
    ok = kp <= qp
    if window is not None:
        ok = ok & (kp > qp - window)
    s = torch.where(ok, s, NEG)

    m = torch.clamp(s.amax(dim=(-2, -1), keepdim=True), min=-1e20)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    den = p.sum(dim=(-2, -1))
    num = torch.einsum("bhgnqsk,bhnskd->bhgnqd", p, vs)
    out = num / torch.clamp(den, min=1e-30)[..., None]
    # (B, Hkv, G, nb, blk, hd) -> (B, T, Hq, hd), query head h*G + g
    return out.permute(0, 3, 4, 1, 2, 5).reshape(B, T, Hq, hd).to(q.dtype)
