"""Plain twin of the prefill attention kernel: chunked online-softmax
attention over key blocks in f32, the body of ``flash_attention_jnp``
(port of ``repro/models/layers.py::flash_attention_jnp``, plain code in
the JAX package too).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def soft_cap(scores, cap: Optional[float]):
    if cap is None or cap <= 0:
        return scores
    return cap * torch.tanh(scores / cap)


def repeat_kv(k, n_rep: int):
    """(B, T, Hkv, d) -> (B, T, Hkv*n_rep, d); head h*n_rep + j copies
    kv-head h."""
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def prefill_attention_ref(q, k, v, *, causal: bool = True, window=None,
                          softcap: Optional[float] = None, q_offset=0,
                          block: int = 1024, out_dtype=None):
    """Chunked online-softmax attention over key blocks of ``block`` tokens,
    in f32 (memory O(Tq * block) per head).

    q: (B, Tq, Hq, d); k, v: (B, Tk, Hkv, d); GQA by head repetition.
    ``window``: sliding-window width (a float; None = global). ``q_offset``:
    absolute position of q[0]. Masked keys score ``-inf``; a row that has
    seen no valid key yet keeps ``m = -inf`` and is guarded by ``m_safe``
    and ``corr`` as in the reference, so fully masked rows give 0, not NaN.
    Returns (B, Tq, Hq, d) in ``out_dtype`` (default q's dtype).
    """
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    q_pos = q_offset + torch.arange(tq, device=dev)
    m = torch.full((b, hq, tq), -math.inf, device=dev)
    l = torch.zeros((b, hq, tq), device=dev)
    acc = torch.zeros((b, hq, tq, d), device=dev)
    for j0 in range(0, max(tk, 1), block):
        kb, vb = kf[:, j0:j0 + block], vf[:, j0:j0 + block]
        n = kb.shape[1]
        s = soft_cap(torch.einsum("bqhd,bkhd->bhqk", qf, kb), softcap)
        k_pos = j0 + torch.arange(n, device=dev)
        valid = torch.ones((tq, n), dtype=torch.bool, device=dev)
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(valid, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(out_dtype or q.dtype)
