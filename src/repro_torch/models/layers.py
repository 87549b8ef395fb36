"""Common functional layers: init helpers, norms, RoPE, sinusoidal
positions, GQA projections, gated MLP and the chunked online-softmax
attention of the monolithic prefill.

Port of ``repro/models/layers.py``. Parameters are plain dicts of tensors.
``flash_attention_jnp`` keeps the reference's name: it is plain code there
too (no Pallas kernel), so plain PyTorch is its port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(gen: torch.Generator, shape, dtype, device, scale=None):
    """Normal weights scaled by ``scale`` (default 1/sqrt(fan_in), fan_in =
    ``shape[0]``), drawn in f32 from ``gen`` and cast to ``dtype``."""
    scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_attention(gen, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype, device):
    return {"wq": dense_init(gen, (d_model, n_heads * head_dim), dtype, device),
            "wk": dense_init(gen, (d_model, n_kv * head_dim), dtype, device),
            "wv": dense_init(gen, (d_model, n_kv * head_dim), dtype, device),
            "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype, device)}


def init_mlp(gen, d_model: int, d_ff: int, dtype, device):
    return {"w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device)}


def rms_norm(x, gamma, eps: float = 1e-6):
    """RMSNorm with a ``(1 + gamma)`` scale, computed in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """Split-half RoPE. x: (..., T, H, hd); positions broadcastable to (..., T)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    ang = positions[..., None].float() * inv                  # (..., T, hd/2)
    sin = torch.sin(ang)[..., None, :]                        # (..., T, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None):
    """(length, dim) f32 table: sin at even, cos at odd channels."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def soft_cap(scores, cap: Optional[float]):
    if cap is None or cap <= 0:
        return scores
    return cap * torch.tanh(scores / cap)


def _repeat_kv(k, n_rep: int):
    """(B, T, Hkv, d) -> (B, T, Hkv*n_rep, d); head h*n_rep + j copies
    kv-head h."""
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def flash_attention_jnp(q, k, v, *, causal: bool = True, window=None,
                        softcap: Optional[float] = None, q_offset=0,
                        block: int = 1024):
    """Chunked online-softmax attention over key blocks of ``block`` tokens,
    in f32 (memory O(Tq * block) per head).

    q: (B, Tq, Hq, d); k, v: (B, Tk, Hkv, d); GQA by head repetition.
    ``window``: sliding-window width (a float; None = global). ``q_offset``:
    absolute position of q[0]. Masked keys score ``-inf``; a row that has
    seen no valid key yet keeps ``m = -inf`` and is guarded by ``m_safe``
    and ``corr`` as in the reference, so fully masked rows give 0, not NaN.
    Returns (B, Tq, Hq, d) in q's dtype.
    """
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
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
    return out.transpose(1, 2).to(q.dtype)


def attention_qkv(p, x, n_heads: int, n_kv: int, head_dim: int, positions,
                  theta: float):
    """Project + rope. x: (B, T, D) -> q (B,T,Hq,hd), k,v (B,T,Hkv,hd)."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, t, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(b, t, n_kv, head_dim)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def rounded(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``: the reference's weakly typed Python
    constants take the array's dtype before the op. (A tensor op with a
    Python scalar computes with the unrounded scalar.)"""
    # a CPU scalar on every device: no wait on the card, even when captured
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))  # retrolint: sync(host constant)


def sigmoid(x):
    """``jax.nn.sigmoid`` op for op in x's dtype, as the reference lowers
    it: 1 / (1 + exp(-x)), each op rounded (torch's fused sigmoid rounds
    once)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu`` op for op in x's dtype: x * ``sigmoid(x)``."""
    return x * sigmoid(x)


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` op for op in x's dtype, with its
    constants rounded to that dtype, as the reference computes it (torch's
    fused gelu computes in f32 and rounds once, which in bf16 differs in
    about a third of the elements)."""
    c0, c1 = rounded(0.044715, x.dtype), rounded(math.sqrt(2 / math.pi),
                                                  x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c1 * (x + c0 * (x * x * x))))
    return x * cdf


def mlp_apply(p, x, act: str = "silu"):
    g = x @ p["w_gate"]
    g = silu(g) if act == "silu" else gelu_tanh(g)
    return (g * (x @ p["w_up"])) @ p["w_down"]
