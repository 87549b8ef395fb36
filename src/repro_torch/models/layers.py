"""Common functional layers: norms, RoPE, GQA projections, gated MLP.

Port of ``repro/models/layers.py``. Parameters are plain dicts of tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x, gamma, eps: float = 1e-6):
    """RMSNorm with a ``(1 + gamma)`` scale, computed in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + gamma.float())).to(x.dtype)


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


def soft_cap(scores, cap: Optional[float]):
    if cap is None or cap <= 0:
        return scores
    return cap * torch.tanh(scores / cap)


def attention_qkv(p, x, n_heads: int, n_kv: int, head_dim: int, positions,
                  theta: float):
    """Project + rope. x: (B, T, D) -> q (B,T,Hq,hd), k,v (B,T,Hkv,hd)."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, t, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(b, t, n_kv, head_dim)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def mlp_apply(p, x, act: str = "silu"):
    g = x @ p["w_gate"]
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * (x @ p["w_up"])) @ p["w_down"]
