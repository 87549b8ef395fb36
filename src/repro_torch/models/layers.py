"""Common functional layers: init helpers, norms, RoPE, sinusoidal
positions, GQA projections, gated MLP and the chunked online-softmax
attention of the monolithic prefill.

Port of ``repro/models/layers.py``. Parameters are plain dicts of tensors.
``flash_attention_jnp`` keeps the reference's name: it is plain code there
(no Pallas kernel); here its plain body is ``kernels/prefill_attention/
ref.py`` (with ``soft_cap`` and ``_repeat_kv``), and the calls of blocking
admission on a CUDA card go to that package's kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.prefill_attention import ops as PA
# soft_cap and _repeat_kv stay importable from here, as in the reference
from repro_torch.kernels.prefill_attention.ref import (  # noqa: F401
    prefill_attention_ref, repeat_kv as _repeat_kv, soft_cap)


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


def flash_attention_jnp(q, k, v, *, causal: bool = True, window=None,
                        softcap: Optional[float] = None, q_offset=0,
                        block: int = 1024):
    """Attention of queries at positions q_offset.. against keys 0..Tk-1,
    in f32: q (B, Tq, Hq, d); k, v (B, Tk, Hkv, d); GQA; ``window`` a
    sliding-window width (None = global); returns (B, Tq, Hq, d) in q's
    dtype.

    On a CUDA card the calls ``prefill_attention.covers`` admits (causal,
    no soft cap, no window or a whole number of positions, bf16 at head dim
    128, no gradient) run the hand-written kernel
    ``kernels/prefill_attention``; every other call, and every call on the
    CPU, runs the plain body ``prefill_attention_ref`` (chunked over key
    blocks of ``block``)."""
    if q.is_cuda and PA.covers(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset):
        return PA.prefill_attention(
            q, k, v, q_offset=q_offset,
            window=PA.kernel_window(window, q_offset, q.shape[1]))
    return prefill_attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset,
                                 block=block)


def attention_qkv(p, x, n_heads: int, n_kv: int, head_dim: int, positions,
                  theta: float, *, qk_eps: Optional[float] = None,
                  rope: bool = True):
    """Project + rope. x: (B, T, D) -> q (B,T,Hq,hd), k,v (B,T,Hkv,hd).
    With ``qk_eps``, q and k are first RMS-normed per head by
    ``p["q_norm"]`` and ``p["k_norm"]``; ``rope`` False leaves them
    unrotated (NoPE)."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, t, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(b, t, n_kv, head_dim)
    if qk_eps is not None:
        q = rms_norm(q, p["q_norm"], qk_eps)
        k = rms_norm(k, p["k_norm"], qk_eps)
    if rope:
        q, k = apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    return q, k, v


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
