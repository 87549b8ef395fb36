"""Mamba-2 (SSD) block, the backbone of the zamba2 hybrid.

Port of ``repro/models/mamba2.py``. Per head h, with scalar decay:
    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (x) B_t
    y_t = S_t @ C_t + D_h * x_t
A short causal depthwise conv precedes (x, B, C). The sequence path
computes the projections, the conv, dt and the decay for the whole prompt
at once; only the ``S`` update and the ``y`` read run as a time loop
(``scan_utils.remat_chunked_scan``), in place on ``S`` when serving and
out of place, with the same roundings, under autograd (the training
forward). The decode step is one O(1) update that writes the state's
tensors in place (``ssm`` and the ``conv`` history), so a captured CUDA
graph replays it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.scan_utils import records, remat_chunked_scan
from repro_torch.models.transformer import torch_dtype


class Mamba2LayerState(NamedTuple):
    ssm: torch.Tensor       # (B, H, hd, N) f32 recurrent state
    conv: torch.Tensor      # (B, conv_k - 1, conv_dim) conv history


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.head_dim, s.state_size, s.conv_kernel


def init_layer(gen: torch.Generator, cfg: ModelConfig, device):
    """One block's parameters with the reference's distributions."""
    D = cfg.d_model
    d_in, H, hd, N, ck = dims(cfg)
    conv_dim = d_in + 2 * N
    dt = torch_dtype(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": torch.zeros((D,), dtype=dt, device=device),
        # in_proj -> [z, x, B, C, dt]
        "in_proj": L.dense_init(gen, (D, 2 * d_in + 2 * N + H), dt, device),
        "conv_w": (torch.randn((ck, conv_dim), generator=gen, device=device)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "out_norm": torch.zeros((d_in,), dtype=dt, device=device),
        "out_proj": L.dense_init(gen, (d_in, D), dt, device),
    }


def _split_proj(cfg, zxbcdt):
    d_in, H, hd, N, _ = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _dt_decay(lp, dtv):
    """dt = softplus(dt_raw + bias) and the decay exp(dt * A), f32."""
    dtv = _softplus(dtv.float() + lp["dt_bias"])
    return dtv, torch.exp(dtv * (-torch.exp(lp["A_log"])))


def _gated_out(lp, cfg, y, z, xin):
    """y (..., d_in) in the activation dtype -> the block's output."""
    y = y * L.silu(z)
    y = L.rms_norm(y, lp["out_norm"], cfg.norm_eps)
    return xin + y @ lp["out_proj"]


def layer_apply_seq(lp, cfg: ModelConfig, xin, return_state: bool = False):
    """xin: (B, T, D) -> (B, T, D) [, the final ``Mamba2LayerState``]."""
    B, T, D = xin.shape
    d_in, H, hd, N, ck = dims(cfg)
    h = L.rms_norm(xin, lp["ln"], cfg.norm_eps)
    z, x, Bm, Cm, dtv = _split_proj(cfg, h @ lp["in_proj"])

    # causal depthwise conv over (x, B, C), op for op as the reference
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    pad = F.pad(xbc, (0, 0, ck - 1, 0))
    conv = sum(pad[:, i:i + T] * lp["conv_w"][i] for i in range(ck))
    conv = L.silu(conv + lp["conv_b"])
    x, Bm, Cm = torch.split(conv, [d_in, N, N], dim=-1)

    xh = x.reshape(B, T, H, hd).float()
    dtv, decay = _dt_decay(lp, dtv)                         # (B, T, H)
    xdt = xh * dtv[..., None]
    inplace = not records(xdt, decay, Bm, Cm)

    def step(S, inp):
        xdt_t, b_t, c_t, dec_t = inp                # shaped to broadcast
        if inplace:
            S.mul_(dec_t).addcmul_(xdt_t, b_t)
        else:
            S = torch.addcmul(S * dec_t, xdt_t, b_t)
        return S, torch.matmul(S, c_t)

    # per-token views shaped for the step, time axis first: the loop body
    # is three kernels and no view ops (it runs T times a layer)
    S0 = torch.zeros((B, H, hd, N), dtype=torch.float32, device=xin.device)
    S, ys = remat_chunked_scan(step, S0, tuple(t.transpose(0, 1) for t in (
        xdt[..., None], Bm.float()[:, :, None, None, :],
        Cm.float()[:, :, None, :, None], decay[..., None, None])))
    y = ys[..., 0].transpose(0, 1) + lp["D"][:, None] * xh
    out = _gated_out(lp, cfg, y.reshape(B, T, d_in).to(xin.dtype), z, xin)
    if return_state:
        # the last ck - 1 inputs, zero before the first (the reference's
        # ``xbc[:, T - (ck - 1):]``, which gives fewer rows when T < ck - 1)
        return out, Mamba2LayerState(
            ssm=S, conv=pad[:, T:].to(torch_dtype(cfg)).contiguous())
    return out


def init_layer_state(cfg: ModelConfig, B: int,
                     device="cuda") -> Mamba2LayerState:
    d_in, H, hd, N, ck = dims(cfg)
    return Mamba2LayerState(
        ssm=torch.zeros((B, H, hd, N), dtype=torch.float32, device=device),
        conv=torch.zeros((B, ck - 1, d_in + 2 * N), dtype=torch_dtype(cfg),
                         device=device))


def layer_decode_step(lp, cfg: ModelConfig, st: Mamba2LayerState, xin):
    """xin: (B, D) -> (out (B, D), st). The state's ``ssm`` and ``conv``
    are updated in place."""
    B, D = xin.shape
    d_in, H, hd, N, ck = dims(cfg)
    h = L.rms_norm(xin, lp["ln"], cfg.norm_eps)
    z, x, Bm, Cm, dtv = _split_proj(cfg, h @ lp["in_proj"])

    xbc = torch.cat([x, Bm, Cm], dim=-1)                    # (B, conv_dim)
    hist = torch.cat([st.conv, xbc[:, None, :]], dim=1)     # (B, ck, cd)
    # a dot over the kernel taps: exact products, f32 sums, one rounding
    conv = (hist.float() * lp["conv_w"].float()).sum(dim=1).to(hist.dtype)
    conv = L.silu(conv + lp["conv_b"])
    x, Bm, Cm = torch.split(conv, [d_in, N, N], dim=-1)

    xh = x.reshape(B, H, hd).float()
    dtv, decay = _dt_decay(lp, dtv)                         # (B, H)
    S = st.ssm
    S.mul_(decay[..., None, None]).add_(
        (xh * dtv[..., None])[..., :, None]
        * Bm.float()[:, None, None, :])
    y = (S @ Cm.float()[:, None, :, None])[..., 0] + lp["D"][:, None] * xh
    st.conv.copy_(hist[:, 1:])
    return _gated_out(lp, cfg, y.reshape(B, d_in).to(xin.dtype), z, xin), st
