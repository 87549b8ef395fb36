"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token mixing with
data-dependent decay. Time-mix keeps a per-head (hd x hd) matrix state with
per-channel decay w_t computed from the input; channel-mix is a
squared-ReLU FFN.

Port of ``repro/models/rwkv6.py``: init, the training forward, prefill,
the decode step and the serve state. The wave index does not apply (no KV
cache). The training forward and the prefill compute everything that does
not depend on the recurrent state for the whole sequence at once (token
shift, the five projections, the decay, the gate, the group norm and the
output projection); only the ``wkv`` recurrence and its read run as a time
loop (``scan_utils.remat_chunked_scan``). Serving updates the state in
place (the decode step's tensors, so a captured CUDA graph replays it);
under autograd the loop's body is out of place, with the same fused
multiply-add, and the forward checkpoints each layer as the reference's
``jax.checkpoint`` does.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.scan_utils import records, remat_chunked_scan
from repro_torch.models.transformer import embed_tokens, torch_dtype, unembed

LORA_RANK = 32


class RwkvLayerState(NamedTuple):
    wkv: torch.Tensor       # (B, H, hd, hd) f32 matrix state
    x_tm: torch.Tensor      # (B, D) previous input (time-mix token shift)
    x_cm: torch.Tensor      # (B, D) previous input (channel-mix token shift)


def _heads(cfg: ModelConfig):
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def init_layer(gen: torch.Generator, cfg: ModelConfig, device):
    """One layer's parameters with the reference's distributions."""
    D, Fd = cfg.d_model, cfg.d_ff
    H, hd = _heads(cfg)
    dt = torch_dtype(cfg)
    full = lambda shape, v: torch.full(shape, v, dtype=dt, device=device)
    dense = lambda shape: L.dense_init(gen, shape, dt, device)
    small = lambda shape, s: (torch.randn(shape, generator=gen,
                                          device=device) * s).to(dt)
    return {
        "ln1": full((D,), 0.0), "ln2": full((D,), 0.0),
        # data-dependent token-shift mixing (5 targets: r, k, v, g, w)
        "mu_x": full((D,), 0.5), "mu": full((5, D), 0.5),
        "lora_a": dense((D, 5 * LORA_RANK)),
        "lora_b": small((5, LORA_RANK, D), 0.01),
        "wr": dense((D, D)), "wk": dense((D, D)), "wv": dense((D, D)),
        "wg": dense((D, D)), "wo": dense((D, D)),
        # data-dependent decay
        "w0": full((D,), -6.0),
        "wd_a": dense((D, LORA_RANK)),
        "wd_b": small((LORA_RANK, D), 0.01),
        "u": small((D,), 0.1),                                  # bonus
        "gn": full((H, hd), 1.0),                               # group norm
        # channel mix
        "mu_ck": full((D,), 0.5), "mu_cr": full((D,), 0.5),
        "ck": dense((D, Fd)), "cv": dense((Fd, D)), "cr": dense((D, D)),
    }


def init_rwkv6(cfg: ModelConfig, gen: torch.Generator,
               device) -> Dict[str, Any]:
    dt = torch_dtype(cfg)
    layers = [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    return {"embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), dt, device,
                                  scale=cfg.d_model ** -0.5),
            "layers": layers,
            "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                      device=device)}


def _ddlerp(lp, x, x_prev):
    """Data-dependent token shift: (5, ..., D) mixed inputs."""
    xx = x_prev - x
    base = x + xx * lp["mu_x"]
    feat = torch.tanh(base @ lp["lora_a"])                  # (..., 5*rank)
    feat = feat.reshape(feat.shape[:-1] + (5, LORA_RANK))
    off = torch.einsum("...fr,frd->f...d", feat.float(),
                       lp["lora_b"].float())
    mu = lp["mu"].reshape((5,) + (1,) * (x.dim() - 1) + (x.shape[-1],))
    return x[None] + xx[None] * (mu + off.to(x.dtype))


def _decay(lp, xw):
    """Per-channel decay in (0, 1): exp(-exp(w0 + lora(xw))), f32."""
    loraw = torch.tanh(xw @ lp["wd_a"]) @ lp["wd_b"]
    return torch.exp(-torch.exp((lp["w0"] + loraw).float()))


def _mix_inputs(lp, H, hd, x, x_prev):
    """Everything of the time-mix that does not read the recurrent state,
    for x: (..., D): r, k, v, w (..., H, hd) f32, and the gate g (..., D)."""
    xr, xk, xv, xg, xw = _ddlerp(lp, x, x_prev)
    lead = x.shape[:-1] + (H, hd)
    r = (xr @ lp["wr"]).reshape(lead).float()
    k = (xk @ lp["wk"]).reshape(lead).float()
    v = (xv @ lp["wv"]).reshape(lead).float()
    g = L.silu(xg @ lp["wg"])
    return r, k, v, _decay(lp, xw).reshape(lead), g


def _wkv_step(S, r, k, v, w, u, inplace: bool = True):
    """One token of the recurrence on S (B, H, hd, hd): out = r (S + u k^T
    v), then S <- w S + k^T v, each a fused multiply-add (``addcmul``), as
    XLA contracts the reference's; S is written in place, or (``inplace``
    False: under autograd) a new tensor. Shaped to broadcast: r, v (B, H,
    1, hd), k, w (B, H, hd, 1) f32; u (H, hd, 1). Returns (out (B, H, 1,
    hd), S)."""
    a = k * v                                               # outer product
    out = torch.matmul(r, torch.addcmul(S, u, a))
    return out, torch.addcmul(a, S, w, out=S if inplace else None)


def _wkv_shapes(r, k, v, w, u):
    """(..., H, hd) inputs -> the shapes ``_wkv_step`` broadcasts; u
    (H, hd) -> (H, hd, 1)."""
    return (r[..., None, :], k[..., None], v[..., None, :], w[..., None],
            u[..., None])


def _time_mix_out(lp, out, g, dtype):
    """Per-head group norm, the gate and the output projection of the
    recurrence's read out (..., H, hd) f32."""
    var = out.square().mean(dim=-1, keepdim=True)
    out = out * torch.rsqrt(var + 1e-6) * lp["gn"].float()
    out = out.reshape(out.shape[:-2] + (-1,)).to(dtype) * g
    return out @ lp["wo"]


def _time_mix_step(lp, H, hd, x, x_prev, S):
    """One token. x: (B, D); S: (B, H, hd, hd), updated in place. Returns
    the time-mix output (B, D)."""
    r, k, v, w, g = _mix_inputs(lp, H, hd, x, x_prev)
    u = lp["u"].float().reshape(H, hd)
    out, _ = _wkv_step(S, *_wkv_shapes(r, k, v, w, u))
    return _time_mix_out(lp, out[..., 0, :], g, x.dtype)


def _channel_mix(lp, x, x_prev):
    xk = x + (x_prev - x) * lp["mu_ck"]
    xr = x + (x_prev - x) * lp["mu_cr"]
    k = torch.square(F.relu(xk @ lp["ck"]))
    return (k @ lp["cv"]) * L.sigmoid(xr @ lp["cr"])


def _shift(h):
    """(B, T, D) -> the previous token's rows, zero before the first."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def layer_apply_seq(lp, cfg: ModelConfig, x, return_state: bool = False):
    """One layer over a whole sequence: x (B, T, D) -> (B, T, D) [, the
    final ``RwkvLayerState``]."""
    B, T, _ = x.shape
    H, hd = _heads(cfg)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    r, k, v, w, g = _mix_inputs(lp, H, hd, h, _shift(h))
    *rkvw, u = _wkv_shapes(r, k, v, w, lp["u"].float().reshape(H, hd))
    inplace = not records(*rkvw, u)

    def step(S, inp):
        out, S = _wkv_step(S, *inp, u, inplace)
        return S, out

    # per-token views shaped for the step, time axis first: the loop body
    # is four kernels and no view ops (it runs T times a layer)
    S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    S, outs = remat_chunked_scan(step, S0, tuple(
        t.transpose(0, 1) for t in rkvw))
    x = x + _time_mix_out(lp, outs[..., 0, :].transpose(0, 1), g, x.dtype)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + _channel_mix(lp, h2, _shift(h2))
    if return_state:
        return x, RwkvLayerState(wkv=S, x_tm=h[:, -1].contiguous(),
                                 x_cm=h2[:, -1].contiguous())
    return x


def init_serve_state(cfg: ModelConfig, B: int,
                     device="cuda") -> List[RwkvLayerState]:
    """Zero recurrent state, one ``RwkvLayerState`` per layer."""
    H, hd = _heads(cfg)
    dt = torch_dtype(cfg)
    return [RwkvLayerState(
        wkv=torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
        x_tm=torch.zeros((B, cfg.d_model), dtype=dt, device=device),
        x_cm=torch.zeros((B, cfg.d_model), dtype=dt, device=device))
        for _ in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, tokens):
    """Prompt processing; returns (last-position logits (B, V) f32, the
    serve state). Every row consumes all T tokens (no ragged lengths)."""
    x = embed_tokens(params, cfg, tokens)
    state = []
    for lp in params["layers"]:
        x, st = layer_apply_seq(lp, cfg, x, return_state=True)
        state.append(st)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x[:, -1]), state


def forward(params, cfg: ModelConfig, tokens):
    """Training forward: tokens (B, T) -> (hidden (B, T, D), aux 0.0), each
    layer checkpointed."""
    x = embed_tokens(params, cfg, tokens)
    for lp in params["layers"]:
        x = checkpoint(layer_apply_seq, lp, cfg, x, use_reentrant=False)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0


def decode_step(params, cfg: ModelConfig, state: List[RwkvLayerState],
                token):
    """token: (B,) -> (logits (B, V) f32, state). Every state tensor is
    updated in place; the returned state is the argument."""
    x = embed_tokens(params, cfg, token)
    H, hd = _heads(cfg)
    for lp, st in zip(params["layers"], state):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + _time_mix_step(lp, H, hd, h, st.x_tm, st.wkv)
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _channel_mix(lp, h2, st.x_cm)
        st.x_tm.copy_(h)
        st.x_cm.copy_(h2)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), state
