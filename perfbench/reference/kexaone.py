"""Plain PyTorch reference of K-EXAONE-236B-A23B (the published
``exaone_moe`` forward, as its config.json and the EXAONE 4.0 technical
report (LG AI Research, 2025) describe it), for the benchmark's check of
served tokens, with the expert-parallel share that the configuration
states.

For layer l, with residual stream x, and n(.) RMSNorm with stored weight w
scaling by (1 + w):

* q = x Wq, k = x Wk, v = x Wv (64 query heads, 8 KV heads, head dim 128);
  q <- n_q(q), k <- n_k(k): a per-head RMSNorm over the head dim;
* sliding layers only (``layer_types`` "sliding_attention"): q, k <- RoPE
  by halves at ``rope_parameters.rope_theta``; global layers take no
  rotation;
* o = softmax(q k^T / sqrt(128) + mask) v, query head h reading KV head
  h // 8; the mask is causal, and on sliding layers it also requires
  p > t - ``sliding_window`` (the window's positions end at the query's
  own);
* x <- x + n_attn_post(o Wo);
* x <- x + n_ffn_post(F_l(x)): F_l the SiLU-gated MLP of width
  ``intermediate_size`` on the leading dense layers (``mlp_layer_types``
  "dense"), else F_l(x) = S(x) + sum over e in top_k(sigmoid(x W_r) + b)
  of ``routed_scaling_factor`` * sigma_e / (sum of the top-k sigma) *
  E_e(x): S the shared expert, E_e the routed experts (SiLU-gated MLPs of
  width ``moe_intermediate_size``), W_r the f32 router over all published
  experts, b the selection bias, which chooses and does not weigh;
* a final RMSNorm, then the untied head.

The expert share: the router scores every published expert and each token
takes its top k of them, but only the experts held here contribute, those
the served weights stack (``layers[i].moe.w_gate`` (E, D, F), from the
configuration's ``first_held_expert``), as the system under test computes
them; the absent experts' part is left out in both. The multi-token
prediction layer (``num_nextn_predict_layers``) serves self-speculative
decoding only and is not computed.

It reads the published sizes from a configuration file's top-level keys
and the weights as the benchmark made them, in the serving layout of the
system under test (a dict: ``embed`` (V, D), ``layers[i]`` with
``ln_post_attn``, ``ln_post_ffn``, ``attn.{wq, wk, wv, wo}`` as (in, out)
matrices and ``attn.{q_norm, k_norm}`` (hd,), ``mlp.{w_gate, w_up,
w_down}`` or ``moe.{router (D, E_pub), router_bias (E_pub,), w_gate (E, D,
F), w_up, w_down (E, F, D), shared.{w_gate, w_up, w_down}}``,
``final_norm``, ``lm_head`` (D, V)); widths are read from the weights'
shapes. Like ``reference/mistral.py``, whose numerics it shares: the token
embedding is multiplied by sqrt(hidden_size), an exact re-parametrisation
of the published table. It imports nothing of that system.

Prefill is exact causal attention, windowed on sliding layers. With
``retro`` the decoded positions of the global layers go through
RetroInfer's tripartite attention (``wave_index.decode_attention``, at the
configuration's budgets); sliding layers attend exactly over their window
at every position. ``precision`` "f32" and "fp8" (the control) are
``reference/mistral.py``'s.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from perfbench.reference import wave_index
from perfbench.reference.mistral import _fp8, _linear, _mlp, _rms_norm, _rope


def _attention(q, k, v, block: int, fp8: bool, window: Optional[int]
               ) -> torch.Tensor:
    """Exact causal attention, windowed where ``window`` is given: q (T,
    Hq, hd), k and v (T', Hkv, hd), T <= T' -> (T, Hq * hd), by blocks of
    ``block`` queries, each against the keys its queries can see."""
    T, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty((T, hq, hd), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    for i0 in range(0, T, block):
        i1 = min(T, i0 + block)
        j0 = 0 if window is None else max(0, i0 - window + 1)
        kt = k[j0:i1].permute(1, 2, 0)                        # (Hkv, hd, n)
        vt = v[j0:i1].permute(1, 0, 2)                        # (Hkv, n, hd)
        qb = q[i0:i1].reshape(i1 - i0, hkv, g, hd).permute(1, 2, 0, 3)
        s = torch.matmul(qb.reshape(hkv, g * (i1 - i0), hd), kt)
        s = s.view(hkv, g, i1 - i0, i1 - j0) * scale
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(j0, i1, device=q.device)[None, :]
        bad = kpos > qpos
        if window is not None:
            bad = bad | (kpos <= qpos - window)
        s.masked_fill_(bad, -math.inf)
        p = torch.softmax(s, dim=-1)
        if fp8:
            p = _fp8(p, -1)
        o = torch.matmul(p.view(hkv, g * (i1 - i0), i1 - j0), vt)
        out[i0:i1] = o.view(hkv, g, i1 - i0, hd).permute(2, 0, 1, 3) \
            .reshape(i1 - i0, hq, hd)
    return out.reshape(T, hq * hd)


def _share(p, x, config: Dict, precision: str, margins=None):
    """The MoE FFN's share: sigmoid scores over all published experts plus
    the selection bias choose the top k; the chosen scores, renormalised
    and scaled, weigh the held experts' outputs; the shared expert adds to
    every token. ``margins``: receives each token's k-th largest selection
    score less its (k+1)-th."""
    k = config["num_experts_per_tok"]
    lo = config["first_held_expert"]
    n_held = p["w_gate"].shape[0]
    score = torch.sigmoid(_linear(x, p["router"], precision))
    sel = score + p["router_bias"].float()
    if margins is not None:
        top = torch.topk(sel, k + 1, dim=-1).values
        margins.append(top[:, k - 1] - top[:, k])
    top_e = torch.sort(sel, dim=-1, descending=True, stable=True)[1][:, :k]
    top_s = torch.gather(score, 1, top_e)
    top_w = top_s / top_s.sum(dim=-1, keepdim=True) \
        * config["routed_scaling_factor"]
    y = _mlp(p["shared"], x, precision)
    for e in range(n_held):
        tok, slot = torch.nonzero(top_e == lo + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ex = {"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
              "w_down": p["w_down"][e]}
        y.index_add_(0, tok, _mlp(ex, x[tok], precision)
                     * top_w[tok, slot][:, None])
    return y


def _attend(q, k, v, block, precision, retro, config, window):
    """A layer's attention: exact (windowed on sliding layers), or on a
    global layer from ``retro["prompt_len"]`` on through the wave index."""
    fp8 = precision == "fp8"
    if retro is None or window is not None:
        return _attention(q, k, v, block, fp8, window)
    n = retro["prompt_len"]
    pre = _attention(q[:n], k[:n], v[:n], block, fp8, None)
    if q.shape[0] == n:
        return pre
    dec = wave_index.decode_attention(
        q[n:], k, v, n, config["wave_index"], retro["r"], retro["e"],
        fp8=(lambda t: _fp8(t, -1)) if fp8 else None)
    return torch.cat([pre, dec])


@torch.inference_mode()
def logits(weights: Dict, config: Dict, tokens: torch.Tensor, first: int,
           precision: str = "f32", block: int = 1024,
           retro: Optional[Dict] = None,
           out: Optional[Dict] = None) -> torch.Tensor:
    """Next-token logits (T - first, V) in float32 at positions first ..
    T - 1 of the 1-D token sequence ``tokens``. ``retro`` and ``out`` (its
    ``router_margin``: each position's smallest selection margin over the
    MoE layers) as in ``reference/mistral.py``."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(weights, config, tokens, first, precision, block,
                       retro, out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def _logits(weights, config, tokens, first, precision, block, retro, out):
    d = config["hidden_size"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]
    eps = config["rms_norm_eps"]
    theta = config["rope_parameters"]["rope_theta"]
    kinds = config["layer_types"]
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    margins: Optional[List] = [] if out is not None else None
    x = weights["embed"][tokens.long()].float() * math.sqrt(d)
    for i, lp in enumerate(weights["layers"]):
        a = lp["attn"]
        sliding = kinds[i] == "sliding_attention"
        q = _rms_norm(_linear(x, a["wq"], precision).view(T, hq, hd),
                      a["q_norm"], eps)
        k = _rms_norm(_linear(x, a["wk"], precision).view(T, hkv, hd),
                      a["k_norm"], eps)
        v = _linear(x, a["wv"], precision).view(T, hkv, hd)
        if sliding:
            q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        if precision == "fp8":
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
        o = _attend(q, k, v, block, precision, retro, config,
                    config["sliding_window"] if sliding else None)
        x = x + _rms_norm(_linear(o, a["wo"], precision), lp["ln_post_attn"],
                          eps)
        del q, k, v, o
        f = _share(lp["moe"], x, config, precision, margins) \
            if "moe" in lp else _mlp(lp["mlp"], x, precision)
        x = x + _rms_norm(f, lp["ln_post_ffn"], eps)
        del f
    x = _rms_norm(x[first:], weights["final_norm"], eps)
    if out is not None:
        out["router_margin"] = torch.stack(margins).amin(0)[first:] \
            if margins else torch.full((T - first,), math.inf,
                                       device=x.device)
    return _linear(x, weights["lm_head"], precision)


def served_gaps(weights: Dict, config: Dict, prompt: torch.Tensor,
                served: List[int], precision: str = "f32",
                judge: Optional[torch.Tensor] = None,
                retro: Optional[Dict] = None,
                out: Optional[Dict] = None) -> torch.Tensor:
    """Per served token, how far its logit lies below the best logit at its
    position under the float32 reference; the arguments as
    ``reference/mistral.py::served_gaps``'s."""
    seq = torch.cat([prompt.long(), torch.tensor(served[:-1], dtype=torch.long,
                                                 device=prompt.device)])
    first = prompt.shape[0] - 1
    if retro is not None:
        retro = dict(retro, prompt_len=prompt.shape[0])
    ref = judge if judge is not None else logits(weights, config, seq, first,
                                                 retro=retro, out=out)
    if precision == "f32":
        toks = torch.tensor(served, dtype=torch.long, device=ref.device)
    else:
        toks = logits(weights, config, seq, first, precision,
                      retro=retro).argmax(dim=-1)
    picked = ref.gather(1, toks[:, None])[:, 0]
    return ref.max(dim=-1).values - picked
