"""Plain PyTorch reference of Mistral-7B and Mixtral (the published
``MistralForCausalLM`` / ``MixtralForCausalLM`` forward), for the
benchmark's check of served tokens.

It reads the published sizes from a configuration file's top-level keys
and the weights as the benchmark made them, in the serving layout of the
system under test (a dict: ``embed`` (V, D), ``layers[i]`` with ``ln1``,
``ln2``, ``attn.{wq, wk, wv, wo}`` as (in, out) matrices, ``mlp.{w_gate,
w_up, w_down}`` or ``moe.{router (D, E), w_gate (E, D, F), w_up, w_down
(E, F, D)}``, ``final_norm``, ``lm_head`` (D, V)). It imports nothing of
that system and computes everything from the weights and tokens itself.

What it computes: exact causal attention over every position (no index,
no cache), rotary embedding by halves with ``rope_theta``, grouped-query
attention (query head h reads KV head h // (Hq / Hkv)), RMSNorm, the
SiLU-gated MLP, and for Mixtral the softmax router with its top-k experts
renormalised, without dropping any token. Two conventions of the served
weight layout, both exact re-parametrisations of the published model: a
norm's stored weight w scales by (1 + w), and the token embedding is
multiplied by sqrt(hidden_size) (the published model's table is the
stored one times that factor).

``precision="f32"`` computes every product in float32 with TF32 off: the
reference. ``precision="fp8"`` is the control: every matrix product takes
both operands rounded to float8 e4m3 and accumulates in float32 — the
linear layers (projections, MLP, experts, router, head: each row of
activations and each output column of weights scaled by its own absolute
maximum) and attention (q, k and v by row of each head, the
probabilities by query row); norms, rotary embedding and softmax stay in
float32. Layers run one at a time, their
weights widened to float32 only while used, and attention runs in blocks
of queries, so that a 17k-token sequence fits beside the served weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from perfbench.reference import wave_index

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (absolute maximum mapped to the format's largest value)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (T, in) f32 @ w (in, out) in the reference's precision."""
    w = w.float()
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + w.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, hd): rotary embedding by halves at positions pos (T,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = (pos.double()[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block: int, fp8: bool) -> torch.Tensor:
    """Exact causal attention. q (T, Hq, hd), k and v (T', Hkv, hd), T <=
    T' (the first T positions are the queries) -> (T, Hq * hd), by blocks
    of ``block`` queries. With ``fp8`` the probabilities (each query's row)
    are rounded to e4m3 before their product."""
    T, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kt = k.permute(1, 2, 0)                                   # (Hkv, hd, T)
    vt = v.permute(1, 0, 2)                                   # (Hkv, T, hd)
    out = torch.empty((T, hq, hd), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    for i0 in range(0, T, block):
        i1 = min(T, i0 + block)
        qb = q[i0:i1].reshape(i1 - i0, hkv, g, hd).permute(1, 2, 0, 3)
        s = torch.matmul(qb.reshape(hkv, g * (i1 - i0), hd), kt[:, :, :i1])
        s = s.view(hkv, g, i1 - i0, i1) * scale
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(i1, device=q.device)[None, :]
        s.masked_fill_(kpos > qpos, -math.inf)
        p = torch.softmax(s, dim=-1)
        if fp8:
            p = _fp8(p, -1)
        o = torch.matmul(p.view(hkv, g * (i1 - i0), i1), vt[:, :i1])
        out[i0:i1] = o.view(hkv, g, i1 - i0, hd).permute(2, 0, 1, 3) \
            .reshape(i1 - i0, hq, hd)
    return out.reshape(T, hq * hd)


def _mix(q, k, v, block, precision, retro, config):
    """Each position's attention: exact, or from ``retro["prompt_len"]`` on
    through the wave index."""
    fp8 = precision == "fp8"
    if retro is None:
        return _attention(q, k, v, block, fp8)
    L = retro["prompt_len"]
    pre = _attention(q[:L], k[:L], v[:L], block, fp8)
    if q.shape[0] == L:
        return pre
    dec = wave_index.decode_attention(
        q[L:], k, v, L, config["wave_index"], retro["r"], retro["e"],
        fp8=(lambda t: _fp8(t, -1)) if fp8 else None)
    return torch.cat([pre, dec])


def _mlp(p, x, precision):
    g = _linear(x, p["w_gate"], precision)
    u = _linear(x, p["w_up"], precision)
    return _linear(torch.nn.functional.silu(g) * u, p["w_down"], precision)


def _moe(p, x, top_k: int, precision, margins=None):
    """Softmax router over all experts, top-k renormalised, every token to
    its k experts (no capacity, nothing dropped). ``margins``: a list that
    receives each token's router margin, its k-th largest router logit less
    its (k+1)-th."""
    logit = _linear(x, p["router"], precision)
    if margins is not None:
        top = torch.topk(logit, top_k + 1, dim=-1).values
        margins.append(top[:, top_k - 1] - top[:, top_k])
    probs = torch.softmax(logit, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(p["w_gate"].shape[0]):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ex = {"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
              "w_down": p["w_down"][e]}
        y.index_add_(0, tok, _mlp(ex, x[tok], precision)
                     * top_p[tok, slot][:, None])
    return y


@torch.inference_mode()
def logits(weights: Dict, config: Dict, tokens: torch.Tensor, first: int,
           precision: str = "f32", block: int = 1024,
           retro: Optional[Dict] = None,
           out: Optional[Dict] = None) -> torch.Tensor:
    """Next-token logits (T - first, V) in float32 at positions first ..
    T - 1 of the 1-D token sequence ``tokens``. ``retro``: ``{"prompt_len",
    "r", "e"}``: the positions from ``prompt_len`` on are decoded through
    the wave index (``wave_index.decode_attention``, with the
    configuration's ``wave_index`` budgets); None: every position attends
    exactly. ``out``: a dict that receives ``router_margin`` (T - first,):
    each position's smallest router margin over the MoE layers (see
    ``_moe``), where a rounding can change the experts a token goes to."""
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
    hd = config.get("head_dim") or d // hq
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    if config.get("sliding_window") is not None:
        raise ValueError("the reference computes global attention only")
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    margins = [] if out is not None else None
    x = weights["embed"][tokens.long()].float() * math.sqrt(d)
    for lp in weights["layers"]:
        a = lp["attn"]
        h = _rms_norm(x, lp["ln1"], eps)
        q = _rope(_linear(h, a["wq"], precision).view(T, hq, hd), pos, theta)
        k = _rope(_linear(h, a["wk"], precision).view(T, hkv, hd), pos, theta)
        v = _linear(h, a["wv"], precision).view(T, hkv, hd)
        if precision == "fp8":
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
        x = x + _linear(_mix(q, k, v, block, precision, retro, config),
                        a["wo"], precision)
        del q, k, v, h
        h = _rms_norm(x, lp["ln2"], eps)
        if "moe" in lp:
            x = x + _moe(lp["moe"], h, config["num_experts_per_tok"],
                         precision, margins)
        else:
            x = x + _mlp(lp["mlp"], h, precision)
        del h
    x = _rms_norm(x[first:], weights["final_norm"], eps)
    head = weights["embed"].T if config.get("tie_word_embeddings") \
        else weights["lm_head"]
    if out is not None:
        out["router_margin"] = torch.stack(margins).amin(0)[first:] \
            if margins else torch.full((T - first,), math.inf,
                                       device=x.device)
    return _linear(x, head, precision)


def served_gaps(weights: Dict, config: Dict, prompt: torch.Tensor,
                served: List[int], precision: str = "f32",
                judge: Optional[torch.Tensor] = None,
                retro: Optional[Dict] = None,
                out: Optional[Dict] = None) -> torch.Tensor:
    """Per served token, how far its logit lies below the best logit at
    its position, all under the float32 reference. With ``precision``
    "fp8" (the control), the tokens judged are the ones the fp8 reference
    puts first at each position of the same sequence, not ``served``.
    ``judge``: optional precomputed f32 logits to judge against.
    ``retro``: as for ``logits`` (its ``prompt_len`` is the prompt's).
    ``out``: as for ``logits``, from the float32 reference."""
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
