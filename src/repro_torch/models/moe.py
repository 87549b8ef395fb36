"""Sort-based top-k MoE FFN (dropping implementation).

Port of ``repro/models/moe.py``. Tokens go to their top-k experts, are
sorted by expert id, packed into a fixed-capacity (E, C, D) buffer, run
through the stacked expert MLPs as batched products and combined back.
Tokens past an expert's capacity are dropped in stable expert-sorted order
(``capacity_factor`` sets the drop rate). ``C`` comes from the call's token
count on the host, so every shape is static: the step runs without host
syncs and can be captured in a CUDA graph.

Activations move by gathers only: buffer slot (e, c) takes the c-th token
of expert e's sorted run (zero past the run), which is what the
reference's dropping ``.at[se, rank].set`` writes; each token then adds its
k contributions in ascending expert order, the order in which the
reference's ``.at[st].add`` reaches them (sorted by expert, then token), in
the activation dtype. No float atomics: the result does not depend on the
run or the device's scheduling.

Port-only beside it, ``share_apply``: the expert-parallel share layer of a
``MoEConfig`` with ``scoring="sigmoid"`` (K-EXAONE). Its router scores all
``n_routed`` published experts; the layer holds ``num_experts`` of them,
from ``expert_lo``, and computes the part of the result they give, plus a
shared expert that every token runs. Nothing drops (see its docstring).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L


def _stacked(gen, n, shape, dtype, device, fan_in):
    """(n, *shape) normal weights scaled by 1/sqrt(fan_in), drawn one slab
    at a time (a stacked f32 draw of a full-width expert bank would not
    fit beside it). On the meta device, the empty stack."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    if out.is_meta:
        return out
    for e in range(n):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        out[e] = (w * (1.0 / math.sqrt(fan_in))).to(dtype)
    return out


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig, dtype,
             device) -> Dict[str, torch.Tensor]:
    """Router (d_model, E) in f32; experts stacked (E, D, F) / (E, F, D),
    each scaled by its own fan-in (d_model, or d_expert for ``w_down``).
    A share layer's router scores ``moe.routed`` experts, beside a zero
    f32 selection bias ``router_bias`` (routed,), and its ``shared``
    expert is an MLP of width ``d_shared``."""
    E, F = moe.num_experts, moe.d_expert
    router = torch.randn((d_model, moe.routed), generator=gen,
                         dtype=torch.float32,
                         device=device) * (1.0 / math.sqrt(d_model))
    p = {"router": router,
         "w_gate": _stacked(gen, E, (d_model, F), dtype, device, d_model),
         "w_up": _stacked(gen, E, (d_model, F), dtype, device, d_model),
         "w_down": _stacked(gen, E, (F, d_model), dtype, device, F)}
    if moe.share:
        p["router_bias"] = torch.zeros((moe.routed,), dtype=torch.float32,
                                       device=device)
    if moe.d_shared:
        p["shared"] = L.init_mlp(gen, d_model, moe.d_shared, dtype, device)
    return p


def expert_capacity(n_tokens: int, moe: MoEConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens (pad rows and
    idle decode slots included), a multiple of 8 and at least 8."""
    c = math.ceil(n_tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def moe_apply_grouped(p, x: torch.Tensor, moe: MoEConfig, act: str = "silu",
                      groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``groups`` independent dispatches over equal token groups (each
    with its own capacity); one global dispatch when ``groups`` <= 1 or
    does not divide T. Returns (y, mean of the groups' aux losses)."""
    T, D = x.shape
    if groups <= 1 or T % groups:
        return moe_apply(p, x, moe, act)
    ys, auxs = zip(*(moe_apply(p, xi, moe, act)
                     for xi in x.reshape(groups, T // groups, D)))
    return torch.cat(ys, 0), torch.stack(auxs).mean()


def moe_apply(p, x: torch.Tensor, moe: MoEConfig, act: str = "silu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (y (T, D) in x's dtype, aux loss f32 scalar)."""
    T, D = x.shape
    E, K = moe.num_experts, moe.top_k
    C = expert_capacity(T, moe)
    dev = x.device

    logits = x.float() @ p["router"]                        # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: ties go to the lower expert id (a stable descending sort)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- pack: token replicas sorted by expert id (stable) -----------------
    e_flat = top_e.reshape(-1)                              # (T*K,)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    st = torch.div(order, K, rounding_mode="floor")         # token of each
    experts = torch.arange(E, device=dev)
    starts = torch.searchsorted(se, experts, side="left")   # (E,)
    counts = torch.searchsorted(se, experts, side="right") - starts
    c = torch.arange(C, device=dev)
    src = (starts[:, None] + c).clamp(max=T * K - 1)        # (E, C)
    filled = (c < counts[:, None])[..., None]
    buf = torch.where(filled, x[st[src]], torch.zeros((), dtype=x.dtype,
                                                       device=dev))

    # ---- batched expert MLP ------------------------------------------------
    g = torch.bmm(buf, p["w_gate"])
    g = L.silu(g) if act == "silu" else L.gelu_tanh(g)
    out_buf = torch.bmm(g * torch.bmm(buf, p["w_up"]), p["w_down"])

    # ---- unpack + combine, per token in ascending expert order -------------
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=dev) - starts[se]
    rank = rank.view(T, K)                                  # slot of each pick
    asc = torch.argsort(top_e, dim=-1)                      # experts ascending
    e_asc = torch.gather(top_e, 1, asc)
    r_asc = torch.gather(rank, 1, asc)
    w_asc = torch.gather(top_p, 1, asc).to(x.dtype)
    picked = out_buf[e_asc, r_asc.clamp(max=C - 1)]         # (T, K, D)
    contrib = torch.where((r_asc < C)[..., None], picked,
                          torch.zeros((), dtype=x.dtype, device=dev)) \
        * w_asc[..., None]
    y = torch.zeros((T, D), dtype=x.dtype, device=dev)
    for k in range(K):
        y = y + contrib[:, k]

    # ---- load-balance auxiliary loss (Switch-style) ------------------------
    frac_tokens = (top_e[:, :1] == experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = moe.aux_loss_weight * E * (frac_tokens * frac_probs).sum()
    return y, aux


# ---------------------------------------------------------------------------
# the expert-parallel share layer (port-only)
# ---------------------------------------------------------------------------

def share_route(p, x: torch.Tensor, moe: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (experts (T, K) int64 over all ``moe.routed``, weights
    (T, K) f32): sigmoid scores of the f32 router, the top K of score plus
    ``router_bias`` (the bias only chooses; ties go to the lower id, as a
    stable sort gives), each chosen score over their sum, times
    ``routed_scale``."""
    score = torch.sigmoid(x.float() @ p["router"])           # (T, E) f32
    sel = score + p["router_bias"]
    top_e = torch.sort(sel, dim=-1, descending=True,
                       stable=True)[1][:, :moe.top_k]
    top_s = torch.gather(score, 1, top_e)
    return top_e, top_s / top_s.sum(dim=-1, keepdim=True) * moe.routed_scale


def _expert(p, e: int, x, act: str):
    return L.mlp_apply({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                        "w_down": p["w_down"][e]}, x, act)


def share_apply(p, x: torch.Tensor, moe: MoEConfig, act: str = "silu", *,
                step: bool = False, active=None, counts=None) -> torch.Tensor:
    """The share layer: x (T, D) -> y (T, D) in x's dtype,
    y = S(x) + sum over the token's chosen experts held here, [lo, lo + E),
    of weight * E_e(x), the sum in f32 (S the shared expert, if any).

    Admission (``step`` False) is dropless: each held expert runs exactly
    the rows routed to it, its weights added into an f32 sum in ascending
    expert order (a token meets an expert at most once, so no two adds hit
    one row at once). Sizing the groups reads the counts on the host.

    A decode step (``step`` True, captured) gives every held expert a fixed
    capacity of T rows, the whole batch: row t of expert e's buffer is token
    t where it chose e, else zero. A token chooses an expert at most once,
    so nothing can drop. ``counts``: an int64 (2,) device tensor that gains
    the rows routed to held experts (of the ``active`` rows) and the rows
    computed (E x T), in place."""
    T, D = x.shape
    E, lo = moe.num_experts, moe.expert_lo
    top_e, top_w = share_route(p, x, moe)
    if step:
        held = torch.zeros((T, moe.routed), dtype=torch.bool, device=x.device)
        held.scatter_(1, top_e, True)
        held = held[:, lo:lo + E]                              # (T, E)
        w = torch.zeros((T, moe.routed), dtype=torch.float32,
                        device=x.device).scatter_(1, top_e, top_w)
        buf = torch.where(held.T[..., None], x[None],
                          torch.zeros((), dtype=x.dtype, device=x.device))
        g = torch.bmm(buf, p["w_gate"])
        g = L.silu(g) if act == "silu" else L.gelu_tanh(g)
        out = torch.bmm(g * torch.bmm(buf, p["w_up"]), p["w_down"])
        y = (out.float() * w[:, lo:lo + E].T[..., None]).sum(dim=0)
        if counts is not None:
            routed = held if active is None else held & active[:, None]
            counts[0].add_(routed.sum())
            counts[1].add_(E * T)
    else:
        local = top_e - lo
        flat = torch.where((local >= 0) & (local < E), local,
                           torch.full_like(local, E)).reshape(-1)
        order = torch.argsort(flat, stable=True)
        n = torch.bincount(flat, minlength=E + 1)[:E]
        n = n.tolist()  # retrolint: sync(dropless expert group sizes)
        tok = torch.div(order, moe.top_k, rounding_mode="floor")
        wf = top_w.reshape(-1)
        y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
        off = 0
        for e in range(E):
            if n[e]:
                rows, picks = tok[off:off + n[e]], order[off:off + n[e]]
                y.index_add_(0, rows, _expert(p, e, x[rows], act).float()
                             * wf[picks][:, None])
            off += n[e]
    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x, act).float()
    return y.to(x.dtype)
