"""Plain PyTorch reference of RetroInfer's decode-time attention (the wave
index, arXiv:2505.02922 Sec. 4.2) at the budgets a configuration states,
teacher-forced over a whole sequence.

The prompt is attended exactly (the prefill). Its keys between the sink
and the local window are clustered once, per KV head, by segmented
spherical k-means: segments of ``prefill_segment`` tokens from the end of
the sink, then the tail; k = n // avg_cluster clusters a segment; keys
centred on the segment's mean; centroids initialised from every
(n // k)-th key and normalised before each of ``kmeans_iters`` assignment
steps (inner product, ties to the lower id). A cluster keeps the mean of
its raw keys (its centroid), the sum of its values, its size, and its
first ``cluster_cap`` members in position order (the rest overflow).

Each decoded position p then attends exactly to the sink, to the local
window and every token generated so far (positions from prompt - local to
p), and to the stored members of the r clusters with the largest centroid
score (the maximum over the KV head's query group); the next e clusters
enter as estimates, size * exp(score) with their value sum, as do the
overflow members of the r clusters. The rest are left out. r and e come
from the serving geometry's zone plan. A flush of the staging buffer
(every ``update_segment`` generated tokens past the local window) is not
modelled: a sequence that would need one is refused.

Nothing here imports the system under test."""
from __future__ import annotations

import math
from typing import Dict

import torch

NEG = -1e30


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


def kmeans(x: torch.Tensor, k: int, iters: int, centering: bool):
    """x (H, n, hd) f32 -> assignment (H, n) of spherical k-means."""
    H, n, _ = x.shape
    if centering:
        x = x - x.mean(dim=1, keepdim=True)
    init = torch.clamp(torch.arange(k, device=x.device) * max(1, n // k),
                       max=n - 1)
    cent = x[:, init]
    ids = torch.arange(k, device=x.device)
    for _ in range(iters):
        a = (x @ _normalize(cent).transpose(1, 2)).argmax(dim=-1)
        oh = (a[..., None] == ids).float()                       # (H, n, k)
        counts = oh.sum(dim=1)
        sums = oh.transpose(1, 2) @ x
        cent = torch.where(counts[..., None] > 0,
                           sums / torch.clamp(counts[..., None], min=1.0),
                           cent)
    return (x @ _normalize(cent).transpose(1, 2)).argmax(dim=-1)


def _clusters(keys, vals, pos0: int, k: int, wi: Dict):
    """One segment (H, n, hd) starting at position pos0 -> its clusters:
    centroid, vsum (H, k, hd), size (H, k), members (H, k, cap) positions
    (-1 padded)."""
    H, n, hd = keys.shape
    cap = wi["cluster_cap"]
    a = kmeans(keys, k, wi["kmeans_iters"], wi["centering"])
    oh = (a[..., None] == torch.arange(k, device=keys.device)).float()
    size = oh.sum(dim=1)
    centroid = (oh.transpose(1, 2) @ keys) / torch.clamp(size[..., None],
                                                         min=1.0)
    vsum = oh.transpose(1, 2) @ vals
    rank = (oh.cumsum(dim=1) * oh).sum(dim=-1).long() - 1          # (H, n)
    members = torch.full((H, k * cap + 1), -1, dtype=torch.long,
                         device=keys.device)
    slot = torch.where(rank < cap, a * cap + rank,
                       torch.full_like(rank, k * cap))
    members.scatter_(1, slot, pos0 + torch.arange(n, device=keys.device)
                     .expand(H, n))
    return centroid, vsum, size, members[:, :k * cap].view(H, k, cap)


def build_index(k_all, v_all, prompt_len: int, wi: Dict):
    """The prompt's clusters from its keys and values (T, Hkv, hd), f32."""
    sink, local, seg = wi["sink"], wi["local"], wi["prefill_segment"]
    t0, t1 = sink, max(sink, prompt_len - local)
    keys = k_all[t0:t1].transpose(0, 1)
    vals = v_all[t0:t1].transpose(0, 1)
    n = t1 - t0
    n_full = n // seg
    parts = []
    for s in range(n_full):
        parts.append(_clusters(keys[:, s * seg:(s + 1) * seg],
                               vals[:, s * seg:(s + 1) * seg], t0 + s * seg,
                               seg // wi["avg_cluster"], wi))
    tail = n - n_full * seg
    if tail > 0:
        parts.append(_clusters(keys[:, n_full * seg:], vals[:, n_full * seg:],
                               t0 + n_full * seg,
                               max(1, tail // wi["avg_cluster"]), wi))
    return [torch.cat(f, dim=1) for f in zip(*parts)]


def decode_attention(q, k_all, v_all, prompt_len: int, wi: Dict, r: int,
                     e: int, chunk: int = 128, fp8=None) -> torch.Tensor:
    """Tripartite attention of the decoded queries q (n, Hq, hd) at
    positions prompt_len .. prompt_len + n - 1, over k_all / v_all (T, Hkv,
    hd) -> (n, Hq * hd). ``fp8``: a rounding applied to the products'
    operands (the control)."""
    n, hq, hd = q.shape
    hkv = k_all.shape[1]
    g = hq // hkv
    if n - 1 + wi["local"] >= wi["local"] + wi["update_segment"]:
        raise ValueError("the sequence decodes past a staging-buffer flush")
    rnd = fp8 or (lambda t: t)
    centroid, vsum, size, members = build_index(k_all, v_all, prompt_len, wi)
    scale = 1.0 / math.sqrt(hd)
    live = size > 0                                              # (Hkv, M)
    cent = rnd(centroid)
    stored = torch.clamp(size, max=wi["cluster_cap"])
    over = size - stored
    l0 = max(prompt_len - wi["local"], wi["sink"])
    k_loc, v_loc = k_all[l0:], v_all[l0:]                    # local + decoded
    pos_loc = torch.arange(l0, k_all.shape[0], device=q.device)
    k_snk, v_snk = k_all[:wi["sink"]], v_all[:wi["sink"]]
    hidx = torch.arange(hkv, device=q.device)[None, :, None]
    out = torch.empty((n, hkv, g, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        qc = q[c0:c1].view(c1 - c0, hkv, g, hd)
        p = prompt_len + torch.arange(c0, c1, device=q.device)
        cs = torch.einsum("chgd,hmd->chgm", qc, cent) * scale
        cs = torch.where(live[None, :, None, :], cs, NEG)
        order = torch.sort(cs.amax(dim=2), dim=-1, descending=True,
                           stable=True)[1]
        idx_r, idx_e = order[..., :r], order[..., r:r + e]     # (c, Hkv, .)
        # exact zone: sink, local window and decoded tokens, retrieved members
        mem = members[hidx, idx_r].flatten(2)                  # (c, Hkv, R)
        ok_r = mem >= 0
        mem = mem.clamp(min=0)
        k_r, v_r = k_all[mem, hidx], v_all[mem, hidx]          # (c, Hkv, R, hd)
        s_r = torch.einsum("chgd,chrd->chgr", qc, rnd(k_r)) * scale
        s_r = torch.where(ok_r[:, :, None, :], s_r, NEG)
        s_s = torch.einsum("chgd,thd->chgt", qc, rnd(k_snk)) * scale
        s_l = torch.einsum("chgd,thd->chgt", qc, rnd(k_loc)) * scale
        s_l = torch.where((pos_loc[None, :] <= p[:, None])[:, None, None, :],
                          s_l, NEG)
        # estimation zone: the next e clusters, and the retrieved ones'
        # overflow
        cs_e = cs.gather(3, idx_e[:, :, None, :].expand(-1, -1, g, -1))
        cs_o = cs.gather(3, idx_r[:, :, None, :].expand(-1, -1, g, -1))
        sz_e, ov = size[hidx, idx_e], over[hidx, idx_r]
        lg_e = torch.where((sz_e > 0)[:, :, None, :],
                           cs_e + torch.log(sz_e.clamp(min=1.0))[:, :, None],
                           NEG)
        lg_o = torch.where((ov > 0)[:, :, None, :],
                           cs_o + torch.log(ov.clamp(min=1.0))[:, :, None],
                           NEG)
        vs_e = vsum[hidx, idx_e]
        vs_o = vsum[hidx, idx_r] * (ov / size[hidx, idx_r].clamp(min=1.0)
                                    )[..., None]
        m = torch.maximum(torch.cat([s_s, s_l, s_r], -1).amax(-1),
                          torch.cat([lg_e, lg_o], -1).amax(-1))  # (c, Hkv, G)
        w_s, w_l, w_r = (torch.exp(s - m[..., None]) for s in (s_s, s_l, s_r))
        den = w_s.sum(-1) + w_l.sum(-1) + w_r.sum(-1) \
            + torch.exp(lg_e - m[..., None]).where(lg_e > NEG / 2, 0).sum(-1) \
            + torch.exp(lg_o - m[..., None]).where(lg_o > NEG / 2, 0).sum(-1)
        num = torch.einsum("chgt,thd->chgd", rnd(w_s), rnd(v_snk)) \
            + torch.einsum("chgt,thd->chgd", rnd(w_l), rnd(v_loc)) \
            + torch.einsum("chgr,chrd->chgd", rnd(w_r), rnd(v_r))
        w_e = torch.exp(cs_e - m[..., None]).where(lg_e > NEG / 2, 0)
        w_o = torch.exp(cs_o - m[..., None]).where(lg_o > NEG / 2, 0)
        num = num + torch.einsum("chge,ched->chgd", w_e, vs_e) \
            + torch.einsum("chge,ched->chgd", w_o, vs_o)
        out[c0:c1] = num / den.clamp(min=1e-30)[..., None]
    return out.view(n, hq * hd)
