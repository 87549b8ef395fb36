"""Plain PyTorch twins of the wave-attention kernels.

Port of ``repro/kernels/wave_attention/ref.py``:

* ``wave_attention_ref`` twins the gathered-buffer kernel: the reference
  merge over a contiguous execution buffer, in f32 on upcast operands;
* ``paged_wave_attention_torch`` twins the paged kernel: same arguments,
  same fold order (sink -> local buffer -> one retrieved cluster at a time
  -> estimation finalize) and the same masking constants;
* ``paged_walk``, ``attention_partial``, ``estimation_partial`` and
  ``combine_partials`` spell out the kernels' split-and-combine algebra
  (``csrc/wave_fold.cuh``) for the tests.

The wrappers in ``ops.py`` run them for CPU tensors; ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def wave_attention_ref(q, k, v, valid, est_logit, cs, vs, *, softcap=None):
    """Flat-batch twin of the gathered-buffer kernel. q: (BH, G, hd); k/v:
    (BH, T, hd) in any float dtype; valid: (BH, T); est_logit/cs: (BH, G,
    E); vs: (BH, E, hd) -> (BH, G, hd) f32. Computes wholly in f32 on the
    upcast operands, as the reference wrapper hands them to its kernel."""
    from repro_torch.core.attention import tripartite_merge_jnp
    f32 = torch.float32
    add = lambda a: a[:, None].to(f32)              # (BH, ...) -> (BH, 1, ...)
    out = tripartite_merge_jnp(add(q), add(k), add(v), (valid > 0)[:, None],
                               add(est_logit), add(cs), add(vs),
                               softcap=softcap)
    return out[:, 0]


def _fold(carry, q, k, v, ok, scale, softcap):
    """Online-softmax accumulate of one (BH, T, hd) tile whose valid tokens
    are ``ok`` (BH, T), in f32: the kernels' fold, masking constants and
    all."""
    m, l, acc = carry                               # (BH,G) (BH,G) (BH,G,hd)
    f32 = torch.float32
    s = torch.einsum("bgd,btd->bgt", q, k.to(f32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(ok[:, None, :], s, torch.full_like(s, NEG))
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.clamp(m_new, min=-1e20)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                       torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(ok[:, None, :], p, torch.zeros_like(p))
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bgt,btd->bgd", p, v.to(f32))
    return m_new, l, acc


def _empty_carry(BH, G, hd, device):
    f32 = torch.float32
    return (torch.full((BH, G), -math.inf, dtype=f32, device=device),
            torch.zeros((BH, G), dtype=f32, device=device),
            torch.zeros((BH, G, hd), dtype=f32, device=device))


def _in_window(pos, rowb):
    pos = pos.long()
    lo = rowb[:, 0:1].long()                        # (BH, 1) excl lower bound
    hi = rowb[:, 1:2].long()                        # (BH, 1) incl upper bound
    return (pos >= 0) & (pos <= hi) & (pos > lo)


def paged_wave_attention_torch(idx, rowb, live, q, sink_k, sink_v,
                               local_k, local_v, local_pos,
                               k_store, v_store, pos_store,
                               est_logit, cs, vs, *, sink_len: int,
                               softcap=None):
    """Flat-batch zone walk. idx/live: (BH, r) int; rowb: (BH, 2) int
    [lo (exclusive), hi (inclusive)]; q: (BH, G, hd); sink_k/v: (BH, Ss, hd);
    local_k/v: (BH, Lb, hd) with local_pos (BH, Lb); k/v_store:
    (BH, M, cap, hd) with pos_store (BH, M, cap); est_logit/cs: (BH, G, E);
    vs: (BH, E, hd). Returns (BH, G, hd) f32."""
    BH, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    q = q.to(f32)
    dev = q.device
    carry = _empty_carry(BH, G, hd, dev)

    def fold(carry, k, v, pos, extra_ok=None):
        ok = _in_window(pos, rowb)
        if extra_ok is not None:
            ok = ok & extra_ok
        return _fold(carry, q, k, v, ok, scale, softcap)

    sink_pos = torch.arange(sink_len, device=dev)[None, :].expand(BH, sink_len)
    carry = fold(carry, sink_k[:, :sink_len], sink_v[:, :sink_len], sink_pos)
    carry = fold(carry, local_k, local_v, local_pos)

    rows = torch.arange(BH, device=dev)
    for j in range(idx.shape[1]):
        c = idx[:, j].long()
        carry = fold(carry, k_store[rows, c], v_store[rows, c],
                     pos_store[rows, c], extra_ok=(live[:, j] > 0)[:, None])

    m, l, acc = carry
    est_logit, cs, vs = est_logit.to(f32), cs.to(f32), vs.to(f32)
    m_fin = torch.clamp(torch.maximum(m, est_logit.amax(dim=-1)), min=-1e20)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_fin),
                       torch.zeros_like(m))
    est_live = est_logit > NEG / 2
    zero = torch.zeros_like(est_logit)
    w_den = torch.where(est_live, torch.exp(est_logit - m_fin[..., None]), zero)
    w_num = torch.where(est_live, torch.exp(cs - m_fin[..., None]), zero)
    den = l * corr + w_den.sum(dim=-1)
    num = acc * corr[..., None] + torch.einsum("bge,bed->bgd", w_num, vs)
    return num / torch.clamp(den, min=1e-30)[..., None]


# --- the split kernels' algebra (csrc/wave_fold.cuh), for the tests -------

def paged_walk(idx, rowb, live, sink_k, sink_v, local_k, local_v, local_pos,
               k_store, v_store, pos_store, *, sink_len: int, tile=None):
    """The paged kernel's walk as one token sequence, in its order (sink,
    local buffer, then each retrieved cluster's block): (k, v, ok) of
    shapes (BH, N, hd) x 2 and (BH, N). ``tile``: each zone padded with
    masked tokens to whole tiles of that many tokens, as the kernel cuts
    it."""
    BH = idx.shape[0]
    dev = idx.device
    rows = torch.arange(BH, device=dev)
    sink_pos = torch.arange(sink_len, device=dev)[None, :].expand(BH, sink_len)
    zones = [(sink_k[:, :sink_len], sink_v[:, :sink_len],
              _in_window(sink_pos, rowb)),
             (local_k, local_v, _in_window(local_pos, rowb))]
    for j in range(idx.shape[1]):
        c = idx[:, j].long()
        zones.append((k_store[rows, c], v_store[rows, c],
                      _in_window(pos_store[rows, c], rowb)
                      & (live[:, j] > 0)[:, None]))
    if tile is not None:
        pad = lambda a, n: torch.cat(
            [a, a.new_zeros((BH, n) + a.shape[2:])], 1)
        zones = [tuple(pad(a, -a.shape[1] % tile) for a in z) for z in zones]
    return tuple(torch.cat(a, 1) for a in zip(*zones))


def attention_partial(q, k, v, ok, *, softcap=None):
    """The partial (m, l, acc) a split writes for tokens k/v (BH, T, hd)
    with valid mask ok (BH, T): the fold from an empty carry. m is the m_safe
    that l and acc are relative to, -inf where no token was valid."""
    BH, G, hd = q.shape
    q = q.to(torch.float32)
    if k.shape[1] == 0:
        return _empty_carry(BH, G, hd, q.device)
    m, l, acc = _fold(_empty_carry(BH, G, hd, q.device), q, k, v, ok,
                      1.0 / math.sqrt(hd), softcap)
    any_ok = ok.any(dim=-1)[:, None]
    m = torch.where(any_ok, torch.clamp(m, min=-1e20),
                    torch.full_like(m, -math.inf))
    return m, l, acc


def estimation_partial(est_logit, cs, vs):
    """The partial (m_e, den_e, num_e) a split writes for a chunk of the
    estimation zone: est_logit/cs (BH, G, e), vs (BH, e, hd)."""
    f32 = torch.float32
    est_logit, cs, vs = est_logit.to(f32), cs.to(f32), vs.to(f32)
    m = est_logit.amax(dim=-1)
    live = est_logit > NEG / 2
    zero = torch.zeros_like(est_logit)
    den = torch.where(live, torch.exp(est_logit - m[..., None]), zero).sum(-1)
    w = torch.where(live, torch.exp(cs - m[..., None]), zero)
    return m, den, torch.einsum("bge,bed->bgd", w, vs)


def combine_partials(parts):
    """The combine kernel's log-sum-exp over split partials [(m, l, acc)]
    (m, l: (BH, G); acc: (BH, G, hd)), in list order:
    out = sum w acc / max(sum w l, 1e-30), w = exp(m_s - m) (0 where m_s is
    -inf), m = max(-1e20, all m_s)."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0).clamp(min=-1e20)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for ms, ls, accs in parts:
        w = torch.where(ms == -math.inf, torch.zeros_like(ms),
                        torch.exp(ms - m))
        num = num + w[..., None] * accs
        den = den + w * ls
    return num / torch.clamp(den, min=1e-30)[..., None]


def random_decode_inputs(*, B=2, H=4, G=2, hd=256, M=1280, cap=32, sink=4,
                         lbuf=1088, r=18, e=238, q_pos=(16500, 13000),
                         local_len=(100, 1088), window=None, dtype="bfloat16",
                         live_frac=1.0, r0=False, overflow=True, seed=0,
                         device="cpu"):
    """Random kernel inputs in the wrapper's (B, H, ...) layout, for holding
    the kernel against the twin. Defaults are gemma2-2b's decode shapes at a
    16384-token context with the default RetroConfig. K/V are in the storage
    ``dtype``; cluster positions spread over [sink, q_pos + 64) so some lie
    in the future or outside the window; local buffers are ragged; about a
    tenth of the estimation entries are dead (NEG). ``r0``: one dead
    retrieval slot (steady-zone-only plan); ``overflow``: the estimation
    zone carries the r overflow entries."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    i32 = torch.int32

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    qp = torch.tensor(q_pos, dtype=i32, device=device)[:B]
    ll = torch.tensor(local_len, dtype=i32, device=device)[:B]
    slot = torch.arange(lbuf, dtype=i32, device=device)
    local_pos = torch.where(slot[None] < ll[:, None],
                            (qp - ll + 1)[:, None] + slot[None],
                            torch.full_like(slot[None], -1))
    pos_store = (rand(B, H, M, cap) * (qp + 64 - sink).float()
                 [:, None, None, None]).to(i32) + sink
    pos_store = torch.where(rand(B, H, M, cap) < 0.3,
                            torch.full_like(pos_store, -1), pos_store)
    lo = torch.full_like(qp, -1) if window is None else torch.clamp(
        torch.floor(qp.float() - window).to(i32), min=-1)
    rowb = torch.stack([lo, qp], -1)[:, None, :].expand(B, H, 2).contiguous()
    if r0:
        r = 1
        live = torch.zeros((B, H, 1), dtype=i32, device=device)
    else:
        live = (rand(B, H, r) < live_frac).to(i32)
    idx = torch.stack([torch.randperm(M, generator=g, device=device)[:r]
                       for _ in range(B * H)]).reshape(B, H, r).to(i32)
    E = max(1, e + (r if overflow and not r0 else 0))
    est_logit = 3 * randn(B, H, G, E)
    dead = rand(B, H, G, E) < 0.1
    if e == 0 and not overflow:
        dead[:] = True
    est_logit = torch.where(dead, torch.full_like(est_logit, NEG), est_logit)
    return [randn(B, H, G, hd),
            randn(B, H, sink, hd).to(dt), randn(B, H, sink, hd).to(dt),
            randn(B, H, lbuf, hd).to(dt), randn(B, H, lbuf, hd).to(dt),
            local_pos[:, None, :].expand(B, H, lbuf).contiguous(),
            randn(B, H, M, cap, hd).to(dt), randn(B, H, M, cap, hd).to(dt),
            pos_store, idx, live, rowb,
            est_logit, 3 * randn(B, H, G, E), 20 * randn(B, H, E, hd)]


def random_merge_inputs(*, B=2, H=4, G=2, hd=256, T=1668, E=256,
                        dtype="bfloat16", keep_min=0.2, dead_frac=0.1,
                        seed=0, device="cpu"):
    """Random gathered-buffer merge inputs in the wrapper's (B, H, ...)
    layout. Defaults are gemma2-2b's decode shapes at a 16384-token context
    with the default RetroConfig: T = sink 4 + local buffer 1088 + r 18 x
    cap 32, E = e 238 + r 18. K/V are in the storage ``dtype``. The mask is
    ragged: each row keeps its own random share of the tokens, at least
    ``keep_min`` (0 allows empty rows). ``dead_frac`` of the estimation
    entries are NEG (1.0: all of them)."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    keep = keep_min + (1 - keep_min) * rand(B, H, 1)
    valid = rand(B, H, T) < keep
    est_logit = 3 * randn(B, H, G, E)
    cs = est_logit - randn(B, H, G, E).abs()
    est_logit = torch.where(rand(B, H, G, E) < dead_frac,
                            torch.full_like(est_logit, NEG), est_logit)
    return [randn(B, H, G, hd), randn(B, H, T, hd).to(dt),
            randn(B, H, T, hd).to(dt), valid, est_logit, cs,
            3 * randn(B, H, E, hd)]
