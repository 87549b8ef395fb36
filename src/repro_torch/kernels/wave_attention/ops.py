"""Wrappers around the wave-attention kernels.

Port of ``repro/kernels/wave_attention/ops.py``: ``wave_attention_merge``
(the gathered-buffer kernel, ``csrc/wave_attention.cu``) and
``paged_wave_attention`` (the paged kernel, ``csrc/paged_wave_attention.cu``).
Each keeps the reference's public (B, Hkv, ...) layout, flattens (B, Hkv)
into BH as views (K/V are never converted or copied), and then:

* CPU tensors go to the plain twin in ``ref.py``;
* CUDA tensors go to the CUDA kernel (built at first use, loaded with
  ctypes) — it launches or raises.

A kernel call is two launches from one C entry point: a split kernel over
(rows, splits) that writes one partial per split into a workspace, then a
combine kernel (``csrc/wave_fold.cuh``). ``split_plan`` sizes the splits from
the shapes. ``<wrapper>.launches`` counts kernel calls (never twin runs).
``<wrapper>_plain`` runs the twin on any device with the same arguments
(the kernel's yardstick on the card).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wave_attention.ref import (paged_wave_attention_torch,
                                                   wave_attention_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_wave_attention.cu"
MERGE_SOURCE = Path(__file__).resolve().parent / "csrc" / "wave_attention.cu"
STORE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the wrapper's positional arguments, in order
ARG_NAMES = ("qg", "sink_k", "sink_v", "local_k", "local_v", "local_pos",
             "k_store", "v_store", "pos_store", "idx_r", "live", "rowb",
             "est_logit", "cs_e", "vs_e")
# the flat (BH, ...) order of the twin and of the C entry point
_FLAT_ORDER = ("idx_r", "rowb", "live", "qg", "sink_k", "sink_v", "local_k",
               "local_v", "local_pos", "k_store", "v_store", "pos_store",
               "est_logit", "cs_e", "vs_e")

# the split plan (csrc/wave_fold.cuh: TILE, MAX_TPS)
TILE = 32                      # tokens (estimation entries) per tile
MAX_TPS = 8                    # tiles per split, at most
MAX_G = 8                      # query heads per KV head, at most
TARGET_BLOCKS = 4 * 132        # four blocks for each of the H100's SMs


def _cdiv(a, b):
    return -(-a // b)


def split_plan(rows, n_tiles, e_tiles):
    """(tiles per split, splits per row) for ``rows`` rows whose walk has
    ``n_tiles`` tiles and whose estimation zone has ``e_tiles``: one tile per
    split until the grid passes ``TARGET_BLOCKS`` blocks, then more tiles
    per split (at most ``MAX_TPS``). Attention splits come first."""
    tps = min(MAX_TPS, max(1, _cdiv(rows * (n_tiles + e_tiles),
                                    TARGET_BLOCKS)))
    return tps, _cdiv(n_tiles, tps) + _cdiv(e_tiles, tps)


def paged_grid(*args):
    """The split grid of a ``paged_wave_attention`` call on ``args``."""
    B, H = args[0].shape[:2]
    S, Lb = args[ARG_NAMES.index("sink_k")].shape[2], \
        args[ARG_NAMES.index("local_k")].shape[2]
    cap = args[ARG_NAMES.index("k_store")].shape[3]
    r, E = args[ARG_NAMES.index("idx_r")].shape[2], \
        args[ARG_NAMES.index("vs_e")].shape[2]
    n_tiles = _cdiv(S, TILE) + _cdiv(Lb, TILE) + r * _cdiv(cap, TILE)
    return _grid(B * H, n_tiles, _cdiv(E, TILE))


def merge_grid(qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e):
    """The split grid of a ``wave_attention_merge`` call."""
    B, H = qg.shape[:2]
    return _grid(B * H, _cdiv(k_exec.shape[2], TILE),
                 _cdiv(vs_e.shape[2], TILE))


def _grid(rows, n_tiles, e_tiles):
    tps, splits = split_plan(rows, n_tiles, e_tiles)
    return dict(rows=rows, splits=splits, tiles_per_split=tps)


def _workspace(grid, G, hd, device):
    """The split partials' f32 workspace: acc (rows, S, G, hd), m and l
    (rows, S, G); every split writes its own, so it is never cleared."""
    n = grid["rows"] * grid["splits"] * G * (hd + 2)
    return torch.empty((n,), dtype=torch.float32, device=device)


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_ENTRY_POINTS = {
    # store_dtype; 16 pointers (idx .. out); ws, ws_floats; BH, G, hd, Ss,
    # sink_len, Lb, M, cap, r, E, tps; scale, softcap, use_softcap; stream
    "paged_wave_attention": (SOURCE, [_I] + [_P] * 16 + [_P, _L] + [_I] * 11
                             + [_F, _F, _I, _P]),
    # store_dtype; 8 pointers (q .. out); ws, ws_floats; BH, G, hd, T, E,
    # tps; scale, softcap, use_softcap; stream
    "wave_attention_merge": (MERGE_SOURCE, [_I] + [_P] * 8 + [_P, _L]
                             + [_I] * 6 + [_F, _F, _I, _P]),
}
_BOUND = {}


def _entry(name):
    """The C entry point ``name``, its library built and loaded and its
    ctypes signature set on first use."""
    fn = _BOUND.get(name)
    if fn is None:
        source, argtypes = _ENTRY_POINTS[name]
        fn = getattr(build.load(source), name)
        fn.restype = _I
        fn.argtypes = argtypes
        _BOUND[name] = fn
    return fn


def _check_merge(qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e):
    """Raise on device, shape or dtype the merge does not take."""
    B, H, G, hd = qg.shape
    T, E = k_exec.shape[2], vs_e.shape[2]
    spec = dict(qg=(qg, (B, H, G, hd)), k_exec=(k_exec, (B, H, T, hd)),
                v_exec=(v_exec, (B, H, T, hd)), valid=(valid, (B, H, T)),
                est_logit=(est_logit, (B, H, G, E)), cs_e=(cs_e, (B, H, G, E)),
                vs_e=(vs_e, (B, H, E, hd)))
    for name, (t, shape) in spec.items():
        if t.device != qg.device:
            raise ValueError(f"{name} is on {t.device}, expected {qg.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if k_exec.dtype not in STORE_DTYPES or v_exec.dtype != k_exec.dtype:
        raise TypeError(f"k/v_exec dtypes {k_exec.dtype}/{v_exec.dtype}: "
                        f"expected one of {tuple(STORE_DTYPES)} for both")


def wave_attention_merge_plain(qg, k_exec, v_exec, valid, est_logit, cs_e,
                               vs_e, *, softcap=None):
    """The plain twin on the wrapper's arguments, on any device."""
    _check_merge(qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e)
    B, H, G, hd = qg.shape
    flat = lambda a: a.reshape((B * H,) + a.shape[2:])
    out = wave_attention_ref(flat(qg), flat(k_exec), flat(v_exec),
                             flat(valid), flat(est_logit), flat(cs_e),
                             flat(vs_e), softcap=softcap)
    return out.view(B, H, G, hd)


def wave_attention_merge(qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e, *,
                         softcap=None):
    """Same contract as ``core.attention.tripartite_merge_jnp``: qg
    (B,H,G,hd), k/v_exec (B,H,T,hd) bf16 or f32, valid (B,H,T) bool,
    est_logit/cs_e (B,H,G,E), vs_e (B,H,E,hd) -> (B,H,G,hd) f32, computed in
    f32 on the upcast operands. The kernel reads K/V in their storage dtype
    and converts in registers, so the f32 upcast of the reference wrapper is
    never materialised; its TPU padding (T to ``block_t``, E and hd to 128
    lanes) has no counterpart: the kernel masks its own ragged tiles."""
    args = (qg, k_exec, v_exec, valid, est_logit, cs_e, vs_e)
    dev = qg.device
    if dev.type == "cpu":
        return wave_attention_merge_plain(*args, softcap=softcap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_merge(*args)
    B, H, G, hd = qg.shape
    T, E = k_exec.shape[2], vs_e.shape[2]
    if not 1 <= G <= MAX_G:
        raise ValueError(f"kernel takes G in 1..{MAX_G}, got {G}")
    if hd > 256 or hd % 8 or (hd // 8) & (hd // 8 - 1):
        raise ValueError(f"kernel takes hd = 8 * 2^k <= 256, got {hd}")
    for name, t in (("k_exec", k_exec), ("v_exec", v_exec)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    f32 = torch.float32
    q = qg.to(f32).contiguous()
    ok = valid.bool().contiguous()
    el, cs, vs = (a.to(f32).contiguous() for a in (est_logit, cs_e, vs_e))
    if vs.data_ptr() % 16:
        raise ValueError("vs_e must be 16-byte aligned")
    out = torch.empty((B * H, G, hd), dtype=f32, device=dev)
    grid = merge_grid(*args)
    ws = _workspace(grid, G, hd, dev)
    use_cap = softcap is not None and softcap > 0
    err = _entry("wave_attention_merge")(
        STORE_DTYPES[k_exec.dtype], q.data_ptr(), k_exec.data_ptr(),
        v_exec.data_ptr(), ok.data_ptr(), el.data_ptr(), cs.data_ptr(),
        vs.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), B * H, G,
        hd, T, E, grid["tiles_per_split"], 1.0 / math.sqrt(hd),
        float(softcap) if use_cap else 0.0, int(use_cap),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wave_attention_merge kernel launch failed: "
                           f"cudaError {err}")
    wave_attention_merge.launches += 1
    return out.view(B, H, G, hd)


wave_attention_merge.launches = 0


def _flatten(args):
    """Check the (B, H, ...) arguments and return them as (BH, ...) views in
    the flat order, keyed by name. Raises on device, dtype, shape or
    contiguity the kernel does not take."""
    a = dict(zip(ARG_NAMES, args))
    B, H, G, hd = a["qg"].shape
    dev = a["qg"].device
    S, Lb = a["sink_k"].shape[2], a["local_k"].shape[2]
    M, cap = a["k_store"].shape[2], a["k_store"].shape[3]
    r, E = a["idx_r"].shape[2], a["vs_e"].shape[2]
    kv = a["k_store"].dtype
    if kv not in STORE_DTYPES:
        raise TypeError(f"k_store dtype {kv} not in {tuple(STORE_DTYPES)}")
    f32, i32 = torch.float32, torch.int32
    spec = dict(qg=((B, H, G, hd), f32), sink_k=((B, H, S, hd), kv),
                sink_v=((B, H, S, hd), kv), local_k=((B, H, Lb, hd), kv),
                local_v=((B, H, Lb, hd), kv), local_pos=((B, H, Lb), i32),
                k_store=((B, H, M, cap, hd), kv),
                v_store=((B, H, M, cap, hd), kv),
                pos_store=((B, H, M, cap), i32), idx_r=((B, H, r), i32),
                live=((B, H, r), i32), rowb=((B, H, 2), i32),
                est_logit=((B, H, G, E), f32), cs_e=((B, H, G, E), f32),
                vs_e=((B, H, E, hd), f32))
    for name, (shape, dtype) in spec.items():
        t = a[name]
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return {n: a[n].view((B * H,) + a[n].shape[2:]) for n in _FLAT_ORDER}


def paged_wave_attention_plain(*args, softcap=None):
    """The plain twin on the wrapper's arguments, on any device."""
    flat = _flatten(args)
    qg = args[0]
    out = paged_wave_attention_torch(*flat.values(),
                                     sink_len=flat["sink_k"].shape[1],
                                     softcap=softcap)
    return out.view(qg.shape)


def paged_wave_attention(qg, sink_k, sink_v, local_k, local_v, local_pos,
                         k_store, v_store, pos_store, idx_r, live, rowb,
                         est_logit, cs_e, vs_e, *, softcap=None):
    """Gather-free fused decode merge over the raw wave-index zones.

    qg: (B, H, G, hd) f32; sink_k/v: (B, H, S, hd); local_k/v: (B, H, Lb, hd)
    with local_pos (B, H, Lb) int32 (-1 = empty slot); k/v_store:
    (B, H, M, cap, hd) with pos_store (B, H, M, cap) int32 — K/V zones in
    one storage dtype (bf16 or f32), read in place; idx_r/live: (B, H, r)
    int32; rowb: (B, H, 2) int32 [lo (exclusive), q_pos (inclusive)];
    est_logit/cs_e: (B, H, G, E) f32; vs_e: (B, H, E, hd) f32.
    Returns (B, H, G, hd) f32.
    """
    args = (qg, sink_k, sink_v, local_k, local_v, local_pos, k_store,
            v_store, pos_store, idx_r, live, rowb, est_logit, cs_e, vs_e)
    dev = qg.device
    if dev.type == "cpu":
        return paged_wave_attention_plain(*args, softcap=softcap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    flat = _flatten(args)
    B, H, G, hd = qg.shape
    if not 1 <= G <= MAX_G:
        raise ValueError(f"kernel takes G in 1..{MAX_G}, got {G}")
    if hd > 256 or hd % 8 or (hd // 8) & (hd // 8 - 1):
        raise ValueError(f"kernel takes hd = 8 * 2^k <= 256, got {hd}")
    for name in ("sink_k", "sink_v", "local_k", "local_v", "k_store",
                 "v_store", "vs_e"):
        if flat[name].data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty((B * H, G, hd), dtype=torch.float32, device=dev)
    S, Lb = flat["sink_k"].shape[1], flat["local_k"].shape[1]
    M, cap = flat["k_store"].shape[1:3]
    r, E = flat["idx_r"].shape[1], flat["vs_e"].shape[1]
    grid = paged_grid(*args)
    ws = _workspace(grid, G, hd, dev)
    use_cap = softcap is not None and softcap > 0
    err = _entry("paged_wave_attention")(
        STORE_DTYPES[k_store.dtype],
        *(t.data_ptr() for t in flat.values()), out.data_ptr(),
        ws.data_ptr(), ws.numel(), B * H, G, hd, S, S, Lb, M, cap, r, E,
        grid["tiles_per_split"], 1.0 / math.sqrt(hd),
        float(softcap) if use_cap else 0.0, int(use_cap),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_wave_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_wave_attention.launches += 1
    return out.view(B, H, G, hd)


paged_wave_attention.launches = 0
