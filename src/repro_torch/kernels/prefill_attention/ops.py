"""Wrapper around the prefill attention kernel: causal attention of a whole
prompt (blocking admission), bf16 q, k, v, f32 arithmetic.

No counterpart in the JAX package, whose ``flash_attention_jnp`` is plain
jnp. ``models/layers.py::flash_attention_jnp`` sends a call here when
``covers`` holds for its inputs and they lie on a CUDA card; every other
call keeps the plain body (``ref.prefill_attention_ref``). Here:

* CPU tensors go to that plain twin;
* CUDA tensors go to the CUDA kernel ``csrc/prefill_attention.cu`` (built
  at first use, loaded with ctypes) — it launches or raises.

``prefill_attention.launches`` counts kernel launches (never twin runs).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "prefill_attention.cu"
HEAD_DIMS = (128,)          # the head dims csrc/prefill_attention.cu takes


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.prefill_attention
    fn.restype = I
    # q, k, v, out; B, Tq, Tk, Hq, Hkv, hd, q_offset, window, out_f32;
    # stream
    fn.argtypes = [P] * 4 + [I] * 9 + [P]
    return lib


def kernel_window(window, q_offset: int, tq: int) -> int:
    """The kernel's ``window`` argument for a ``flash_attention_jnp``
    window: 0 where it masks nothing (None, or wider than the farthest
    query-key distance, q_offset + Tq - 1: the global layers' 1e9
    sentinel), else its width; -1 where the kernel cannot take it (a
    tensor, as a training state holds, or not a whole number >= 1)."""
    if window is None:
        return 0
    if not isinstance(window, (int, float)):
        return -1
    if window > q_offset + tq - 1:
        return 0
    if window < 1 or window != int(window):
        return -1
    return int(window)


def covers(q, k, v, *, causal: bool, window, softcap, q_offset) -> bool:
    """Whether the kernel computes this ``flash_attention_jnp`` call, its
    device aside: causal with an int ``q_offset`` >= 0, no soft cap, a
    window the kernel takes (``kernel_window``: none, or a whole number of
    positions), bf16 operands of an instantiated head dim, and no gradient
    asked for (the kernel has no backward)."""
    if not causal or softcap is not None:
        return False
    if not isinstance(q_offset, int) or q_offset < 0:
        return False
    if kernel_window(window, q_offset, q.shape[1]) < 0:
        return False
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        return False
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v)))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, Tq, Hq, d) and two "
                         f"(B, Tk, Hkv, d)")
    (B, _, Hq, d), (Bk, _, Hkv, dk) = q.shape, k.shape
    if Bk != B or dk != d or Hq % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} against k {tuple(k.shape)}: "
                         f"batch and head dim must match and Hkv divide Hq")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("q, k and v must be bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def prefill_attention_plain(q, k, v, *, q_offset: int = 0, window: int = 0,
                            out_dtype=None):
    """The plain twin on the wrapper's arguments, on any device."""
    _check(q, k, v)
    return prefill_attention_ref(q, k, v, causal=True,
                                 window=float(window) if window else None,
                                 q_offset=q_offset, out_dtype=out_dtype)


def prefill_attention(q, k, v, *, q_offset: int = 0, window: int = 0,
                      out_dtype=None):
    """q: (B, Tq, Hq, 128), k, v: (B, Tk, Hkv, 128), bf16 -> (B, Tq, Hq,
    128) in ``out_dtype`` (float32, or the default bfloat16): causal
    softmax attention, query t at position p = q_offset + t seeing keys
    0..p, or with ``window`` > 0 only keys p - window + 1..p, computed in
    f32 (``csrc/prefill_attention.cu``). Two calls give the same bits."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, q_offset=q_offset,
                                       window=window, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: float32 or bfloat16")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset {q_offset!r}: an int >= 0")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window {window!r}: an int >= 0 (0: none)")
    B, Tq, Hq, d = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Tq, Hq, d), dtype=out_dtype, device=q.device)
    err = _lib().prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tk,
        Hq, Hkv, d, q_offset, window, int(out_dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: "
                           f"cudaError {err}")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
