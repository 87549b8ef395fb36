"""zlib's crc32 of payload rows, many rows a native call.

The routine is ``csrc/row_crc32.c`` (a carry-less-multiply fold over the
bulk of a row, a byte table for its tail and for short rows; no threads),
built by ``kernels/build.py`` into ``<repo>/build/kernels`` at first use and
bound with ``ctypes``. Every value equals ``zlib.crc32`` of the row's bytes.
``native()`` gives the bound routine on an x86-64 host with PCLMULQDQ, and
None on any other host: the wave buffers there checksum row by row with
``zlib`` (``core/wave_batch.py``), which is faster than a byte table.
"""
from __future__ import annotations

import ctypes
import functools
import platform
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "row_crc32.c"

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _contiguous(a: np.ndarray, what: str) -> None:
    if not a.flags.c_contiguous:
        raise ValueError(f"{what} must be C-contiguous")


class RowCrc:
    """The loaded library's entry points over numpy arrays."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.crc_rows.argtypes = [_P, _I64, _I64, _P]
        lib.crc_rows.restype = None
        lib.gather_crc_rows.argtypes = [_P, _I64, _P, _I64, _I64, _P, _P, _P]
        lib.gather_crc_rows.restype = None
        lib.crc_has_clmul.argtypes = []
        lib.crc_has_clmul.restype = ctypes.c_int

    def rows(self, a: np.ndarray) -> np.ndarray:
        """The crc32 of each row ``a[i]`` of a C-contiguous array, as a
        (len(a),) uint32 array."""
        _contiguous(a, "rows")
        n = a.shape[0]
        out = np.empty(n, np.uint32)
        if n:
            self.lib.crc_rows(a.ctypes.data, n, a.nbytes // n,
                              out.ctypes.data)
        return out

    def gather(self, store: np.ndarray, idx: np.ndarray, out: np.ndarray,
               check: np.ndarray, crc: np.ndarray) -> None:
        """``out[i] = store[idx[i]]`` (``np.take(store, idx, axis=0,
        mode="clip")``), and ``crc[i]`` = the crc32 of ``out[i]`` where
        ``check[i]`` (else left as it is): one pass, each row checksummed
        right after it is copied. ``store`` and ``out``: C-contiguous rows of
        one dtype and width; ``idx`` int64, ``check`` bool, ``crc`` uint32,
        each (n,)."""
        n = len(idx)
        if store.dtype != out.dtype or store.shape[1:] != out.shape[1:] \
                or out.shape[0] < n or len(store) == 0:
            raise ValueError(f"gather of {n} rows from {store.shape} "
                             f"{store.dtype} into {out.shape} {out.dtype}")
        if idx.dtype != np.int64 or check.dtype != bool \
                or crc.dtype != np.uint32 or len(check) != n \
                or len(crc) != n:
            raise ValueError("idx int64, check bool and crc uint32, each "
                             f"({n},)")
        for a, what in ((store, "store"), (out, "out"), (idx, "idx"),
                        (check, "check"), (crc, "crc")):
            _contiguous(a, what)
        if n:
            self.lib.gather_crc_rows(
                store.ctypes.data, len(store), idx.ctypes.data, n,
                store.nbytes // len(store), out.ctypes.data,
                check.ctypes.data, crc.ctypes.data)


@functools.cache
def native() -> Optional[RowCrc]:
    """The native routine where the host has the fold, built and loaded at
    the first call (a failed build or load raises); None elsewhere."""
    if platform.machine().lower() not in ("x86_64", "amd64"):
        return None
    crc = RowCrc(build.load(SOURCE))
    return crc if crc.lib.crc_has_clmul() else None
