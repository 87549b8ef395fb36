"""Build and load the port's CUDA kernels and its host C routines.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``, each
``csrc/*.c`` source by the host C compiler, into a shared library with a
plain C interface under ``<repo>/build/kernels`` at first use, then loaded
with ``ctypes``. A library is rebuilt when its source, or a header beside it
(``*.cuh`` for a ``.cu``, ``*.h`` for a ``.c``), is newer. Several sources
compile in parallel (one compiler process each).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CC_FLAGS = ["-std=c11", "-O3", "-shared", "-fPIC"]

_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def cc_path() -> str:
    for cand in ("cc", "gcc", "clang"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C compiler (cc, gcc or clang) on PATH")


def _command(src: Path, out: Path) -> List[str]:
    if src.suffix == ".c":
        return [cc_path(), *CC_FLAGS, "-o", str(out), str(src)]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def build(sources: Sequence[Path]) -> List[dict]:
    """Compile every stale source, all compiler processes started together.
    Returns one record per source: ``{"source", "lib", "seconds", "log"}``
    (``seconds`` is 0.0 and ``log`` empty for an up-to-date library).
    Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        src = Path(src)
        lib = library_path(src)
        headers = src.parent.glob("*.h" if src.suffix == ".c" else "*.cuh")
        newest = max(f.stat().st_mtime for f in (src, *headers))
        if lib.exists() and lib.stat().st_mtime >= newest:
            jobs.append((src, lib, None, None, 0.0))
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(_command(src, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc, time.perf_counter()))
    out, failed = [], []
    for src, lib, tmp, proc, t0 in jobs:
        if proc is None:
            out.append(dict(source=str(src), lib=str(lib), seconds=0.0, log=""))
            continue
        log, _ = proc.communicate()
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, lib)
        out.append(dict(source=str(src), lib=str(lib), seconds=dt, log=log))
    if failed:
        raise RuntimeError("compile failed:\n" + "\n".join(failed))
    return out


def load(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and return its loaded library (cached)."""
    source = Path(source)
    lib = library_path(source)
    if lib not in _LOADED:
        build([source])
        _LOADED[lib] = ctypes.CDLL(str(lib))
    return _LOADED[lib]
