"""PyTorch port of RetroInfer for one NVIDIA H100.

Mirrors ``repro/`` file for file; each module names the JAX module it
ports. Imports ``torch`` and never ``jax``. Entry points take an explicit
``device`` and default to ``"cuda"``; the CPU runs the kernels' plain
PyTorch twins (tests only).
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without a card raises instead of
    carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain twins")
    return dev
