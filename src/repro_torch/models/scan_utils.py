"""Time loops over a carry, rematerialised in chunks under autograd.

Port of ``repro/models/scan_utils.py``. A recurrent (RWKV / Mamba)
training scan saves each step's residuals for the backward pass: O(T ·
state) memory. As in the reference, a scan of T steps, T a multiple of
``chunk`` and longer than it, checkpoints each chunk, which bounds the
peak at O(chunk · state + T / chunk · carry); the backward pass runs each
chunk's loop again. When autograd does not record (serving), the scan is
the plain sequential loop, and the body may update its carry in place.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode on and one
    of them requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _loop(body: Callable, carry, xs: Sequence[torch.Tensor]):
    ys = []
    for x_t in zip(*(x.unbind(0) for x in xs)):
        carry, y = body(carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys)


def remat_chunked_scan(body: Callable, carry: torch.Tensor,
                       xs: Sequence[torch.Tensor], chunk: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.scan(body, carry, xs)`` for a tensor carry and tensor ``xs``
    with a leading time axis, one tensor output a step: ``carry, y_t =
    body(carry, x_t)`` for t in order (``x_t`` the tuple of each
    ``xs[i][t]``). Returns ``(carry, stacked y)``. When autograd records
    and T % chunk == 0 and T > chunk, each chunk of ``chunk`` steps is
    checkpointed; ``body`` must then not update its carry in place."""
    T = xs[0].shape[0]
    if not records(carry, *xs) or T % chunk or T <= chunk:
        return _loop(body, carry, xs)

    def run(c, *xc):
        return _loop(body, c, xc)

    ys = []
    for t0 in range(0, T, chunk):
        carry, y = checkpoint(run, carry, *(x[t0:t0 + chunk] for x in xs),
                              use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)
