"""Time loops over a carry.

Port of ``repro/models/scan_utils.py``. The reference's
``remat_chunked_scan`` is ``lax.scan`` with per-chunk rematerialisation,
which bounds the memory of a training backward pass. The port serves (no
backward), so its counterpart is the plain sequential loop.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def remat_chunked_scan(body: Callable, carry, xs: Sequence[torch.Tensor]
                       ) -> Tuple[object, torch.Tensor]:
    """``lax.scan(body, carry, xs)`` for tensor ``xs`` with a leading time
    axis and one tensor output a step: ``carry, y_t = body(carry, x_t)``
    for t in order (``x_t`` the tuple of each ``xs[i][t]``). ``body`` may
    update the carry in place. Returns ``(carry, stacked y)``."""
    ys = []
    for x_t in zip(*(x.unbind(0) for x in xs)):
        carry, y = body(carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys)
