"""What decides ``correct``: the served tokens of a sample of the window's
finished requests, judged by the plain reference.

After the window closes, the peak memory is read and the engine's state
is freed, the harness draws from the seed a sample of the requests the
window finished, the one with the most served tokens always in it. The
reference runs once over each prompt with its served tokens (all but the
last) and gives, at each served position, the gap by which the served
token's logit lies below the reference's best. The number compared is the
widest gap over the sample, or, in a cell whose file names ``"mean"``,
the mean gap over all its served positions (where the widest gap of the
program and of the control do not separate: ``PERF.md`` says why). A MoE
cell's file may name a ``router_margin``: positions where the reference's
top-k router choice is that close to a tie leave the comparison. The
cell file's ``logit_gap_limit`` is its limit (``PERF.md`` gives the
readings it was set from). Every request of the window must also have
finished with all its tokens."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def sample(requests: Sequence, seed: int, n: int) -> List[int]:
    """Indices of ``n`` requests: the one with the most served tokens,
    then others drawn from the seed."""
    longest = max(range(len(requests)),
                  key=lambda i: len(requests[i].out_tokens))
    rest = [i for i in range(len(requests)) if i != longest]
    rng = np.random.default_rng([seed % 2**64, 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def unfinished(requests: Sequence) -> int:
    return sum(1 for r in requests if r.status != "ok" or not r.done
               or len(r.out_tokens) != r.max_new_tokens)


def gaps(ref, weights: Dict, conf: Dict, requests: Sequence,
         idx: Sequence[int], device, precision: str = "f32",
         retro: Optional[Dict] = None,
         router_margin: float = 0.0) -> Dict[str, float]:
    """The widest and the mean gap over the served positions of the
    sampled requests (``precision`` "fp8": the control's tokens instead of
    the served ones, as ``served_gaps`` reads them; ``retro``: the
    reference's wave-index
    arguments), and the share of positions left out: those whose router
    margin in the float32 reference is under ``router_margin`` in some
    MoE layer, where a rounding of the hidden state can send the token to
    other experts."""
    worst, total, n, seen = 0.0, 0.0, 0, 0
    for i in idx:
        r = requests[i]
        prompt = torch.as_tensor(r.prompt, device=device)
        out: Dict = {}
        g = ref.served_gaps(weights, conf, prompt, list(r.out_tokens),
                            precision=precision, retro=retro, out=out)
        seen += g.numel()
        g = g[out["router_margin"] >= router_margin]
        if g.numel():
            worst = max(worst, float(g.max()))
            total += float(g.double().sum())
        n += g.numel()
        del g
    return {"widest": worst, "mean": total / max(n, 1),
            "left_out": 1.0 - n / max(seen, 1)}


def checks(gap: float, number: str, limit: Optional[float],
           n_unfinished: int) -> Dict:
    """The numbers compared, each with its limit, in the order printed:
    the cell's gap number (``widest`` or ``mean``) and the requests left
    unfinished."""
    return {f"logit_gap_{number}": {"value": gap, "limit": limit},
            "unfinished": {"value": n_unfinished, "limit": 0}}


def passed(numbers: Dict) -> bool:
    return all(v["limit"] is not None and v["value"] <= v["limit"]
               for v in numbers.values())
