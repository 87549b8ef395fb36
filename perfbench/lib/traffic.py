"""The one traffic generator: a mix file's parameters -> the requests of a
``serve`` call, from the run's seed and the call's number.

Every call of every seed has the same multiset of prompt and answer
lengths: ``requests_per_call`` evenly spaced quantiles of each length
distribution (``uniform`` or ``loguniform`` between ``lo`` and ``hi``).
The seed and the call's number choose their order, the pairing of prompt
with answer lengths, and the tokens (uniform over the vocabulary). So two
seeds do the same work in another order, and a seed always gives the same
requests."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """n lengths at the quantiles (i + 1/2) / n of ``dist``."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "uniform":
        x = lo + (hi - lo) * u
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def call_requests(mix: Dict, vocab: int, seed: int, call: int
                  ) -> List[Tuple[np.ndarray, int]]:
    """(prompt int32 tokens, answer length) of each request of call
    ``call``, in queue order."""
    n = mix["requests_per_call"]
    rng = np.random.default_rng([seed % 2**64, call])
    prompts = rng.permutation(quantiles(mix["prompt"], n))
    outputs = rng.permutation(quantiles(mix["output"], n))
    return [(rng.integers(0, vocab, size=int(p), dtype=np.int32), int(o))
            for p, o in zip(prompts, outputs)]
