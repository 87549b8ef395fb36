"""The traffic generator: the same seed gives the same requests; every
seed and call the same multiset of lengths, within the mix's range."""
import glob
import os

import numpy as np
import pytest

from perfbench.lib import spec, traffic

MIXES = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(os.path.dirname(__file__), "traffic", "*.json")))
BIG = 2**31 + 12345


@pytest.mark.parametrize("mix", MIXES)
def test_deterministic_from_seed(mix):
    m = spec.traffic(mix)
    a = traffic.call_requests(m, 32000, BIG, 1)
    b = traffic.call_requests(m, 32000, BIG, 1)
    assert [(p.tolist(), n) for p, n in a] == [(p.tolist(), n) for p, n in b]
    c = traffic.call_requests(m, 32000, BIG + 1, 1)
    assert [p.tolist() for p, _ in a] != [p.tolist() for p, _ in c]


@pytest.mark.parametrize("mix", MIXES)
def test_same_work_in_another_order(mix):
    m = spec.traffic(mix)
    runs = [traffic.call_requests(m, 32000, s, c)
            for s, c in ((0, 0), (BIG, 0), (7, 3))]
    for r in runs:
        assert len(r) == m["requests_per_call"]
        for p, n in r:
            assert m["prompt"]["lo"] <= len(p) <= m["prompt"]["hi"]
            assert m["output"]["lo"] <= n <= m["output"]["hi"]
            assert p.dtype == np.int32 and 0 <= p.min() and p.max() < 32000
    lens = [sorted(len(p) for p, _ in r) for r in runs]
    outs = [sorted(n for _, n in r) for r in runs]
    assert lens[0] == lens[1] == lens[2] and outs[0] == outs[1] == outs[2]


def test_quantiles_hand_count():
    q = traffic.quantiles({"dist": "uniform", "lo": 0, "hi": 100}, 4)
    assert q.tolist() == [12, 38, 62, 88]
    q = traffic.quantiles({"dist": "loguniform", "lo": 1, "hi": 10000}, 2)
    assert q.tolist() == [10, 1000]
