"""The per-layer metrics that read the program's spans
(``perfbench/lib/spanned.py``), through a whole traced run of each cell on
the CPU at the small size of ``test_perfbench_check.py``: each reports a
value in every cell its entry lists; a run whose program records no spans
reads nothing and raises nothing."""
import time

import pytest

from perfbench.lib import bench, spanned, spec
from perfbench.test_perfbench_check import MIX, small_case

BENCH = spec.benchmark()
NAMES = ("prefill_attn_tok_s", "prefill_proj_ffn_tok_s", "index_build_tok_s",
         "translate_ms.offload", "drain_ms.offload", "admit_slot_s.offload")
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["name"] in NAMES]


@pytest.mark.parametrize("cell_name", [w["name"] for w in
                                       BENCH["workloads"]])
def test_traced_run_reads_the_spans(cell_name):
    conf, cell = small_case(cell_name)
    out = bench.execute(cell_name, 3, 0.01, True, time.perf_counter(),
                        device="cpu", conf=conf, cell=cell, mix=MIX)
    assert out["correct"], out["checks"]
    want = [m["name"] for m in SPAN_METRICS
            if cell_name in m["workloads"]]
    assert want
    for name in want:
        value = out["metrics"][name]["value"]
        assert value > 0, name


def test_entries():
    assert [m["name"] for m in SPAN_METRICS] == list(NAMES)
    for m in SPAN_METRICS:
        assert m["source"] == "program_span" and m["workloads"]


def test_no_spans_reads_nothing():
    run = bench.Run(name="mistral7b-long-offload", seed=0, cfg=None, conf={},
                    cell={}, device="cpu", weights={})
    assert spanned.call(run) is None
    for m in SPAN_METRICS:
        assert spec.reader(m["name"])(run) is None, m["name"]
