"""The benchmark's files: BENCHMARK.json against the contract's shape,
every cell, configuration, traffic mix and per-layer reader found by name,
names and units in the allowed characters."""
import json
import re

import pytest

from perfbench.lib import bench, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    wl = spec.workload(BENCH, cell)
    c = spec.cell(cell)
    assert {"engine", "batch", "warmup", "check"} <= set(c)
    conf = spec.config(wl["config"])
    assert conf["name"] == wl["config"]
    spec.model_config(conf)
    mix = spec.traffic(wl["traffic"])
    assert mix["requests_per_call"] >= 1
    spec.reference(conf["reference"])
    for kind in ("end_to_end", "per_layer"):
        assert spec.metrics(BENCH, kind, cell), (kind, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_exists(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert callable(spec.reader(metric))
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in entry.get("workloads", CELLS):
        assert cell in CELLS
        assert entry["moves"] in {m["name"] for m in
                                  spec.metrics(BENCH, "end_to_end", cell)}


def test_end_to_end_metrics_are_computed():
    from repro_torch.serving.engine import ServeMetrics
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    m = ServeMetrics(n_slots=2, tokens_out=30, step_s=[0.01, 0.02, 0.03])
    run = bench.Run(name=CELLS[0], seed=0, cfg=None, conf={}, cell={},
                    device="cpu", weights={}, calls=[m], window_s=3.0)
    e2e = bench.end_to_end(run, 2**30, 12.5)
    assert {spec.base(n) for n in names} <= set(e2e)
    assert e2e["out_tok_s"] == 10.0 and e2e["peak_mem_gib"] == 1.0
    assert e2e["setup_s"] == 12.5
    assert e2e["itl_p95_ms"] == pytest.approx(29.0)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_entry_matches_its_file(conf):
    entry = next(c for c in BENCH["configs"] if c["name"] == conf)
    data = spec.config(conf)
    assert entry["file"] == f"perfbench/configs/{conf}.json"
    assert entry["source"] == data["source"]
    assert entry["reduced"] == data["reduced"]
    assert any(w["config"] == conf for w in BENCH["workloads"])
