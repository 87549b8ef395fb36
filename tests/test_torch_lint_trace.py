"""The port's trace passes over the shipped tree: the stage contract over
the two tiny serves (clean, no advice), the dynamic half of RL001, the
recorded offload schedule, and the numerics pass on fake CUDA tensors with
its cast inventory in the CUDA sources."""
import os

import pytest
import torch

from repro_torch.analysis import stage_check
from repro_torch.launch import lint as lint_cli

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def contract():
    reports = []
    findings = stage_check.run_contract_checks(reports=reports)
    return findings, reports


def test_contract_pass_is_clean(contract):
    findings, _ = contract
    assert [f.render() for f in findings] == []    # errors and advice


@pytest.mark.parametrize("run, stage", [
    (0, s) for s in stage_check._OFFLOAD_STAGES] + [
    (1, s) for s in stage_check._BLOCKING_STAGES])
def test_planned_stage_ran(contract, run, stage):
    """Every stage a run's plan exercises was recorded (or, captured, its
    graph built once; the CPU captures nothing)."""
    from repro_torch.serving.engine import SERVE_STAGES
    rep = contract[1][run]
    if SERVE_STAGES[stage]["budget"] == "per_geometry":
        owners = [g for g in rep.recorder.graphs if stage in g.STAGES]
        assert len(owners) == 1 and owners[0].captures == 0
    else:
        assert rep.recorder.records[stage].calls >= 1


def test_captures_per_stage_on_the_cpu(contract):
    caps = stage_check.captures_per_stage(contract[1])
    assert caps and set(caps.values()) == {0}


def test_dynamic_rl001_sees_implicit_syncs(monkeypatch):
    """With every pragma ignored, the hot path's implicit syncs show up:
    ``int(tensor)`` in ``admit_slot`` among them."""
    monkeypatch.setattr(stage_check._Sites, "sanctioned",
                        lambda self, path, line: False)
    found = stage_check.run_contract_checks()
    hot = {(f.path, f.qualname) for f in found if f.rule == "RL001"}
    assert ("src/repro_torch/serving/engine.py",
            "_OffloadPlane.admit_slot") in hot
    assert "RL101" in {f.rule for f in found}     # and the stage syncs


def test_schedule_pass_is_clean():
    from repro_torch.analysis.schedule_check import run_schedule_checks
    assert run_schedule_checks() == []


def test_numerics_pass_is_clean_with_an_inventory_in_csrc():
    from repro_torch.analysis.numerics_check import run_numerics_checks
    found = run_numerics_checks()
    errors = [f.render() for f in found if f.severity == "error"]
    assert errors == []
    inv = [f for f in found if f.rule == "RL406"]
    assert len(inv) >= 2
    assert all(f.severity == "advice" and
               "/kernels/wave_attention/csrc/" in f.path for f in inv)
    assert {f.qualname for f in inv} >= {"Acc::add", "fold_tile"}


def test_full_gate_exits_zero(capsys):
    assert lint_cli.main(["--root", REPO, "-q"]) == 0
    out = capsys.readouterr().out
    assert "RL406 [advice]" in out
