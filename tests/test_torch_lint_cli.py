"""The port's lint CLI (``python -m repro_torch.launch.lint``): exit codes,
the JSON and GitHub outputs, ``--explain`` for every rule, ``--selftest``
as a subprocess, and the port's own baseline file."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis.findings import BASELINE_NAME, RULES
from repro_torch.analysis.selftest import BAD_FIXTURES
from repro_torch.launch import lint as lint_cli

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(REPO, "src")


def _seed_tree(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return str(tmp_path)


def _clean(tmp_path):
    return _seed_tree(tmp_path, {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/clean.py": "import torch\n\ndef f(x):\n"
                                    "    return x + 1\n"})


@pytest.mark.parametrize("rule", sorted(RULES))
def test_explain_every_rule(rule, capsys):
    assert lint_cli.main(["--explain", rule.lower()]) == 0
    out = capsys.readouterr().out
    assert rule in out and RULES[rule].title in out


def test_explain_unknown_rule_exits_two():
    assert lint_cli.main(["--explain", "RL999"]) == 2


def test_bad_geometry_exits_two(tmp_path):
    with pytest.raises(SystemExit) as e:
        lint_cli.main(["--root", str(tmp_path), "--geometry", "oops"])
    assert e.value.code != 0


def test_unknown_flag_exits_two():
    with pytest.raises(SystemExit) as e:
        lint_cli.main(["--vmem-budget", "1"])
    assert e.value.code == 2


def test_clean_tree_exits_zero(tmp_path):
    assert lint_cli.main(["--root", _clean(tmp_path), "--no-trace",
                          "-q"]) == 0


@pytest.mark.parametrize("rule", sorted(BAD_FIXTURES))
def test_seeded_bad_fixture_trips_gate(tmp_path, rule, capsys):
    fx = BAD_FIXTURES[rule]
    root = _seed_tree(tmp_path, {fx.path: fx.bad})
    assert lint_cli.main(["--root", root, "--no-trace", "-q"]) == 1
    assert rule in capsys.readouterr().out


def test_smem_budget_flag(tmp_path):
    """The shipped kernels fit the H100's 227 KiB; a 64 KiB budget does
    not hold the k-means ring."""
    assert lint_cli.main(["--root", REPO, "--no-trace", "-q"]) == 0
    assert lint_cli.main(["--root", REPO, "--no-trace", "-q",
                          "--smem-budget", str(64 * 1024)]) == 1


def test_json_and_json_out(tmp_path, capsys):
    fx = BAD_FIXTURES["RL003"]
    root = _seed_tree(tmp_path, {fx.path: fx.bad})
    out_path = tmp_path / "out.json"
    assert lint_cli.main(["--root", root, "--no-trace", "-q", "--json",
                          "--json-out", str(out_path)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc == json.loads(out_path.read_text())
    assert doc["errors"] >= 1 and doc["ok"] is False
    f = doc["findings"][0]
    assert f["rule"] == "RL003" and f["fingerprint"].startswith("RL003:")


def test_json_inventory_of_the_shipped_kernels(tmp_path, capsys):
    """The static gate over the shipped tree is clean, and the JSON carries
    no advice without the trace passes (the RL406 inventory comes with
    the numerics pass)."""
    assert lint_cli.main(["--root", REPO, "--no-trace", "-q",
                          "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["errors"] == 0


def test_github_annotations(tmp_path, capsys):
    fx = BAD_FIXTURES["RL201"]
    root = _seed_tree(tmp_path, {fx.path: fx.bad})
    assert lint_cli.main(["--root", root, "--no-trace", "-q",
                          "--github"]) == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("::error")]
    assert lines and "title=retrolint RL201" in lines[0]
    assert f"file={fx.path}" in lines[0]


def test_write_baseline_then_clean(tmp_path):
    fx = BAD_FIXTURES["RL003"]
    root = _seed_tree(tmp_path, {fx.path: fx.bad})
    (tmp_path / "lint_baseline.txt").write_text("# the reference's\n")
    assert lint_cli.main(["--root", root, "--no-trace", "-q",
                          "--write-baseline"]) == 0
    written = (tmp_path / BASELINE_NAME).read_text()
    assert "RL003:" in written
    assert (tmp_path / "lint_baseline.txt").read_text() == "# the reference's\n"
    assert lint_cli.main(["--root", root, "--no-trace", "-q"]) == 0


def test_write_baseline_leaves_the_references_file(tmp_path):
    """Over a copy of the shipped tree's root files: the port writes its own
    baseline and the reference's stays byte-identical."""
    ref = os.path.join(REPO, "lint_baseline.txt")
    with open(ref, "rb") as f:
        before = f.read()
    root = _clean(tmp_path)
    (tmp_path / "lint_baseline.txt").write_bytes(before)
    assert lint_cli.main(["--root", root, "--no-trace", "-q",
                          "--write-baseline"]) == 0
    assert (tmp_path / "lint_baseline.txt").read_bytes() == before
    assert (tmp_path / BASELINE_NAME).exists()


def test_repo_root_is_found_from_a_subdirectory():
    assert lint_cli._repo_root(os.path.join(SRC, "repro_torch",
                                            "analysis")) == REPO


def test_selftest_cli_entrypoint():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.lint",
                          "--selftest"], env=env, cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
    assert "ok (0 failures)" in out.stdout
