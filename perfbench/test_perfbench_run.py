"""The command fails, printing no result, where it cannot measure: with
no CUDA card (it never falls back to the CPU), and in a directory that
holds only BENCHMARK.json and the benchmark's own files (no program)."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--workload", "mistral7b-long-retro", "--seed", str(2**31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(root, env_extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    p = _run(ROOT, {})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, {})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("argv", [[], ["--workload", "x"],
                                  ARGS[:2] + ["--seed", "1", "--seconds",
                                              "1", "--trace", "2"]])
def test_bad_arguments(argv):
    env = dict(os.environ)
    p = subprocess.run([sys.executable, "perfbench/run.py", *argv], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
