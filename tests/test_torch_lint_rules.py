"""The port's retrolint rules: every fixture pair, the self-tests, the
shipped tree clean under the static passes, the sanctioned syncs annotated,
seeded bugs tripping their rules, and the package importing no JAX."""
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import ast_rules, kernel_check
from repro_torch.analysis.findings import (BASELINE_NAME, RULES, Pragmas,
                                           apply_baseline, load_baseline)
from repro_torch.analysis.selftest import (BAD_FIXTURES, FIXTURES,
                                           rl103_findings, run_selftests)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(REPO, "src")
torch.set_num_threads(2)


@pytest.mark.parametrize("fx", FIXTURES,
                         ids=[f"{f.rule}-{i}" for i, f in enumerate(FIXTURES)])
def test_rule_fixture_pair(fx):
    """Each bad fixture trips its rule; its good twin stays silent."""
    bad = [f for f in fx.checker(fx.bad) if f.rule == fx.rule]
    assert bad, f"{fx.rule}: bad fixture not flagged"
    good = [f for f in fx.checker(fx.good) if f.severity == "error"]
    assert not good, f"{fx.rule}: good fixture flagged: {good[0].render()}"


def test_selftests_static_rules_pass():
    assert run_selftests(include_traced=False) == []


def test_selftests_traced_rules_pass():
    assert run_selftests(include_traced=True) == []


def test_every_rule_has_fixture_or_selftest():
    from repro_torch.analysis import selftest
    covered = {fx.rule for fx in FIXTURES}
    covered |= {name[len("_selftest_"):].upper() for name in dir(selftest)
                if name.startswith("_selftest_rl")}
    assert set(RULES) - covered == set()


def test_repo_static_passes_are_clean():
    """The shipped tree is the canonical good fixture: zero static errors
    with the (empty) port baseline."""
    findings = ast_rules.lint_tree(REPO) + kernel_check.check_tree(REPO)
    visible = apply_baseline(findings,
                             load_baseline(os.path.join(REPO, BASELINE_NAME)))
    errors = [f.render() for f in visible if f.severity == "error"]
    assert not errors, "\n".join(errors)
    assert load_baseline(os.path.join(REPO, BASELINE_NAME)) == set()


def _sync_reasons(rel):
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    return src, [payload for entries in Pragmas.scan(src).by_line.values()
                 for kind, payload in entries if kind == "sync"]


@pytest.mark.parametrize("rel, least", [
    ("src/repro_torch/serving/engine.py", 6),
    ("src/repro_torch/serving/graphs.py", 3),
    ("src/repro_torch/core/wave_index.py", 2),
])
def test_sanctioned_syncs_carry_reasons(rel, least):
    """Every sanctioned sync of the port carries a reasoned pragma: the
    sync inventory the README lists."""
    _, reasons = _sync_reasons(rel)
    assert len(reasons) >= least and all(reasons), reasons


@pytest.mark.parametrize("qual, text", [
    ("_Readback.get", "self.event.synchronize()"),
    ("OffloadStage.wait_ids", "self.event.synchronize()"),
    ("ServeEngine.serve", "first.cpu().numpy()"),
    ("_OffloadPlane.admit_slot", "host = _pack("),
    ("_OffloadPlane.flush", ".cpu().numpy()"),
])
def test_hot_syncs_are_annotated(qual, text):
    """Removing the pragma from a sanctioned hot-path sync trips RL001."""
    path = "src/repro_torch/serving/" + (
        "graphs.py" if qual.startswith("OffloadStage") else "engine.py")
    src, _ = _sync_reasons(path)
    lines = src.splitlines()
    at = [i for i, ln in enumerate(lines)
          if "retrolint: sync" in ln and (text in ln or text in
                                          "\n".join(lines[i:i + 3]))]
    assert at, text
    stripped = "\n".join(ln.split("  # retrolint")[0] if i in at else ln
                         for i, ln in enumerate(lines))
    hits = [f for f in ast_rules.lint_source(stripped, path)
            if f.rule == "RL001" and f.qualname == qual]
    assert hits, f"{qual}: unannotated sync not flagged"


def test_sync_pragma_requires_reason():
    src = BAD_FIXTURES["RL001"].bad.replace(
        "# unsanctioned host sync", "# retrolint: sync()")
    assert [f for f in ast_rules.lint_source(src, "x.py")
            if f.rule == "RL001"]


def test_ignore_pragma_names_the_rule():
    fx = BAD_FIXTURES["RL002"]
    src = fx.bad.replace("# tensor-valued branch",
                         "# retrolint: ignore(RL002: checked)")
    assert not [f for f in ast_rules.lint_source(src, fx.path)
                if f.rule == "RL002"]
    src = fx.bad.replace("# tensor-valued branch",
                         "# retrolint: ignore(RL003: wrong rule)")
    assert [f for f in ast_rules.lint_source(src, fx.path)
            if f.rule == "RL002"]


def test_captured_branch_only_in_captured_bodies():
    """RL002 holds only the bodies a graph captures: the same branch in an
    uncaptured file is eager code."""
    assert not [f for f in ast_rules.lint_source(BAD_FIXTURES["RL002"].bad,
                                                 "src/x.py")
                if f.rule == "RL002"]


def test_smem_estimate_moves_with_the_source():
    """RL203's estimate is parsed from the sources: raising the k-means
    ring to three stages passes the H100's per-block budget."""
    path = os.path.join(REPO, "src/repro_torch/kernels/kmeans/csrc/"
                        "kmeans_step.cu")
    with open(path) as f:
        src = f.read()
    assert not kernel_check.check_cuda_source(src, "k.cu")
    bad = src.replace("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")
    assert [f.rule for f in kernel_check.check_cuda_source(bad, "k.cu")] == \
        ["RL203"]


@pytest.mark.parametrize("cut", [
    "    mbar_wait(&full[slot], (step / STAGES) & 1);\n",
    "      mbar_wait(&empty[slot], ((step / STAGES) & 1) ^ 1);\n",
    "    if ((tid & 127) == 0) mbar_arrive(&empty[slot]);\n",
])
def test_kmeans_ring_mutations_trip_rl201(cut):
    path = os.path.join(REPO, "src/repro_torch/kernels/kmeans/csrc/"
                        "kmeans_step.cu")
    with open(path) as f:
        src = f.read()
    assert cut in src
    found = kernel_check.check_cuda_source(src.replace(cut, ""), "k.cu")
    assert {f.rule for f in found} == {"RL201"}


# ------------------------------------------------------------- seeded bugs
def _old_full_attention_decode(q, cache):
    """The dense fallback before its repair: the whole cache upcast to f32
    before both products."""
    B, Hq, hd = q.shape
    Hkv = cache.k.shape[1]
    k = cache.k.float()
    v = cache.v.float()
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) / math.sqrt(hd)
    ok = torch.arange(k.shape[2], device=q.device)[None, :] \
        < cache.length[:, None]
    p = torch.softmax(torch.where(ok[:, None, None, :], s, -1e30), -1)
    return torch.einsum("bhgt,bhtd->bhgd", p, v).reshape(B, Hq, hd) \
        .to(q.dtype)


def test_seeded_dense_upcast_trips_rl402():
    from repro_torch.analysis.numerics_check import numerics_findings
    from repro_torch.core import attention as attn

    def make():
        cache = attn.init_dense_cache(2, 4, 8192, 128, torch.bfloat16, "cuda")
        return torch.zeros((2, 8, 128), dtype=torch.bfloat16,
                           device="cuda"), cache
    old, _ = numerics_findings(_old_full_attention_decode, make, "old",
                               path="x")
    assert sum(f.rule == "RL402" for f in old) >= 2, [f.render() for f in old]
    new, _ = numerics_findings(lambda q, c: attn.full_attention_decode(q, c),
                               make, "new", path="x")
    assert new == []


def _item_stage(x):
    return x * x.max().item()


def _rebinding_flush(cfg, state):
    return state._replace(kv=[st._replace(local_len=st.local_len + 0)
                              for st in state.kv])


def test_seeded_item_in_a_stage_trips_rl101():
    from repro_torch.analysis.stage_check import StageRecorder
    table = {"s": dict(fn=f"{__name__}:_item_stage", donate=(),
                       budget="eager", space="device")}
    rec = StageRecorder(table)
    with rec:
        sys.modules[__name__]._item_stage(torch.ones(4))
    assert [f.rule for f in rec.records["s"].findings] == ["RL101"]


def test_seeded_rebinding_flush_trips_rl102():
    """The flush stage rebinding one counter of the direct serve's state."""
    from repro_torch.analysis.stage_check import StageRecorder
    from repro_torch.analysis.stage_check import _tiny_setup
    from repro_torch.models import model as M
    cfg, _ = _tiny_setup()
    state = M.make_serve_state(cfg, 2, 128, gen_headroom=64, zero_fill=True,
                               device="cpu")
    table = {"flush": dict(fn=f"{__name__}:_rebinding_flush", donate=(1,),
                           budget="eager", space="device")}
    rec = StageRecorder(table)
    with rec:
        sys.modules[__name__]._rebinding_flush(cfg, state)
    assert "RL102" in {f.rule for f in rec.records["flush"].findings}


@pytest.mark.parametrize("captures, device, bad", [
    ([8], "cuda", True),          # a capture per step
    ([1, 1], "cuda", True),       # two graphs of one geometry
    ([0], "cuda", True),          # the card never captured it
    ([], "cpu", True),            # the graph was never built: bypassed
    ([1], "cuda", False),
    ([0], "cpu", False),          # the CPU runs the step eagerly
])
def test_capture_budget(captures, device, bad):
    found = rl103_findings(captures, device=device)
    assert bool(found) == bad and all(f.rule == "RL103" for f in found)


def test_seeded_bf16_den_trips_rl405():
    from repro_torch.analysis.numerics_check import parts_findings
    from repro_torch.analysis.numerics_check import _wave_setup
    from repro_torch.core import attention as attn
    retro, plan, make = _wave_setup("cuda")

    def parts(q, st, den_dtype):
        num, den, m = attn.wave_attention_decode(
            q, st, retro, plan, impl="jnp", return_parts=True)[:3]
        return num, den.to(den_dtype), m
    bad = parts_findings(lambda q, st: parts(q, st, torch.bfloat16), make,
                         "bf16-den", path="x")
    assert [f.rule for f in bad] == ["RL405"] and "`den`" in bad[0].message
    assert parts_findings(lambda q, st: parts(q, st, torch.float32), make,
                          "f32", path="x") == []


# ------------------------------------------------------------------ no JAX
def test_analysis_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = SRC
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.launch.lint\n"
            "from repro_torch.analysis import (ast_rules, csource, findings,"
            " kernel_check, numerics_check, schedule_check, schedule_model,"
            " selftest, stage_check)\n"
            "assert 'jax' not in sys.modules, 'jax'\n"
            "assert not [m for m in sys.modules if m == 'repro' or "
            "m.startswith('repro.')], 'repro'\n"
            "print('NO_JAX')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert "NO_JAX" in out.stdout, out.stderr[-2000:]
