"""The port's retrolint held to the reference's where the reference still
runs: the rule table, the pragma grammar, fingerprints and the baseline,
the schedule rules on every ``reference_schedule`` fixture, the recorded
offload schedule of the same tiny serve event by event, and the Fig. 19b
clustering helpers.

(The reference's jaxpr and numerics passes do not run under this jax, so
they are not oracles; its pure-Python parts are.)
"""
import jax
import numpy as np
import pytest
import torch

from repro.analysis import findings as RF
from repro.analysis import schedule_check as RSC
from repro.analysis import schedule_model as RSM
from repro.analysis import selftest as RST
from repro_torch.analysis import findings as PF
from repro_torch.analysis import schedule_check as PSC
from repro_torch.analysis import schedule_model as PSM

torch.set_num_threads(2)


# ----------------------------------------------------------------- the rules
def test_rule_table_matches_reference():
    assert list(PF.RULES) == list(RF.RULES)
    for rid, rule in RF.RULES.items():
        assert PF.RULES[rid].title == rule.title, rid


def test_advice_rules_match_reference():
    """The advice rules (RL104, RL304, RL406) are the reference's: every
    other rule gates."""
    from repro_torch.analysis.selftest import rl103_findings
    assert {f.severity for f in rl103_findings([8])} == {"error"}
    sched = PSC.check_trace(PSM.build_trace(
        PSC.reference_schedule(pipelined=False), 2))
    assert [(f.rule, f.severity) for f in sched] == [("RL304", "advice")]


@pytest.mark.parametrize("i", range(len(RST.FIXTURES)))
@pytest.mark.parametrize("which", ["bad", "good"])
def test_pragma_scan_matches_reference(i, which):
    src = getattr(RST.FIXTURES[i], which)
    assert PF.Pragmas.scan(src).by_line == RF.Pragmas.scan(src).by_line


@pytest.mark.parametrize("src", [
    "x = f(  # retrolint: sync(reason)\n    y)\n",
    "y = g()  # retrolint: ignore(RL002: checked)  # retrolint: hot\n",
    "z = h()  # retrolint: sync()\n",
])
def test_pragma_scan_matches_reference_on_edge_cases(src):
    assert PF.Pragmas.scan(src).by_line == RF.Pragmas.scan(src).by_line


def test_cuda_pragma_is_read():
    p = PF.Pragmas.scan("  x = y;  // retrolint: ignore(RL201: fenced)\n")
    assert p.ignores(1, "RL201")


@pytest.mark.parametrize("finding", [
    ("RL001", "src/a.py", 10, "f", "sync np.asarray", "error"),
    ("RL203", "src/k.cu", 3, "g", "footprint 99 bytes", "error"),
    ("RL104", "src/e.py", 0, "s", "arg 1 copy", "advice"),
])
def test_fingerprint_matches_reference(finding):
    rule, path, line, qual, msg, sev = finding
    a = PF.Finding(rule, path, line, qual, msg, severity=sev)
    b = RF.Finding(rule, path, line, qual, msg, severity=sev)
    assert a.fingerprint == b.fingerprint and a.render() == b.render()


def test_baseline_roundtrip(tmp_path):
    f1 = PF.Finding("RL001", "src/a.py", 10, "f", "sync .cpu()")
    f2 = PF.Finding("RL203", "src/k.cu", 3, "g", "footprint 99 bytes")
    adv = PF.Finding("RL104", "src/e.py", 0, "s", "arg 1 copy",
                     severity="advice")
    path = str(tmp_path / "baseline.txt")
    PF.write_baseline(path, [f1, f2, adv])
    base = PF.load_baseline(path)
    assert base == {f1.fingerprint, f2.fingerprint}   # advice never baselined
    assert RF.load_baseline(path) == base              # the same file format
    assert PF.apply_baseline([f1, f2, adv], base) == [adv]
    assert PF.load_baseline(str(tmp_path / "nope.txt")) == set()


# -------------------------------------------------------------- the schedule
VARIANTS = {
    "pipelined": dict(pipelined=True),
    "pre_pipeline": dict(pipelined=False),
    "warm": dict(warm=True),
    "drop_mirror": dict(drop_mirror=True),
    "three_layers": dict(n_layers=3, steps=3),
}


def _rows(found):
    return [(f.rule, f.severity, f.qualname, f.message) for f in found]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_schedule_rules_match_reference(variant):
    kw = dict(VARIANTS[variant])
    n = kw.get("n_layers", 2)
    sched = RSC.reference_schedule(**kw)
    assert PSC.reference_schedule(**kw) == sched
    want = _rows(RSC.check_trace(RSM.build_trace(sched, n)))
    got = _rows(PSC.check_trace(PSM.build_trace(sched, n)))
    assert got == want


def test_schedule_effects_match_reference():
    from repro.serving.engine import SERVE_STAGES as REF
    from repro_torch.serving.engine import SERVE_STAGES as PORT
    assert list(PORT) == list(REF)
    for name, c in REF.items():
        assert PORT[name]["effects"] == c["effects"], name
        assert PORT[name]["space"] == c["space"], name
        assert PORT[name].get("numerics") == c.get("numerics"), name


@pytest.fixture(scope="module")
def recorded_schedules():
    """The same tiny offload serve (config, weights, requests) recorded by
    both packages' ``ScheduleRecorder``."""
    from repro.analysis.jaxpr_check import _requests as ref_requests
    from repro.analysis.jaxpr_check import _tiny_setup as ref_setup
    from repro.serving.engine import ServeEngine as RefEngine
    from repro_torch.analysis.stage_check import (LENGTHS, MAX_NEW,
                                                  _requests, _tiny_setup)
    from repro_torch.interop import params_from_numpy
    from repro_torch.serving.engine import ServeEngine
    ref_cfg, ref_params = ref_setup()
    cfg, _ = _tiny_setup("cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    with RSM.ScheduleRecorder() as ref:
        RefEngine(ref_cfg, ref_params, gen_headroom=256, admission="chunked",
                  offload=True, temperature=0.0).serve(
            ref_requests(list(LENGTHS), MAX_NEW), batch_size=2, seed=0)
    with PSM.ScheduleRecorder() as port:
        ServeEngine(cfg, params, gen_headroom=256, admission="chunked",
                    offload=True, temperature=0.0, device="cpu").serve(
            _requests(LENGTHS, MAX_NEW), batch_size=2, seed=0)
    return ref, port


def test_recorded_schedule_matches_reference(recorded_schedules):
    ref, port = recorded_schedules
    key = lambda r: [(s, l, op, k) for s, l, op, k, _ in r._raw]
    assert len(port._raw) > 100
    assert key(port) == key(ref)


def test_recorded_queued_bits_match_reference(recorded_schedules):
    ref, port = recorded_schedules
    q = lambda r: [x.get("queued") for *_, x in r._raw
                   if "queued" in x]
    assert q(port) == q(ref) and True in q(port) and False in q(port)


def test_recorded_schedule_findings_match_reference(recorded_schedules):
    ref, port = recorded_schedules
    assert _rows(PSC.schedule_findings(port.trace)) == _rows(
        RSC.schedule_findings(ref.trace)) == []


# --------------------------------------------- Fig. 19b clustering helpers
def _separated(seed, n=256, hd=16, k=8):
    """Keys in k tight, well-separated groups and a query aligned with one:
    the top-k keys and the top clusters are far from any tie."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, hd)) * 4.0
    assign = rng.integers(0, k, n)
    keys = centers[assign] + 0.05 * rng.standard_normal((n, hd))
    q = centers[seed % k] + 0.05 * rng.standard_normal(hd)
    return keys.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_clustering_recall_matches_reference(seed, r):
    """Recall over the reference's own clusters (both packages score the
    same stores): equal within 1e-6."""
    import jax.numpy as jnp
    from repro.core import clustering as RC
    from repro_torch.core import clustering as PC
    keys, q = _separated(seed)
    n = keys.shape[0]
    res = RC.segmented_cluster(jnp.asarray(keys), jnp.asarray(keys),
                               jnp.arange(n, dtype=jnp.int32), segment=128,
                               avg_cluster=16, cap=64, iters=5,
                               centering=False)
    want = float(RC.clustering_recall(jnp.asarray(q), jnp.asarray(keys), res,
                                      r=r, topk=20))
    pres = PC.ClusterResult(*(torch.from_numpy(np.array(a)) for a in res))
    got = float(PC.clustering_recall(torch.from_numpy(q),
                                     torch.from_numpy(keys), pres, r=r,
                                     topk=20))
    assert abs(got - want) <= 1e-6, (got, want)


def test_positions_to_local_matches_reference():
    from repro.core import clustering as RC
    from repro_torch.core import clustering as PC
    pos = np.array([[3, -1, 0], [-1, 7, 2]], np.int32)
    want = np.asarray(RC.positions_to_local(pos, 5))
    got = PC.positions_to_local(torch.from_numpy(pos), 5).numpy()
    np.testing.assert_array_equal(got, want)        # exact: integer ids
