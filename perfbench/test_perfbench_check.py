"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (two layers of 128, a 512-token geometry, the smoke
wave-index budgets; the kernels' plain twins stand in for the card): a
sound run passes; the control (the reference in fp8 put in the program's
place) and each fault the served cells can have, planted under the timed
path, fail.

The small size computes in float32, where the program and the reference
run the same wave index on the same bits and the gap is 0; the limit sits
between that and the control's. At the cells' own sizes (bf16) the
readings and limits are those in PERF.md."""
import copy
import dataclasses
import time

import pytest

from perfbench.lib import bench, check, spec

CELL = "mistral7b-long-retro"
LIMIT = 0.05
MIX = {"requests_per_call": 6,
       "prompt": {"dist": "uniform", "lo": 100, "hi": 500},
       "output": {"dist": "uniform", "lo": 20, "hi": 120}}


def small_case(cell_name=CELL):
    from repro_torch.configs.registry import SMOKE_RETRO
    conf = copy.deepcopy(spec.config(spec.workload(spec.benchmark(),
                                                   cell_name)["config"]))
    conf.update(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=32, intermediate_size=256,
                vocab_size=512)
    port = conf["port"]
    port.update(n_layers=2, d_model=128, d_ff=256, vocab=512,
                dtype="float32")
    port["attn"].update(n_heads=4, n_kv_heads=2, head_dim=32)
    if port.get("moe"):
        port["moe"].update(num_experts=4, d_expert=256)
        conf["num_local_experts"] = 4
    smoke = dataclasses.asdict(SMOKE_RETRO)
    conf["wave_index"] = {k: smoke[k] for k in conf["wave_index"]}
    cell = copy.deepcopy(spec.cell(cell_name))
    cell["engine"].update(max_context=512, gen_headroom=256)
    if cell["engine"]["admission"] == "chunked":
        cell["engine"]["prefill_chunk"] = 64
    cell["batch"] = 4
    cell["warmup"] = {"prompt": 80, "output": 4}
    cell["check"] = {"sample": 6, "number": "widest",
                     "logit_gap_limit": LIMIT}
    return conf, cell


def run_small(seed=3, cell_name=CELL):
    conf, cell = small_case(cell_name)
    return bench.execute(cell_name, seed, 0.01, False, time.perf_counter(),
                         device="cpu", conf=conf, cell=cell, mix=MIX)


@pytest.mark.parametrize("cell_name", [w["name"] for w in
                                       spec.benchmark()["workloads"]])
def test_sound_run_is_correct(cell_name):
    """In float32 the reference's wave index is the program's, bit for
    bit: the gap is 0 (blocking and chunked admission, the direct and the
    offloaded store, dense and MoE)."""
    out = run_small(cell_name=cell_name)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap_widest"]["value"] < 1e-4
    assert out["attempted"] == 6 and out["failed"] == 0
    assert list(out["checks"]) == ["logit_gap_widest", "unfinished"]
    want = {m["name"] for m in spec.metrics(spec.benchmark(), "end_to_end",
                                            cell_name)}
    assert set(out["metrics"]) == want


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_fails_the_limit(seed):
    """Three seeds, through the run's own check (the cell's sample, number
    and limit): the program's served tokens pass, the control's (the fp8
    reference's first choice, read by the f32 reference) do not."""
    import perfbench.control as control
    conf, cell = small_case()
    o = control.read_seed(CELL, seed, "cpu", True, conf=conf, cell=cell,
                          mix=MIX)
    assert o["program"]["correct"], o
    assert check.passed(o["program"]["checks"])
    assert o["control"]["correct"] is False, o
    assert not check.passed(o["control"]["checks"])
    gap = o["control"]["checks"]["logit_gap_widest"]
    assert gap["value"] > gap["limit"] == LIMIT


def _altered_token(monkeypatch):
    from repro_torch.serving import engine
    orig, calls = engine.Sampler.__call__, [0]

    def sample(self, logits):
        ids = orig(self, logits)
        calls[0] += 1
        if calls[0] == 40:           # one token of one decode step
            ids = ids.clone()
            ids[0] = (ids[0] + 1) % logits.shape[-1]
        return ids
    monkeypatch.setattr(engine.Sampler, "__call__", sample)


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "append_token",
                        lambda st, k, v, active=None: st)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.decode_step

    def step(*a, **kw):
        logits, state = orig(*a, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits, state
    monkeypatch.setattr(transformer, "decode_step", step)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch_left_out"])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_small()
    assert not out["correct"], out["checks"]


def test_unfinished_request_is_not_correct():
    assert not check.passed(check.checks(0.0, "widest", LIMIT, 1))
    assert not check.passed(check.checks(0.0, "mean", None, 0))
    assert check.passed(check.checks(LIMIT, "widest", LIMIT, 0))


def test_sample_holds_the_longest():
    class R:
        def __init__(self, n):
            self.out_tokens = [0] * n
    reqs = [R(n) for n in (5, 9, 2, 7, 3)]
    for seed in (0, 2**31 + 5):
        idx = check.sample(reqs, seed, 3)
        assert idx[0] == 1 and len(set(idx)) == 3
        assert idx == check.sample(reqs, seed, 3)


def test_router_margin_leaves_out_near_ties():
    """The reference reports each position's smallest top-k router margin
    over the MoE layers; the check leaves out the positions under the
    cell's margin, and nothing at margin 0."""
    cell_name = "mixtral8x22b-moe-retro"
    conf, cell = small_case(cell_name)
    run = bench.build(cell_name, 7, "cpu", conf=conf, cell=cell)
    bench.warm_up(run)
    bench.window(run, MIX, 0.01)
    ref = spec.reference(conf["reference"])
    idx = check.sample(run.requests, 7, 3)
    kw = dict(retro=bench.retro_args(run))
    g0 = check.gaps(ref, run.weights, conf, run.requests, idx, "cpu", **kw)
    g1 = check.gaps(ref, run.weights, conf, run.requests, idx, "cpu",
                    router_margin=0.1, **kw)
    gx = check.gaps(ref, run.weights, conf, run.requests, idx, "cpu",
                    router_margin=1e9, **kw)
    assert g0["left_out"] == 0.0 and 0.0 < g1["left_out"] < 1.0
    assert gx["left_out"] == 1.0 and gx["widest"] == 0.0
    assert g1["widest"] <= g0["widest"]
