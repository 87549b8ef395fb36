"""The port's spans (``repro_torch.spans``): the recorder (nesting, parent
indices, self time, off costs nothing and never enters a profiler range),
and served calls on gemma2-2b ``reduced()`` with spans on: the same tokens
and counters as with spans off, spans that add up to the call's own
counters (admissions, decode steps, the offload plane's layers), request
ids shared by one request's admission spans, and the span names on a
``torch.profiler`` trace's host timeline. On a CUDA card (marked ``cuda``):
device spans resolved from events, and one ``capture`` span a call:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_spans.py -q
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import gemma2_2b
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(2)
PROMPTS = [(300, 12), (200, 150), (260, 8)]     # (prompt, answer) lengths


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time CUDA events")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    cfg = gemma2_2b.reduced()
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _requests(cfg, prompts=PROMPTS):
    rng = np.random.default_rng(0)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in prompts]


def _serve(model, device="cpu", **kw):
    cfg, params = model
    params = _to(params, device)
    eng = ServeEngine(cfg, params, device=device, max_context=512, **kw)
    reqs = _requests(cfg)
    return eng, reqs, eng.serve(reqs, 2)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _counters(m):
    return (m.tokens_out, m.prefill_tokens, m.steps, m.flushes,
            m.occupied_slot_steps, vars(m.cache), m.degraded_steps)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_nesting_parents_and_attributes():
    with spans.recording() as rec:
        with spans.host("a", rid=3):
            with spans.host("b", layer=1):
                pass
            with spans.device("c"):
                with spans.host("d"):
                    pass
        with spans.host("e"):
            pass
    assert [s.name for s in rec.records] == list("abcde")
    assert [s.parent for s in rec.records] == [-1, 0, 0, 2, -1]
    assert rec.records[0].attrs == {"rid": 3}
    assert rec.records[1].attrs == {"layer": 1}
    # on the CPU a device span is timed as a host span
    assert not any(s.on_device for s in rec.records)
    for s in rec.records:
        assert s.end_ns >= s.start_ns and s.seconds >= 0
    assert spans._ACTIVE.get() is None


def test_self_time_subtracts_children_on_the_same_clock():
    rec = spans.Spans()
    rec.records = [
        spans.Span("layer", 0, 10_000_000),                     # 10 ms
        spans.Span("attn", 1_000_000, 4_000_000, parent=0),     # 3 ms
        spans.Span("index", 5_000_000, 7_000_000, parent=0),    # 2 ms
        spans.Span("layer", 20_000_000, 24_000_000),            # 4 ms
        # a card-timed child does not come off a host parent
        spans.Span("kernel", 20_000_000, 21_000_000, parent=3,
                   on_device=True, device_s=0.5),
    ]
    tot = rec.totals()
    assert tot["layer"] == [2, pytest.approx(0.014), pytest.approx(0.009)]
    assert tot["attn"] == [1, pytest.approx(0.003), pytest.approx(0.003)]
    assert rec.self_seconds("layer") == pytest.approx(0.009)
    assert rec.seconds("kernel") == 0.5 and rec.count("layer") == 2
    assert rec.totals(by="layer")[("layer", None)] == tot["layer"]
    rec.records[1].attrs = {"layer": 7}
    assert rec.totals(by="layer")[("attn", 7)][0] == 1


def test_off_records_nothing_and_enters_no_range(monkeypatch, model):
    def fail(*a, **kw):
        raise AssertionError("a profiler range was entered")
    monkeypatch.setattr(spans, "_RANGE", fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", fail)
    assert spans.host("x", rid=1) is spans._OFF
    assert spans.device("x") is spans._OFF
    spans.resolve()
    _, reqs, m = _serve(model, admission="blocking", offload=True)
    assert m.spans is None and all(r.status == "ok" for r in reqs)


# ---------------------------------------------------------------------------
# served calls
# ---------------------------------------------------------------------------

CASES = {"direct_blocking": dict(admission="blocking"),
         "direct_chunked": dict(admission="chunked", prefill_chunk=96),
         "offload_blocking": dict(admission="blocking", offload=True,
                                  cache_frac=0.3)}


@pytest.fixture(scope="module", params=list(CASES))
def served(request, model):
    """One case served with spans off and with spans on."""
    kw = CASES[request.param]
    return kw, _serve(model, **kw), _serve(model, spans=True, **kw)


def test_spans_leave_tokens_and_counters_unchanged(served):
    _, (_, off_reqs, off), (_, on_reqs, on) = served
    assert [r.out_tokens for r in on_reqs] == \
        [r.out_tokens for r in off_reqs]
    assert _counters(on) == _counters(off)
    assert off.spans is None and on.spans is not None
    assert spans._ACTIVE.get() is None


def test_spans_add_up(model, served):
    cfg = model[0]
    kw, _, (eng, reqs, m) = served
    sp = m.spans
    L, n = cfg.n_layers, len(reqs)
    assert sp.count("decode") == sp.count("harvest") == m.steps
    assert sp.count("first_token") >= 1 and sp.count("graft") == n
    assert sp.count("flush") == m.flushes >= 1
    admits = [s for s in sp.records if s.name == "admit"]
    if kw["admission"] == "blocking":
        assert len(admits) == n and sp.count("prefill") == n
        assert sorted(s.attrs["rid"] for s in admits) == list(range(n))
        assert sp.count("prefill.layer") == sp.count("prefill.attn") == \
            sp.count("prefill.index") == L * n
        # every prefill.layer opens inside a prefill inside an admit
        for s in sp.records:
            if s.name == "prefill.layer":
                up = sp.records[s.parent]
                assert up.name == "prefill"
                assert sp.records[up.parent].name == "admit"
    else:
        # one admit span a chunk; a request's chunks share its rid
        chunks = {}
        for s in admits:
            chunks.setdefault(s.attrs["rid"], []).append(s.attrs["tokens"])
        assert {rid: sum(t) for rid, t in chunks.items()} == \
            {i: p for i, (p, _) in enumerate(PROMPTS)}
        assert sp.count("chunk") == len(admits) and sp.count("fin") == n
    if eng.placement.offload:
        plane = eng.last_plane
        assert sp.count("admit_slot") == n
        assert sp.count("decode_step") == plane.counts["steps"] == m.steps
        for name in ("readback_ids", "translate", "stage",
                     "drain_admissions"):
            assert sp.count(name) == L * plane.counts["steps"], name
        assert sp.count("launch") == (L + 1) * m.steps
        layers = sp.totals(by="layer")
        assert {k[1] for k in layers if k[0] == "translate"} == set(range(L))
        assert sp.count("offload_flush") == sp.count("host_flush") == \
            m.flushes
    else:
        assert sp.count("decode_step") == 0 == sp.count("admit_slot")
    # the top-level spans are the scheduler's: nothing else opens outside
    top = {s.name for s in sp.records if s.parent == -1}
    assert top <= {"admit", "first_token", "decode", "harvest", "flush"}


def test_admission_spans_split_admit_slot(model, served):
    """Each offload admission's ``admit_slot`` holds one ``admit_copy`` (pack
    and device-to-host copy) and one ``admit_crc`` (checksums) a layer, in
    layer order; a direct call has neither."""
    cfg = model[0]
    kw, _, (eng, reqs, m) = served
    sp = m.spans
    if not eng.placement.offload:
        assert sp.count("admit_copy") == 0 == sp.count("admit_crc")
        return
    slots = [i for i, s in enumerate(sp.records) if s.name == "admit_slot"]
    assert len(slots) == len(reqs)
    for i in slots:
        inner = [(s.name, s.attrs["layer"]) for s in sp.records
                 if s.parent == i]
        assert inner == [(name, l) for l in range(cfg.n_layers)
                         for name in ("admit_copy", "admit_crc")]
    assert sp.seconds("admit_copy") + sp.seconds("admit_crc") <= \
        sp.seconds("admit_slot")
    # every store row checksummed by the native routine, none by zlib
    counts = eng.last_plane.counts
    assert counts["zlib_crc_rows"] == 0
    assert counts["native_crc_rows"] >= \
        len(reqs) * cfg.n_layers * eng.last_plane.H * eng.last_plane.M


@pytest.mark.parametrize("on", [False, True], ids=["spans_off", "spans_on"])
def test_span_names_on_the_profiler_host_timeline(model, on):
    """Spans on or off, a profiled call (short answers: no flush) carries
    the span names as host events (host ops, not user annotations), and
    records only while the profiler does."""
    cfg, params = model
    eng = ServeEngine(cfg, params, device="cpu", max_context=512,
                      admission="blocking", offload=True, cache_frac=0.3,
                      spans=on)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = eng.serve(_requests(cfg, [(300, 12), (200, 10), (260, 8)]), 2)
    host = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU:
            host[ev.name] = host.get(ev.name, 0) + 1
        assert not (ev.name == "translate" and ev.is_user_annotation)
    for name in ("admit", "prefill.layer", "prefill.attn", "prefill.index",
                 "admit_slot", "decode", "decode_step", "readback_ids",
                 "translate", "stage", "launch", "drain_admissions",
                 "harvest"):
        assert host.get(name, 0) >= 1, name
    assert host["decode"] == m.steps
    assert host["translate"] == cfg.n_layers * m.steps
    assert (m.spans is not None) == on


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("offload", [False, True], ids=["direct", "offload"])
def test_device_spans_resolve_on_the_card(cuda, model, offload):
    cfg = model[0]
    eng, reqs, m = _serve(model, device=cuda, spans=True,
                          admission="blocking", offload=offload)
    sp = m.spans
    dev = [s for s in sp.records if s.on_device]
    assert len(dev) == 3 * cfg.n_layers * len(reqs)
    assert all(s.device_s is not None and s.device_s > 0 for s in dev)
    assert not sp._pending
    assert sp.count("capture") == 1
    assert sp.self_seconds("prefill.layer") > 0
