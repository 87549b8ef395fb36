"""One run of one cell: set-up, the measured window, the per-layer readers
(``--trace 1``), the check, and the result line.

Set-up: the weights from the seed on the card, the engine with the cell's
arguments, and one warm-up ``serve`` at the cell's geometry (its batch,
pinned ``max_context``, impl, runtime, admission and store) with short
prompts, which builds the kernels and captures the decode graph once.
``setup_s`` runs from the process's start to the first measured call.

The window: whole ``ServeEngine.serve`` calls, each of the mix's batch
drawn from the seed and the call's number, one after another until
``--seconds`` have passed; it spans the first call's start to the last
call's end. End-to-end metrics are taken over all of it: every token
delivered over the wall time (``out_tok_s``), the pooled gaps between
deliveries (``itl_p95_ms``), the allocator's peak after a reset at the
window's start (``peak_mem_gib``). A name split by cell
(``out_tok_s.offload``) is its quantity's, under a bound of its own."""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from perfbench.lib import check, spec, traffic
from perfbench.lib import weights as W
from perfbench.roofline import bounds

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What the per-layer readers see."""
    name: str
    seed: int
    cfg: Any                        # the port's ModelConfig
    conf: Dict                      # the configuration file
    cell: Dict
    device: Any
    weights: Dict
    engine: Any = None
    plan: Optional[bounds.Plan] = None
    calls: List = field(default_factory=list)       # ServeMetrics per call
    requests: List = field(default_factory=list)    # every window request
    window_s: float = 0.0
    slice: Any = None               # trace.Slice of a --trace 1 run


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def build(name: str, seed: int, device, conf: Optional[Dict] = None,
          cell: Optional[Dict] = None) -> Run:
    """The cell's run object with its weights and engine (no serve yet).
    ``conf`` / ``cell`` replace the cell's files (tests)."""
    from repro_torch.serving.engine import ServeEngine
    bench = spec.benchmark()
    wl = spec.workload(bench, name)
    cell = cell or spec.cell(name)
    conf = conf or spec.config(wl["config"])
    cfg = spec.model_config(conf)
    eng = dict(cell["engine"])
    params = W.make(cfg, seed, device)
    engine = ServeEngine(cfg, params, device=device, **eng)
    plan = bounds.zone_plan(eng["max_context"], eng.get("gen_headroom", 1024),
                            bounds.retro_of(conf["wave_index"]))
    return Run(name=name, seed=seed, cfg=cfg, conf=conf, cell=cell,
               device=device, weights=params, engine=engine, plan=plan)


def free(engine) -> None:
    """Drop the engine's hold on the last call's state, graph and plane."""
    engine.last_state = engine.last_graph = engine.last_plane = None


def make_requests(batch):
    """The engine's requests for (prompt, answer length) pairs."""
    from repro_torch.serving.engine import Request
    return [Request(prompt=p, max_new_tokens=n) for p, n in batch]


def warm_up(run: Run) -> None:
    """One serve at the cell's geometry with short prompts: builds the
    kernels and warms the captured step."""
    wu = run.cell["warmup"]
    rng = np.random.default_rng([run.seed % 2**64, 1 << 20])
    batch = [(rng.integers(0, run.cfg.vocab, size=wu["prompt"],
                           dtype=np.int32), wu["output"])
             for _ in range(run.cell["batch"])]
    run.engine.serve(make_requests(batch), run.cell["batch"])
    free(run.engine)
    _sync(run.device)


def _sync(device) -> None:
    import torch
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()


def window(run: Run, mix: Dict, seconds: float) -> None:
    """Whole serve calls until ``seconds`` have passed."""
    t0 = time.perf_counter()
    call = 0
    while True:
        reqs = make_requests(traffic.call_requests(mix, run.cfg.vocab,
                                                   run.seed, call))
        run.calls.append(run.engine.serve(reqs, run.cell["batch"]))
        run.requests.extend(reqs)
        free(run.engine)
        call += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(run.device)
    run.window_s = time.perf_counter() - t0


def end_to_end(run: Run, peak_bytes: int, setup_s: float) -> Dict[str, float]:
    steps = [s for m in run.calls for s in m.step_s]
    out_tok_s = sum(m.tokens_out for m in run.calls) / run.window_s
    return {"out_tok_s": out_tok_s,
            "itl_p95_ms": float(np.percentile(steps, 95)) * 1e3,
            "peak_mem_gib": peak_bytes / 2**30,
            "setup_s": setup_s}


def breakdown(sl) -> Dict:
    return {"device_ops": [[n, s] for n, s in sl.ops[:10]],
            "idle_gaps": [[n, s] for n, s in sl.gaps[:10]]}


def retro_args(run: Run) -> Optional[Dict]:
    """The reference's wave-index arguments for the cell's zone plan (None
    for a runtime without the index)."""
    if run.cell["engine"]["runtime"] != "retro":
        return None
    return {"r": run.plan.r, "e": run.plan.e}


def judge(run: Run, precision: str = "f32") -> Dict:
    """The check's numbers, after the engine's state is freed.
    ``precision`` "fp8": the control's (``control.py``), through the same
    sample, number and limit."""
    ref = spec.reference(run.conf["reference"])
    idx = check.sample(run.requests, run.seed, run.cell["check"]["sample"])
    c = run.cell["check"]
    g = check.gaps(ref, run.weights, run.conf, run.requests, idx,
                   run.device, precision=precision, retro=retro_args(run),
                   router_margin=c.get("router_margin", 0.0))
    print(f"perfbench: {precision} gaps over the sample: widest {g['widest']!r}, mean "
          f"{g['mean']!r}, share of positions left out {g['left_out']!r}",
          file=sys.stderr)
    return check.checks(g[c["number"]], c["number"], c["logit_gap_limit"],
                        check.unfinished(run.requests))


def execute(name: str, seed: int, seconds: float, trace: bool, t_start: float,
            device="cuda", conf=None, cell=None, mix=None) -> Dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, optionally ``breakdown``, and
    ``checks``). ``conf``, ``cell`` and ``mix`` replace the cell's files,
    for tests on the CPU at a small size."""
    import torch
    from perfbench.lib.trace import Slicer
    bench = spec.benchmark()
    wl = spec.workload(bench, name)
    mix = mix or spec.traffic(wl["traffic"])
    cuda = torch.device(device).type == "cuda"
    run = build(name, seed, device, conf, cell)
    warm_up(run)
    setup_s = time.perf_counter() - t_start
    wi = run.conf["wave_index"]
    slicer = Slicer(local=wi["local"], update_segment=wi["update_segment"]) \
        if trace and cuda else None
    if slicer:
        slicer.install()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        window(run, mix, seconds)
    finally:
        if slicer:
            slicer.uninstall()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.slice = slicer.result if slicer else None
    if trace:
        wanted = spec.metrics(bench, "per_layer", name)
        if cuda and run.slice is None:
            raise RuntimeError(f"no profiled slice recorded a device kernel "
                               f"({slicer.tries} tries)")
        values = {m["name"]: spec.reader(m["name"])(run) for m in wanted}
    else:
        wanted = spec.metrics(bench, "end_to_end", name)
        e2e = end_to_end(run, peak, setup_s)
        values = {m["name"]: e2e[spec.base(m["name"])] for m in wanted}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values[m["name"]] is not None}
    free(run.engine)
    run.engine = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judge(run)
    print(f"perfbench: setup {setup_s:.1f} s, window {run.window_s:.1f} s "
          f"({len(run.calls)} calls), check "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    failed = sum(1 for r in run.requests if r.status != "ok")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": check.passed(numbers), "attempted": len(run.requests),
           "failed": failed, "metrics": metrics, "device": dev}
    if run.slice is not None:
        dev["busy_s"] = run.slice.busy_s
        dev["window_s"] = run.slice.window_s
        out["breakdown"] = breakdown(run.slice)
    out["checks"] = numbers
    return out


def main(args, t_start: float) -> int:
    import torch
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: {args.workload} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 3
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
