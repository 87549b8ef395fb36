"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from ``src/repro_torch`` (nvcc,
   sm_90a) and times the build;
2. holds the paged wave-attention kernel against its plain PyTorch twin on
   the card, at full-width gemma2-2b decode shapes and on edge cases;
3. serves full-width gemma2-2b (bf16, random weights from a seed) through
   ``ServeEngine`` — chunked admission, the wave index, decode through the
   kernel and a decode-time flush — and checks the kernel launch count;
   then checks the kernel against its twin on inputs captured from one
   local-layer and one global-layer launch of that run;
4. checks the reduced model's logits on the card against the same model
   run on the CPU (plain twin).

Prints the card's name and power limit, one JSON line of kernel results and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
if there is no CUDA card or any phase fails. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SRC = "src/repro_torch/kernels/wave_attention/csrc/paged_wave_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/wave_attention/kernel.py:307"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, f32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# kernel vs twin
# ---------------------------------------------------------------------------

def compare(name, args, softcap, *, time_it=False):
    """Kernel vs twin on the card. Returns a result dict; raises on breach."""
    import torch
    from repro_torch.kernels.wave_attention import ops
    out = ops.paged_wave_attention(*args, softcap=softcap)
    ref = ops.paged_wave_attention_plain(*args, softcap=softcap)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (out - ref).abs().max().item()
    tol = 2e-5 * (1.0 + ref.abs().max().item())
    res = dict(case=name, max_abs_err=err, tol=tol)
    if time_it:
        res["ms"] = time_ms(lambda: ops.paged_wave_attention(
            *args, softcap=softcap))
        res["plain_ms"] = time_ms(lambda: ops.paged_wave_attention_plain(
            *args, softcap=softcap))
    log(f"  {name}: max|d| {err:.3e} tol {tol:.3e}"
        + (f"  kernel {res['ms']:.4f} ms  twin {res['plain_ms']:.4f} ms"
           if time_it else ""))
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with twin: "
                             f"{err} > {tol}")
    return res


def time_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` calls, each timed with CUDA
    events after writing 128 MiB so the call finds L2 cold, as in decode."""
    import torch
    scrub = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        scrub.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def kernel_bound(args):
    """Least time on an H100 for this call's work: bytes that must move
    (inputs read once, output written once; K/V rows only where the
    position passes the mask, pos entries of the local buffer and of live
    clusters) over HBM bandwidth, vs f32 flops over the f32 peak."""
    import torch
    from repro_torch.kernels.wave_attention.ops import ARG_NAMES
    a = dict(zip(ARG_NAMES, args))
    B, H, G, hd = a["qg"].shape
    lo = a["rowb"][..., 0:1].long()
    hi = a["rowb"][..., 1:2].long()

    def ok(pos):
        pos = pos.long()
        return (pos >= 0) & (pos <= hi) & (pos > lo)

    S = a["sink_k"].shape[2]
    sink_pos = torch.arange(S, device=lo.device).expand(B, H, S)
    n_tok = ok(sink_pos).sum() + ok(a["local_pos"]).sum()
    live = a["live"] > 0
    idx = a["idx_r"].long()
    cpos = torch.gather(a["pos_store"], 2, idx[..., None].expand(
        idx.shape + (a["pos_store"].shape[-1],)))            # (B,H,r,cap)
    cl = ok(cpos.reshape(B, H, -1)).reshape(cpos.shape) & live[..., None]
    n_tok = int((n_tok + cl.sum()).item())
    esz = a["k_store"].element_size()
    E = a["vs_e"].shape[2]
    nbytes = (n_tok * 2 * hd * esz                      # K and V rows
              + a["local_pos"].numel() * 4
              + int(live.sum().item()) * cpos.shape[-1] * 4
              + (a["idx_r"].numel() + a["live"].numel()
                 + a["rowb"].numel()) * 4
              + a["qg"].numel() * 4 + 2 * B * H * G * E * 4
              + B * H * E * hd * 4 + B * H * G * hd * 4)   # out
    flops = n_tok * 4 * G * hd + B * H * G * E * 2 * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_cases(full=True):
    """(name, kwargs of ``ref.random_decode_inputs``, softcap) of the
    synthetic cases. ``full``: gemma2-2b decode shapes; else tiny ones."""
    geo = {} if full else dict(H=2, hd=32, M=64, cap=16, lbuf=160, r=3, e=10,
                               q_pos=(900, 600), local_len=(40, 160))
    w, cap = 4096.0, 50.0
    ragged = dict(q_pos=(16500, 3000), local_len=(1, 64)) if full else \
        dict(q_pos=(900, 300), local_len=(1, 20))
    return [
        ("full_width_global_bf16", dict(geo), cap),
        ("window_4096", dict(geo, window=w), cap),
        ("softcap_off", dict(geo, window=w), None),
        ("f32_stores", dict(geo, dtype="float32"), cap),
        ("live_zeros", dict(geo, live_frac=0.5, seed=1), cap),
        ("r0_dead_slot", dict(geo, r0=True, seed=2), cap),
        ("e0_overflow_only", dict(geo, e=0, seed=3), cap),
        ("no_estimation", dict(geo, e=0, overflow=False, seed=4), cap),
        ("ragged_rows_window", dict(geo, window=w, seed=5, **ragged), cap),
        ("G8", dict(geo, G=8, H=2, seed=6), cap),
    ]


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

class Capture:
    """Stands in for the ops module inside ``core.attention`` during the
    serve run: forwards every call to the real wrapper and keeps a clone of
    the arguments of one local-layer and one global-layer launch, taken when
    every row holds a real context."""

    def __init__(self, ops, n_layers, kinds, min_pos):
        self.ops, self.n_layers, self.kinds = ops, n_layers, kinds
        self.min_pos = min_pos
        self.rowb = ops.ARG_NAMES.index("rowb")
        self.calls = 0
        self.taken = {}

    def paged_wave_attention(self, *args, softcap=None):
        layer = self.calls % self.n_layers
        self.calls += 1
        kind = self.kinds[layer]
        if kind not in self.taken and \
                int(args[self.rowb][..., 1].min()) >= self.min_pos:
            self.taken[kind] = (layer, [a.clone() for a in args], softcap)
        return self.ops.paged_wave_attention(*args, softcap=softcap)


def serve_main_path(cfg, prompt_lens, new_tokens, *, chunk=256, batch=2,
                    device="cuda", seed=0, min_capture_pos=4096):
    """Drive the port's main path: ServeEngine with chunked admission."""
    import numpy as np
    import torch
    from repro_torch.core import attention
    from repro_torch.core.wave_index import prefill_layout
    from repro_torch.kernels.wave_attention import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServeEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, gen, device)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"  params: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in zip(prompt_lens, new_tokens)]
    engine = ServeEngine(cfg, params, prefill_chunk=chunk, device=device)
    cap = Capture(ops, cfg.n_layers, cfg.layer_kinds(), min_capture_pos)
    real_ops = attention.wa_ops
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.paged_wave_attention.launches = 0          # count the main path only
    attention.wa_ops = cap
    try:
        t0 = time.perf_counter()
        m = engine.serve(reqs, batch_size=batch)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attention.wa_ops = real_ops
    launches = ops.paged_wave_attention.launches
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # --- what came out ---
    if launches != cfg.n_layers * m.steps:
        raise AssertionError(f"{launches} kernel launches for {m.steps} "
                             f"decode steps x {cfg.n_layers} layers")
    if m.flushes < 1:
        raise AssertionError("no decode-time flush ran")
    retro = cfg.retro
    kv = engine.last_state.kv
    for r in reqs:
        n = len(r.out_tokens)
        if n != r.max_new_tokens or r.status != "ok":
            raise AssertionError(f"request produced {n}/{r.max_new_tokens} "
                                 f"tokens ({r.status})")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError("token id outside the vocabulary")
    last = {}
    for r in reqs:                       # the request each slot ended with
        last[r.slot] = r
    for slot, r in last.items():
        L, n = len(r.prompt), r.max_new_tokens
        want_len = L + n
        want_clusters = prefill_layout(L, retro)[2] + \
            (n // retro.update_segment) * (retro.update_segment
                                           // retro.avg_cluster)
        for st in kv:
            got_len = int(st.length[slot])
            got_cl = int(st.n_clusters[slot])
            if got_len != want_len or got_cl != want_clusters:
                raise AssertionError(
                    f"slot {slot}: length {got_len} (want {want_len}), "
                    f"clusters {got_cl} (want {want_clusters})")
    res = dict(wall_s=wall, steps=m.steps, launches=launches,
               flushes=m.flushes, tokens_out=m.tokens_out,
               prefill_tokens=m.prefill_tokens, prefill_s=m.prefill_s,
               prefill_tps=m.prefill_tps, decode_s=m.decode_s,
               decode_tps=m.decode_tps, ttft_s=[r.ttft_s for r in reqs],
               itl_p50_ms=m.itl_p50_s * 1e3, itl_p99_ms=m.itl_p99_s * 1e3,
               peak_mem_gib=peak / 2**30)
    return res, cap.taken, engine


def decode_breakdown(engine, max_ctx, steps=8):
    """Where one decode step's time goes, on the state the serve run left
    (both slots active): host time to enqueue a step, wall time of a synced
    step, and the device kernel time by name over ``steps`` steps from
    ``torch.profiler`` (device busy share = kernel time / wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    cfg, state = engine.cfg, engine.last_state
    B = state.kv[0].length.shape[0]
    plan = plan_zones(max_ctx, cfg.retro, engine.gen_headroom)
    tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
    act = torch.ones((B,), dtype=torch.bool, device="cuda")

    def step(st):
        lg, st = M.apply_decode(engine.params, cfg, st, tok, plan=plan,
                                active=act)
        return lg.argmax(-1), st

    with torch.inference_mode():
        for _ in range(2):
            _, state = step(state)
        torch.cuda.synchronize()
        enq, wall = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            _, state = step(state)
            enq.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                _, state = step(state)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    # device kernels only: an aten op's row repeats the time of the kernels
    # it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0) or \
            getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(ev, "device_type", None) == cuda:
            rows.append((dev_us, ev.key, ev.count))
    if not rows:
        raise AssertionError("profiler saw no device kernels")
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    res = dict(enqueue_ms=1e3 * sum(enq) / steps,
               step_wall_ms=1e3 * sum(wall) / steps,
               profiled_step_ms=1e3 * prof_wall / steps,
               device_busy_ms=1e3 * busy_s / steps,
               device_busy_share=busy_s / prof_wall,
               top_kernels=[dict(name=k[:90], ms_per_step=us / 1e3 / steps,
                                 calls_per_step=c / steps)
                            for us, k, c in rows[:10]])
    log(f"  decode step (B={B}): host enqueue {res['enqueue_ms']:.2f} ms, "
        f"synced wall {res['step_wall_ms']:.2f} ms, device busy "
        f"{res['device_busy_ms']:.2f} ms ({100 * res['device_busy_share']:.1f}%"
        f" of the profiled wall)")
    for k in res["top_kernels"]:
        log(f"    {k['ms_per_step']:8.3f} ms/step {k['calls_per_step']:6.1f} "
            f"calls  {k['name']}")
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "numel"):
        yield tree


def reduced_across_devices(seed=0, device="cuda"):
    """The reduced model on the card (kernel) vs on the CPU (twin): chunked
    prefill of two ragged prompts then six decode steps; logits agree."""
    import numpy as np
    import torch
    from repro_torch.configs.gemma2_2b import reduced
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    cfg = reduced()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
        else [to(v) for v in t] if isinstance(t, list) \
        else t.to(device) if hasattr(t, "to") else t
    runs = {}
    rng = np.random.default_rng(seed)
    lens = np.array([300, 200], np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 320)).astype(np.int64)
    steps = rng.integers(0, cfg.vocab, (6, 2)).astype(np.int64)
    plan = plan_zones(320, cfg.retro, 256)
    for dev, params in (("cpu", cpu), (device, to(cpu))):
        cs = M.make_prefill_chunk_state(cfg, 2, 320, chunk=64,
                                        gen_headroom=256, device=dev)
        for c0 in range(0, 320, 64):
            cl = torch.from_numpy(np.clip(lens - c0, 0, 64)).to(dev)
            _, cs = M.apply_prefill_chunk(
                params, cfg, {"tokens": torch.from_numpy(toks[:, c0:c0 + 64])
                              .to(dev)}, cs, chunk_lens=cl)
        # rows finalize at their own length: finalize each row separately
        logits = []
        for b in range(2):
            row = type(cs)(cache=[c._replace(k=c.k[b:b + 1], v=c.v[b:b + 1],
                                             length=c.length[b:b + 1])
                                  for c in cs.cache],
                           wave=[_row_cp(w, b) for w in cs.wave])
            st = M.finalize_prefill_chunk(cfg, row, total_len=int(lens[b]))
            for t in range(6):
                lg, st = M.apply_decode(params, cfg, st, torch.from_numpy(
                    steps[t, b:b + 1]).to(dev), plan=plan)
                logits.append(lg.float().cpu())
        runs[dev] = torch.stack(logits)
    err = (runs[device] - runs["cpu"]).abs().max().item()
    log(f"  reduced gemma2-2b, card vs cpu logits: max|d| {err:.3e} "
        f"(tol 1e-3)")
    if not torch.isfinite(runs[device]).all() or err > 1e-3:
        raise AssertionError(f"reduced model disagrees across devices: {err}")
    return err


def _row_cp(cp, b):
    st = cp.state
    return cp._replace(
        state=type(st)(*(t[b:b + 1] for t in st)),
        stage_k=cp.stage_k[b:b + 1], stage_v=cp.stage_v[b:b + 1],
        staged=cp.staged[b:b + 1], seen=cp.seen[b:b + 1])


def main(argv=None):
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every result (cases, serve, decode "
                         "breakdown) to this file")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gemma2_2b import CONFIG
    from repro_torch.kernels import build
    from repro_torch.kernels.wave_attention.ref import random_decode_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 1: build ----------------------------------------------------
    log("phase 1: build")
    t0 = time.perf_counter()
    recs = build.build([ROOT / KERNEL_SRC])
    build_s = time.perf_counter() - t0
    for rec in recs:
        log(f"  {Path(rec['source']).name}: {rec['seconds']:.1f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())
    log(f"  build total {build_s:.1f} s")

    # ---- phase 2: kernel vs twin on synthetic full-width cases -------------
    log("phase 2: kernel vs plain twin (full-width decode shapes)")
    results = []
    for name, kw, softcap in edge_cases():
        args = random_decode_inputs(device="cuda", **kw)
        results.append(compare(name, args, softcap,
                               time_it=name == "full_width_global_bf16"))
        del args
    torch.cuda.empty_cache()

    # ---- phase 3: serve full-width gemma2-2b --------------------------------
    log("phase 3: serve gemma2-2b at full width (bf16, random weights)")
    prompt_lens = (16384, 12288, 9000, 16384)
    new_tokens = (1100, 48, 32, 64)
    serve, taken, engine = serve_main_path(CONFIG, prompt_lens, new_tokens)
    launches = serve["launches"]
    log(f"  decode steps {serve['steps']}, kernel launches {launches} "
        f"(= {CONFIG.n_layers} x steps), flushes {serve['flushes']}")
    log(f"  TTFT s {['%.3f' % t for t in serve['ttft_s']]}; prefill "
        f"{serve['prefill_tps']:.1f} tok/s; decode {serve['decode_tps']:.2f} "
        f"tok/s; ITL p50/p99 {serve['itl_p50_ms']:.2f}/"
        f"{serve['itl_p99_ms']:.2f} ms; peak mem "
        f"{serve['peak_mem_gib']:.2f} GiB; wall {serve['wall_s']:.1f} s")
    if set(taken) != {"l", "g"}:
        raise AssertionError(f"captured launches {sorted(taken)}")
    main_path = {}
    for kind, label in (("l", "captured_local_layer"),
                        ("g", "captured_global_layer")):
        layer, args, softcap = taken[kind]
        res = compare(f"{label}_{layer}", args, softcap, time_it=True)
        res["bound_ms"], res["bound_by"] = kernel_bound(args)
        log(f"    bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        main_path[kind] = res
        results.append(res)
    del taken
    log("  decode-step breakdown (after the run, both slots decoding)")
    breakdown = decode_breakdown(engine, max(prompt_lens))
    del engine
    torch.cuda.empty_cache()

    # ---- phase 4: reduced model, card vs cpu --------------------------------
    log("phase 4: reduced model on the card vs the CPU")
    red_err = reduced_across_devices()

    # the kernel line: times and bound at the main path's global-layer
    # launch; the error of the case nearest its tolerance, beside that tol
    g = main_path["g"]
    worst = max(results, key=lambda r: r["max_abs_err"] / r["tol"])
    kern = dict(name="paged_wave_attention", route="cuda", source=KERNEL_SRC,
                replaces=KERNEL_REPLACES, launches=launches,
                max_abs_err=worst["max_abs_err"],
                max_err=worst["max_abs_err"], tol=worst["tol"],
                worst_case=worst["case"],
                ms=g["ms"], kernel_ms=g["ms"], plain_ms=g["plain_ms"],
                bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                library_ms=None)
    if opts.json is not None:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        opts.json.write_text(json.dumps(dict(
            card=card, build_s=build_s, cases=results, serve=serve,
            decode_breakdown=breakdown,
            reduced_card_vs_cpu_err=red_err, kernels=[kern]), indent=1))
    log(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
