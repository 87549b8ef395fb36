"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from ``src/repro_torch`` (nvcc,
   sm_90a, one process per source, all at once) and times the build;
2. holds the paged wave-attention kernel against its plain PyTorch twin on
   the card, at full-width gemma2-2b decode shapes and on edge cases;
2b. holds the gathered-buffer wave-attention kernel, the block gather and
   the k-means step against their twins on full-width synthetic cases;
   for the k-means step also: two calls give the same bits, the sums equal
   the point-order sums over its own assignments, its split by device
   kernel, its 3xTF32 and f32 bounds, and the main path's plain Lloyd loop
   (``core/clustering.py::spherical_kmeans``) timed beside the op's loop;
2c. holds both attention kernels against their twins at the decode shapes
   of minitron-8b (8 KV heads, G 4, hd 128), gemma3-1b (one KV head,
   G 4, hd 256, window 512), mixtral-8x22b (G 6, hd 128, window 4096),
   llava-next-34b (G 7, hd 128) and kimi-k2 (G 8, hd 128), the last three
   timed, with their bounds and device durations;
2d. holds the prefill attention kernel (blocking admission's causal
   attention) against its twin at mistral-7b's (T 16384, G 4) and
   mixtral-8x22b's (T 4096, G 6) admission shapes, and at k-exaone's
   (T 16384, G 8) for its sliding layers (window 128) and its global ones,
   and times it beside the twin, ``scaled_dot_product_attention`` and its
   bound;
3. serves full-width gemma2-2b (bf16, random weights from a seed) through
   ``ServeEngine(attn_impl="fused")`` — chunked admission, the wave index,
   decode through the paged kernel and a decode-time flush — and checks the
   kernel launch count; then checks the kernel against its twin on inputs
   captured from one local-layer and one global-layer launch of that run;
4. checks the reduced model's logits on the card against the same model
   run on the CPU (plain twins), for the "fused" and "pallas" impls, for
   blocking admission, and for ``runtime="full"`` (chunked and blocking);
5. serves full-width gemma2-2b through ``ServeEngine(attn_impl="pallas")``
   (the gathered-buffer kernel), checks its launch count, holds the kernel
   and the block gather against their twins on captured launches, and
   compares the three impls' attention on the state the run leaves; then
   profiles one decode step of that path;
6. serves full-width gemma2-2b with its cluster stores in host memory
   (``ServeEngine(offload=True, attn_impl="fused")``: the paged kernel reads
   a device block cache of C + r slots through cache-slot ids) through the
   compiled offload stage (``OffloadStage``: one capture, then L + 1 graphs
   replayed a step with the host control plane between them), checks one
   capture and a replay for every later step, its launch count, sizes and
   counters, holds the kernel against its twin on a captured launch, runs
   the offload (replayed) and the direct decode from one admitted state
   (logits within the bf16 tolerance, see ``offload_vs_direct``), breaks
   one offload decode step down eagerly and replayed in one call
   (``offload_breakdown``: id wait, translate, H2D staging, launch, drain,
   synced wall, device busy, bytes to the device) and profiles one
   replayed step (2 x 26 attention launches); then runs phase 10's
   offload part on its state; then reduced gemma2-2b offload under a
   seeded fault profile on the card and on the CPU (same tokens and
   counters, logits within 1e-3);
7. serves full-width gemma2-2b with blocking admission
   (``ServeEngine(admission="blocking")``: one prefill per request, the
   wave index built by ``prefill_build``) through the paged kernel, checks
   ``prefill_build`` against the chunked builder bit for bit on the card,
   blocking against chunked first-token logits (the same greedy token in
   bf16; within 1e-3 (1 + |chunked|) in f32), and serves one request
   through block-sparse prefill (logits correlated with dense);
8. serves full-width gemma2-2b through ``runtime="full"`` (a dense KV cache
   and exact attention, the paper's comparator), chunked and blocking:
   no kernel launches, every layer's ``full_attention_decode`` against an
   f32 softmax, the decode-step breakdown, and the end-to-end numbers of
   every served path side by side;
9. serves full-width minitron-8b (hd 128, G 4, untied head) through the
   paged kernel, checks its launch count and lengths, and times a captured
   launch against its bound;
10. holds the compiled decode stage at gemma2-2b's full width: for
   "fused", "pallas", "jnp" and ``runtime="full"``, eager steps and
   replays of the captured step from one state give the same logits bits
   and ids, and a profiled replay launches 2 x 26 attention kernels; its
   offload part (run in phase 6, on the state the offload serve left): for
   offload "fused", "pallas" and "jnp", 8 eager steps and 8 steps of a
   capturing plane (1 warm-up + 7 replays) from one copied state and one
   copied host plane give the same logits bits, ids and counters, and a
   profiled replayed step launches 2 x 26 attention kernels (0 for jnp);
11. serves mixtral-8x22b at full published width (8 experts top-2,
   d_expert 16384, G 6, window 4096), depth cut 56 -> 8 layers, through
   the paged kernel with chunked and then blocking admission (prompts of
   16384 and 9000 tokens), times a captured launch against its bound,
   breaks a decode step down (eager vs replay) with the MoE FFN's device
   time per step (``moe_ffn_step``), holds replay == eager bit for bit for
   "fused" and "pallas", and the reduced model card vs CPU;
12. serves llava-next-34b at full published width (G 7), depth cut 60 ->
   16 layers, with 2880 seeded bf16 patch embeddings a request
   (``Request.extra``), chunked and blocking through the paged kernel and
   one request through the gathered-buffer kernel, and holds blocking
   against chunked first-token logits as phase 7 does;
13. serves kimi-k2 at full published width (384 experts top-8, G 8,
   vocab 163840), depth cut 61 -> 1 layer (the expert weights drawn one
   expert at a time), one 4096-token prompt through the paged kernel, the
   MoE FFN's device time per step, and the reduced model card vs CPU;
14. serves zamba2-1.2b at published width and depth (38 mamba2 layers,
   the shared attention block after every 6th: 6 sites, each with its own
   wave index; MHA, G 1, hd 64) with blocking admission, the family's
   only: prompts of 8192 and 6000 tokens through the paged kernel, one
   8192-token request through the gathered-buffer kernel, both under
   ``runtime="full"``; launches = 6 sites x steps; both kernels against
   their twins on a captured site launch (bound, device duration); the
   decode breakdown; replay == eager bit for bit for "fused" and
   "pallas"; the reduced model card vs CPU;
15. serves rwkv6-3b at published width and depth (32 layers,
   attention-free) with blocking admission (4096 / 3000 tokens): no
   attention launch, the breakdown, replay == eager, reduced card vs CPU;
16. serves whisper-tiny at published width and depth (4 + 4 layers over
   1500 seeded bf16 stub frames a request; G 1, hd 64) with 448- and
   300-token decoder prompts through the paged kernel and under
   ``runtime="full"``: launches = 4 layers x steps, a captured launch
   against the twin, the breakdown, replay == eager, reduced card vs CPU;
17. trains: reduced gemma2-2b in f32 on the card against the CPU (loss,
   every grad leaf, one AdamW step of the same grads) and a checkpoint
   round trip bit for bit; gemma2-2b at full width and depth in bf16,
   8 steps of ``train`` at B 2 x T 1024 (loss and grad norm finite every
   step; synced ms a step, tokens/s, the loss curve, peak memory beside
   its reckoning and the step beside its compute bound); one step of
   zamba2-1.2b at full width (T 512: the chunked remat of the scan). No
   hand-written kernel runs: attention is ``flash_attention_jnp`` in plain
   torch, as in the reference, which has no backward kernel;
18. serves full-width gemma2-2b through the paged kernel at temperature
   0.7 (blocking admission, 8192 / 6000 tokens generating 32 / 24): the
   main path's checks, the captured sampled step replayed equal to eager
   with the generator rewound, one seed twice the same tokens, and
   ``temperature=0`` the greedy engine's tokens;
19. drives the step functions of ``serving/steps.py`` on full-width
   gemma2-2b through the paged kernel: ``make_step``'s prefill step at
   B 1 x T 8192, 16 decode steps through ``make_serve_step`` and, from a
   copy of that state on the same tokens, through ``make_serve_step_split``
   (logits within 1e-4, the cold tensors bit for bit unchanged, 26 x 16
   paged launches each, both paths' synced ms per step), one train step at
   B 1 x T 1024, and the dry-run of gemma2-2b x decode_32k on one H100
   traced on the host's CPU;
20. runs sharded retrieval on one global layer of gemma2-9b (Hkv 8, G 2,
   hd 256, softcap 50, bf16, B 1) over two gloo ranks spawned on cuda:0,
   each holding its ``shard_state`` half of the clusters: at 16384 tokens
   with full coverage against the serial path within 1e-4; at 524288
   tokens (clustered keys, the default plan) its error against full
   attention within 2x the serial path's plus 1e-3; the fused serial
   path there against itself with the paged kernel's plain twin (the
   kernel tolerance) and against the "jnp" path (bf16 bound); then
   perfcmp's three modes timed on the card;
21. runs the port's retrolint on the card (``run_lint``): the static passes
   over the shipped tree, the stage contract pass over two serves of
   full-width gemma2-2b through the paged kernel (chunked + offload,
   blocking + direct; prompts of 4096 and 3000 tokens, 8 new tokens: one
   real capture per captured stage, RL101/RL102 on stages that ran the
   kernel) and the numerics pass on CUDA tensors with the kernels launched;
   prints ``{"lint": {...}}`` (errors, advice, inventory size, captures per
   stage, seconds); any lint error fails the run.

Every serve run above decodes through ``ServeEngine``'s compiled stages:
the first step of the run eagerly, the rest as replays of one captured
CUDA graph (direct store) or of L + 1 captured graphs (offload)
(``serving/graphs.py``). A wrapper's launch count
sees the warm-up's launches and the capture's recorded ones, not a
replay's: the script counts the calls made during capture (``LaunchTap``),
adds them once per replay, checks one capture per run, and profiles one
more replay to see the card launch that many. Each decode-step breakdown
reports, in one call and from one state, the step run eagerly, replayed,
and replayed from a capture with torch's fused gelu/silu (the MLP before
the bf16 repair; phase 8 also the full runtime's old formulation, the
cache upcast to f32, eagerly), each over 4 profiled steps; after phase 7
the state's layout is compared with phase 3's.

Each attention kernel call is two launches (split, combine); on every
captured launch the script prints the split grid (rows x splits), checks
that two calls give the same bits, and times the wrapper's host work.

Prints the card's name and power limit, one JSON line of kernel results and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
if there is no CUDA card or any phase fails. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "paged_wave_attention": (
        "src/repro_torch/kernels/wave_attention/csrc/paged_wave_attention.cu",
        "src/repro/kernels/wave_attention/kernel.py:307"),
    "wave_attention_merge": (
        "src/repro_torch/kernels/wave_attention/csrc/wave_attention.cu",
        "src/repro/kernels/wave_attention/kernel.py:91"),
    "block_gather": (
        "src/repro_torch/kernels/gather/csrc/block_gather.cu",
        "src/repro/kernels/gather/kernel.py:22"),
    "kmeans_step": (
        "src/repro_torch/kernels/kmeans/csrc/kmeans_step.cu",
        "src/repro/kernels/kmeans/kernel.py:36"),
}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, f32 outside the tensor cores
TF32_FLOPS = 495e12                # H100 SXM, TF32 tensor cores, dense
SPIN_CYCLES = 4_000_000            # ~2 ms at the H100's 1.98 GHz boost clock


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# kernel vs twin
# ---------------------------------------------------------------------------

def compare(name, args, softcap, *, op="paged_wave_attention", time_it=False):
    """An attention kernel (``op``, a wrapper in the wave-attention ops) vs
    its twin on the card. Returns a result dict; raises on breach."""
    import torch
    from repro_torch.kernels.wave_attention import ops
    kern, plain = getattr(ops, op), getattr(ops, op + "_plain")
    out = kern(*args, softcap=softcap)
    ref = plain(*args, softcap=softcap)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (out - ref).abs().max().item()
    tol = 2e-5 * (1.0 + ref.abs().max().item())
    again = kern(*args, softcap=softcap)
    grid = getattr(ops, GRID[op])(*args)
    res = dict(case=name, max_abs_err=err, tol=tol,
               bit_identical=bool(torch.equal(out, again)),
               grid=f"{grid['rows']} x {grid['splits']}",
               tiles_per_split=grid["tiles_per_split"])
    if time_it:
        res["ms"] = time_ms(lambda: kern(*args, softcap=softcap))
        res["plain_ms"] = time_ms(lambda: plain(*args, softcap=softcap))
        res["host_us_per_call"] = host_us(lambda: kern(*args,
                                                       softcap=softcap))
    log(f"  {name}: max|d| {err:.3e} tol {tol:.3e}  grid {res['grid']} "
        f"(rows x splits, {grid['tiles_per_split']} tile(s) per split)"
        + (f"  kernel {res['ms']:.4f} ms  twin {res['plain_ms']:.4f} ms  "
           f"host {res['host_us_per_call']:.1f} us per call" if time_it
           else ""))
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with twin: "
                             f"{err} > {tol}")
    if not res["bit_identical"]:
        raise AssertionError(f"{name}: two kernel calls on the same inputs "
                             f"gave different bits")
    return res


GRID = {"paged_wave_attention": "paged_grid",
        "wave_attention_merge": "merge_grid"}


def host_us(fn, reps=200):
    """Mean host time of ``fn`` in microseconds over ``reps`` calls, not
    synced: what the wrapper costs the host per call (checks, views,
    allocations, the ctypes call and its launches)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def time_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` calls, each timed with CUDA
    events after writing 128 MiB so the call finds L2 cold, as in decode.
    The card then spins for ~2 ms (``torch.cuda._sleep``) while the host
    enqueues the call, so a call whose device work is shorter than its host
    work (a small kernel behind a ctypes wrapper) is timed on the device and
    not at the host's pace."""
    import torch
    scrub = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        scrub.fill_(1.0)
        torch.cuda._sleep(SPIN_CYCLES)
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
    return bound(nbytes, flops)


def bound(nbytes, flops):
    """(least time in ms on an H100, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def merge_bound(args):
    """Gathered-buffer merge: the K/V rows that pass the mask, the mask, q,
    the estimation inputs and the output; f32 flops over those rows and the
    estimation zone."""
    qg, k, _, valid, est_logit, cs_e, vs_e = args
    B, H, G, hd = qg.shape
    E = vs_e.shape[2]
    n_tok = int(valid.sum().item())
    nbytes = (n_tok * 2 * hd * k.element_size()
              + _nbytes(valid, qg, est_logit, cs_e, vs_e)
              + B * H * G * hd * 4)                             # out
    return bound(nbytes, n_tok * 4 * G * hd + B * H * G * E * 2 * hd)


BOUNDS = {"paged_wave_attention": kernel_bound,
          "wave_attention_merge": merge_bound}


def gather_bound(idx, k_store):
    """Block gather: read and write the r (cap, hd) blocks of K and V."""
    B, H, r = idx.shape
    blk = k_store.shape[3] * k_store.shape[4] * k_store.element_size()
    return bound(2 * 2 * B * H * r * blk + _nbytes(idx), 0)


def kmeans_bound(x, cent):
    """One k-means step; x and the centroids read, sums, counts and
    assignments written. Returns (ms, bound_by, f32 ms): the bound of the
    arithmetic the kernel runs, the similarity's 2 n k d per segment three
    times over in TF32 (3xTF32) at the tensor cores' peak, or the bytes,
    whichever is larger ("operations (3xTF32)" or "bytes"); and beside it
    the f32 bound, every flop (similarity, the sums' n d adds, the
    normalisation's 3 k d) at the f32 peak outside the tensor cores."""
    S, n, d = x.shape
    k = cent.shape[1]
    nbytes = _nbytes(x, cent) + S * (k * d + k + n) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * S * 2 * n * k * d / TF32_FLOPS * 1e3
    f32_ms, _ = bound(nbytes, S * (2 * n * k * d + n * d + 3 * k * d))
    if t_tc >= t_bytes:
        return t_tc, "operations (3xTF32)", f32_ms
    return t_bytes, "bytes", f32_ms


def merge_cases():
    """(name, kwargs of ``ref.random_merge_inputs``, softcap) of the
    gathered-buffer merge's synthetic cases: gemma2-2b decode shapes at a
    16384-token context (T 1668, E 256), ragged masks."""
    cap = 50.0
    return [
        ("merge_full_width_bf16", {}, cap),
        ("merge_f32", dict(dtype="float32", seed=1), cap),
        ("merge_softcap_off", dict(seed=2), None),
        ("merge_all_dead_estimation", dict(dead_frac=1.0, seed=3), cap),
        ("merge_empty_rows", dict(keep_min=0.0, seed=4), cap),
        ("merge_G8", dict(G=8, H=2, seed=5), cap),
    ]


def gather_case(device="cuda", seed=0):
    """gemma2-2b's bf16 stores (2, 4, M 1280, cap 32, hd 256), r 18 ids per
    row with repeats; kernel vs twin, bit-exact."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    ks, vs = (torch.randn((2, 4, 1280, 32, 256), generator=g, device=device)
              .to(torch.bfloat16) for _ in range(2))
    idx = torch.randint(0, 1280, (2, 4, 18), generator=g, device=device,
                        dtype=torch.int32)
    idx[:, :, 1] = idx[:, :, 0]                          # repeated ids
    res = check_gather("gather_full_width_bf16", idx, ks, vs, time_it=True)
    del ks, vs
    return res


def device_ms(fn, key, reps=20, clean=False):
    """Mean device duration in ms of the kernels whose name holds ``key``,
    as ``torch.profiler`` sees them, over ``reps`` calls of ``fn``, each
    after writing 128 MiB (L2 cold, as ``time_ms``; ``clean``: after reading
    it, so the L2 the call finds holds no dirty lines to write back). Unlike
    ``time_ms`` it leaves out the launch's own latency on the device."""
    import torch
    scrub = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    total = torch.zeros((), device="cuda")
    for _ in range(3):
        fn()

    def call():
        if clean:
            torch.sum(scrub, dim=0, out=total)
        else:
            scrub.fill_(1.0)
        fn()
    rows = [(us, n) for us, name, n in _profile_rows(
        call, reps, complete=lambda rows: _launch_count(rows, key) > 0)[0]
            if key in name]
    if not rows:
        raise AssertionError(f"profiler saw no kernel named *{key}*")
    return sum(us for us, _ in rows) / sum(n for _, n in rows) / 1e3


def check_gather(name, idx, k_store, v_store, *, time_it=False):
    """Drive the op entry point ``block_gather_op`` once (its launch count
    set to 0 just before and read just after), then hold its output against
    the twin (``torch.gather``), bit-exact."""
    import torch
    from repro_torch.kernels.gather import ops as gops
    gops.block_gather_op.launches = 0
    ko, vo = gops.block_gather_op(idx, k_store, v_store)
    launches = gops.block_gather_op.launches
    kr, vr = gops.block_gather_plain(idx, k_store, v_store)
    torch.cuda.synchronize()
    err = max((ko.float() - kr.float()).abs().max().item(),
              (vo.float() - vr.float()).abs().max().item())
    res = dict(case=name, max_abs_err=err, tol=0.0, launches=launches)
    if time_it:
        i = idx.long()[..., None, None].expand(idx.shape + k_store.shape[3:])
        res["ms"] = time_ms(lambda: gops.block_gather_op(idx, k_store,
                                                         v_store))
        res["plain_ms"] = time_ms(lambda: gops.block_gather_plain(
            idx, k_store, v_store))
        res["library_ms"] = time_ms(lambda: (torch.gather(k_store, 2, i),
                                             torch.gather(v_store, 2, i)))
        res["bound_ms"], res["bound_by"] = gather_bound(idx, k_store)
        # the kernel's own duration, and what time_ms gives a kernel that
        # does nothing: the floor of its launch on the device
        res["device_ms"], res["device_ms_clean_l2"] = (device_ms(
            lambda: gops.block_gather_op(idx, k_store, v_store),
            "block_gather", clean=clean) for clean in (False, True))
        one = torch.zeros(1, device="cuda")
        res["empty_kernel_ms"] = time_ms(lambda: one.fill_(0.0))
    log(f"  {name}: bit-exact {err == 0.0}"
        + (f"  kernel {res['ms']:.4f} ms (device {res['device_ms']:.4f}, "
           f"{res['device_ms_clean_l2']:.4f} after a clean L2; an empty "
           f"kernel {res['empty_kernel_ms']:.4f})  twin "
           f"{res['plain_ms']:.4f} ms  torch.gather {res['library_ms']:.4f} "
           f"ms  bound {res['bound_ms']:.4f} ms" if time_it else ""))
    if launches != 1 or not (torch.equal(ko, kr) and torch.equal(vo, vr)):
        raise AssertionError(f"{name}: {launches} launches, block gather "
                             f"bit-exact {err == 0.0}")
    return res


def kmeans_case(S=8, n=8192, d=256, k=512, iters=10, seed=0,
                device="cuda"):
    """The k-means op at the port's prefill segment (n 8192), k 512, d 256.
    Drives the op entry point ``segmented_kmeans_op`` once (launch count
    set to 0 just before and read just after) and checks its assignments
    against the twin's on its final centroids; then runs the same loop one
    step at a time, each kernel step held against the twin on the same
    centroids (``ref.kmeans_step_check``), the loop going on from the
    kernel's own update."""
    import torch
    from repro_torch.core.clustering import spherical_kmeans
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.kernels.kmeans.ref import (kmeans_step_check,
                                                kmeans_update_ref,
                                                ordered_update_ref)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((S, n, d), generator=g, device=device)
    cent = x[:, ::n // k][:, :k].contiguous()
    cent0 = cent
    kops.kmeans_step.launches = 0
    cent_op, assign_op = kops.segmented_kmeans_op(x, cent0, iters=iters)
    launches = kops.kmeans_step.launches
    chk = kmeans_step_check(x, cent_op, *kmeans_update_ref(x, assign_op, k),
                            assign_op)
    if launches != iters + 1 or not torch.isfinite(cent_op).all() \
            or not chk["ok"]:
        raise AssertionError(f"segmented_kmeans_op: {launches} launches, "
                             f"{chk}")
    worst, mism = None, 0
    for it in range(iters + 1):
        sums, counts, assign = kops.kmeans_step(x, cent)
        torch.cuda.synchronize()
        chk = kmeans_step_check(x, cent, sums, counts, assign)
        mism += chk["mismatches"]
        if not chk["ok"]:
            raise AssertionError(f"kmeans step {it}: {chk}")
        ratio = chk["sums_err_at_worst"] / max(chk["sums_tol_at_worst"],
                                               1e-30)
        if worst is None or ratio > worst[0]:
            worst = (ratio, it, chk)
        cent = torch.where(counts[..., None] > 0,
                           sums / torch.clamp(counts[..., None], min=1.0),
                           cent)
    _, it, chk = worst
    res = dict(case=f"kmeans_step_{it}", max_abs_err=chk["sums_err_at_worst"],
               tol=chk["sums_tol_at_worst"], launches=launches,
               sums_max_abs_err=chk["sums_max_abs_err"],
               assign_near_tie_mismatches=mism)
    # the update is deterministic: two calls give the same bits, and the
    # sums are the point-order sums over the kernel's own assignments
    one, two = kops.kmeans_step(x, cent0), kops.kmeans_step(x, cent0)
    res["bit_identical"] = all(torch.equal(a, b) for a, b in zip(one, two))
    want = ordered_update_ref(x, one[2], k)
    res["sums_equal_point_order"] = bool(torch.equal(one[0], want[0])
                                         and torch.equal(one[1], want[1]))
    del one, two, want
    if not (res["bit_identical"] and res["sums_equal_point_order"]):
        raise AssertionError(f"kmeans step: bit-identical "
                             f"{res['bit_identical']}, point-order sums "
                             f"{res['sums_equal_point_order']}")
    res["ms"] = time_ms(lambda: kops.kmeans_step(x, cent0))
    res["plain_ms"] = time_ms(lambda: kops.kmeans_step_plain(x, cent0))
    res["bound_ms"], res["bound_by"], res["bound_f32_ms"] = \
        kmeans_bound(x, cent0)
    # the step's device time by kernel (four launches a step)
    four = ["assign_kernel", "normalize_kernel", "order_kernel",
            "sums_kernel"]
    rows, _ = _profile_rows(
        lambda: kops.kmeans_step(x, cent0), 5,
        complete=lambda rows: all(_launch_count(rows, k) == 5 for k in four))
    res["split_ms"] = {re.search(r"\w+_kernel", name).group(0): us / 5e3
                       for us, name, _ in rows}
    if sorted(res["split_ms"]) != four:
        raise AssertionError(f"kmeans step launched {rows}")
    # the main path's own clustering loop (plain code) at the same shape,
    # against the op's loop, from the same initial centroids
    plain_assign = spherical_kmeans(x, k, iters, centering=False)
    res["plain_loop_agree"] = float(
        (plain_assign == assign_op.long()).float().mean())
    res["plain_loop_ms"] = time_ms(
        lambda: spherical_kmeans(x, k, iters, centering=False), reps=3)
    res["op_loop_ms"] = time_ms(
        lambda: kops.segmented_kmeans_op(x, cent0, iters=iters), reps=5)
    log(f"  segmented_kmeans_op: {launches} launches; kmeans ({S}, {n}, "
        f"{d}) k {k}, {iters} steps + final assign: "
        f"sums worst {res['max_abs_err']:.3e} vs tol {res['tol']:.3e} "
        f"(step {it}), {mism} assignments differ, all at near-ties; two "
        f"calls bit-identical, sums == point-order sums; kernel "
        f"{res['ms']:.4f} ms  twin {res['plain_ms']:.4f} ms  bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}; f32 "
        f"{res['bound_f32_ms']:.4f} ms)")
    log("    split of a step by device kernel (ms): " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in res["split_ms"].items()))
    log(f"    the main path's plain Lloyd loop (core/clustering.py::"
        f"spherical_kmeans, {iters} iterations, centering=False) "
        f"{res['plain_loop_ms']:.3f} ms against the op's loop "
        f"{res['op_loop_ms']:.3f} ms; final assignments agree on "
        f"{res['plain_loop_agree']:.4f} of the points")
    return res


def prefill_attention_case(name, T, Hq, Hkv, window=0, rows=0, seed=0,
                           device="cuda"):
    """The prefill attention kernel at one admission shape (B 1, T tokens,
    hd 128, bf16, causal; ``window`` > 0: only the last ``window`` keys a
    query): against its plain twin in f32 out (the card tests' tolerance),
    on every query or, with ``rows``, on the first and last ``rows``
    queries at their offset; then timed beside the twin, the library's
    ``scaled_dot_product_attention`` (bf16, causal, K/V repeated to Hq
    heads outside the timing; unwindowed calls only) and the bound: the
    larger of the attended work, 4 d Hq flops a (query, key) pair, at the
    bf16 tensor-core peak (with p v counted three times, the split the
    kernel computes, beside it) and q, k, v read and the bf16 out written
    at HBM bandwidth."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.prefill_attention import ops as pops
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).bfloat16()
    q, k, v = randn(1, T, Hq, 128), randn(1, T, Hkv, 128), randn(1, T, Hkv,
                                                                   128)
    out = pops.prefill_attention(q, k, v, window=window,
                                 out_dtype=torch.float32)
    n = min(rows, T) or T
    err = tol = 0.0
    for lo in sorted({0, T - n}):
        ref = pops.prefill_attention_plain(
            q[:, lo:lo + n], k[:, :lo + n], v[:, :lo + n], q_offset=lo,
            window=window, out_dtype=torch.float32)
        err = max(err, (out[:, lo:lo + n] - ref).abs().max().item())
        tol = max(tol, 2e-5 * (1 + ref.abs().max().item()))
        del ref
    del out
    if not err <= tol:
        raise AssertionError(f"prefill attention {name}: {err} > {tol}")
    res = dict(case=name, T=T, Hq=Hq, Hkv=Hkv, window=window,
               checked_rows=n, max_abs_err=err, tol=tol)
    res["ms"] = time_ms(lambda: pops.prefill_attention(q, k, v,
                                                       window=window),
                        reps=10)
    res["plain_ms"] = time_ms(lambda: pops.prefill_attention_plain(
        q, k, v, window=window), reps=3)
    G = Hq // Hkv
    if not window:
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=10)
        del qt, kt, vt
    W = window or T
    pairs = sum(min(t + 1, W) for t in range(T))
    ops_ms = pairs * 4 * 128 * Hq / BF16_FLOPS * 1e3
    bytes_ms = 2 * 128 * T * (2 * Hq + 2 * Hkv) / HBM_BYTES_PER_S * 1e3
    res["bound_ms"] = max(ops_ms, bytes_ms)
    res["bound_split_ms"] = max(2 * ops_ms, bytes_ms)
    res["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    res["roofline_pct"] = 100.0 * res["bound_ms"] / res["ms"]
    res["tflops"] = pairs * 4 * 128 * Hq / res["ms"] / 1e9
    lib = f", sdpa {res['library_ms']:.3f} ms" if "library_ms" in res else ""
    log(f"  prefill attention {name} (T {T}, Hq {Hq}, Hkv {Hkv}, window "
        f"{window or 'none'}): err {err:.3e} vs tol {tol:.3e} on {n} rows "
        f"at each end; kernel {res['ms']:.3f} ms ({res['tflops']:.1f} "
        f"TFLOP/s of attended work), twin {res['plain_ms']:.3f} ms{lib}, "
        f"bound {res['bound_ms']:.3f} ms by {res['bound_by']} (split p v "
        f"{res['bound_split_ms']:.3f}), {res['roofline_pct']:.1f}% of it")
    return res


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

class LaunchTap:
    """Stands in for the ops module inside ``core.attention`` during a serve
    run: forwards every call to the real wrapper, and counts the calls made
    while a CUDA graph is being captured. A wrapper counts the launches a
    capture records (its Python code runs once then), and no replay's,
    which repeats them without Python: ``served`` turns the wrappers' counts
    into the launches the run made."""

    def __init__(self, ops):
        import torch
        self.capturing = lambda: torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing()
        self.ops = ops
        self.recorded = {}              # op -> calls made during capture

    def _call(self, op, args, softcap):
        if self.capturing():
            self.recorded[op] = self.recorded.get(op, 0) + 1
        return getattr(self.ops, op)(*args, softcap=softcap)

    def paged_wave_attention(self, *args, softcap=None):
        return self._call("paged_wave_attention", args, softcap)

    def wave_attention_merge(self, *args, softcap=None):
        return self._call("wave_attention_merge", args, softcap)

    def served(self, counts, graph):
        """The launches of a serve run from the wrappers' ``counts``: the
        eager calls (counts less the captures' recorded calls) plus each
        replay's, which are one capture's."""
        out = dict(counts)
        for op, n in self.recorded.items():
            out[op] += graph.replays * (n // graph.captures) - n
        return out


def tapped_serve(engine, reqs, batch, tap, seed=0):
    """``engine.serve`` (sampler seeded with ``seed``) with ``tap`` in place
    of ``core.attention``'s ops module, every kernel's launch count set to
    0 just before; returns the metrics, the wall seconds and the served
    launches (``LaunchTap``)."""
    import torch
    from repro_torch.core import attention
    real_ops, real_gather = attention.wa_ops, attention._gather_clusters
    reset_launches()                                # count the main path only
    attention.wa_ops = tap
    attention._gather_clusters = getattr(tap, "gather", real_gather)
    try:
        t0 = time.perf_counter()
        m = engine.serve(reqs, batch_size=batch, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attention.wa_ops, attention._gather_clusters = real_ops, real_gather
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    return m, wall, tap.served(counts, engine.last_graph)


def profiled_replay(graph, path, n_layers):
    """One more replay of a served step's graph under ``torch.profiler``:
    the device launches of the path's attention kernel (a split and a
    combine launch per layer, ``2 x n_layers``; none for the full
    runtime), which the wrappers' counts cannot see. A session that sees
    another count is profiled again (``_profile_rows``): the profiler now
    and then loses some of the card's records."""
    import numpy as np
    import torch
    tag = KERNEL_TAGS.get(path)
    want = 2 * n_layers if tag else 0
    with torch.inference_mode():
        rows, _ = _profile_rows(
            lambda: graph.step(np.ones(graph.tokens.shape[0], bool)), 1,
            complete=lambda rows: _launch_count(rows, tag) == want)
    n = _launch_count(rows, tag)
    if n != want:
        raise AssertionError(f"a profiled replay launched {n} {path} "
                             f"kernels, want {want}")
    return dict(attention_launches=n, kernels=sum(r[2] for r in rows))


class Capture(LaunchTap):
    """A ``LaunchTap`` that also keeps a clone of the
    arguments of one local-layer and one global-layer launch, taken when
    every row holds a real context (paged kernel: every row at position
    ``min_pos`` or later; gathered-buffer merge: every row's mask admits a
    token, which an empty slot's never does). For the merge's global-layer
    launch it also keeps the ids and stores its execution buffer was
    gathered from (``gather`` stands in for ``_gather_clusters``).

    A call made while a CUDA graph is being captured may neither read a
    value back nor copy: it keeps references to its arguments, which live
    on in the graph's memory and hold each replay's values. ``finish``,
    after the serve run, takes a kind no eager call gave from the last
    replay's arguments."""

    def __init__(self, ops, attention, n_layers, kinds, min_pos):
        super().__init__(ops)
        self.n_layers, self.kinds = n_layers, kinds
        self.min_pos = min_pos
        self.rowb = ops.ARG_NAMES.index("rowb")
        self.real_gather = attention._gather_clusters
        self.last_gather = None
        self.calls = 0
        self.taken = {}
        self.in_graph = {}              # kind -> (layer, args refs, ...)

    def _kind(self):
        layer = self.calls % self.n_layers
        self.calls += 1
        return layer, self.kinds[layer]

    def gather(self, state, idx):
        self.last_gather = (state, idx)
        return self.real_gather(state, idx)

    def _ok(self, op, args):
        if op == "paged_wave_attention":
            return int(args[self.rowb][..., 1].min()) >= self.min_pos
        return bool(args[3].any(-1).all())

    def _take(self, op, kind, layer, args, softcap, gathered):
        if op == "paged_wave_attention":
            return (layer, [a.clone() for a in args], softcap)
        st, idx = gathered
        blocks = (idx.clone(), st.k_store.clone(), st.v_store.clone()) \
            if kind == "g" else None
        return (layer, [a.clone() for a in args], softcap, blocks)

    def _call(self, op, args, softcap):
        layer, kind = self._kind()
        if self.capturing():
            self.in_graph.setdefault(kind, (layer, args, softcap,
                                            self.last_gather))
        elif kind not in self.taken and self._ok(op, args):
            self.taken[kind] = self._take(op, kind, layer, args, softcap,
                                          self.last_gather)
        return super()._call(op, args, softcap)

    def finish(self, op):
        """After the run: the kinds still missing, from the last replay."""
        for kind, (layer, args, softcap, gathered) in self.in_graph.items():
            if kind not in self.taken and self._ok(op, args):
                self.taken[kind] = self._take(op, kind, layer, args, softcap,
                                              gathered)
        self.in_graph = {}


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    for fn in launch_counters().values():
        fn.launches = 0


def launch_counters():
    from repro_torch.kernels.gather import ops as gops
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.kernels.wave_attention import ops
    return dict(paged_wave_attention=ops.paged_wave_attention,
                wave_attention_merge=ops.wave_attention_merge,
                block_gather=gops.block_gather_op,
                kmeans_step=kops.kmeans_step)


IMPL_KERNEL = {"fused": "paged_wave_attention",
               "pallas": "wave_attention_merge"}


def attn_kinds(cfg):
    """The kind ('g' global, 'l' local) of each attention layer a decode
    step walks, in order: every layer of an attention family, every
    shared-attention site of the hybrid, every decoder layer of the audio
    family (all global), none for ssm."""
    from repro_torch.models import hybrid
    from repro_torch.models import model as M
    if cfg.family in M.ATTN_FAMILIES:
        return cfg.layer_kinds()
    if cfg.family == "hybrid":
        return ("g",) * len(hybrid.attn_sites(cfg))
    return ("g",) * (cfg.n_layers if cfg.family == "audio" else 0)


def frame_extra(cfg, seed, device="cuda"):
    """A request's audio extras: seeded normal bf16 frame embeddings (1,
    encoder_frames, d_model), the reference's stubbed mel + conv frontend;
    None for other families."""
    import torch
    if cfg.family != "audio":
        return None
    g = torch.Generator(device=device).manual_seed(2000 + seed)
    return {"frames": torch.randn((1, cfg.encoder_frames, cfg.d_model),
                                  generator=g, device=device)
            .to(torch.bfloat16)}


def serve_main_path(cfg, prompt_lens, new_tokens, *, attn_impl="fused",
                    runtime="retro", admission="chunked", chunk=256,
                    batch=2, device="cuda", seed=0, min_capture_pos=4096,
                    want_flush=True, params=None, patches=0,
                    temperature=None, serve_seed=0):
    """Drive the port's main path: ServeEngine with ``admission``
    ("chunked" or "blocking") and ``runtime`` ("retro": decode through
    ``attn_impl``, "fused" or "pallas"; "full": the dense cache, no kernel);
    every kernel's launch count is set to 0 just before and read just
    after. ``params``: the model's (default: random from ``seed``);
    ``patches`` > 0 gives each request seeded bf16 patch embeddings of its
    first ``patches`` positions (vlm, ``Request.extra``); an audio
    family's requests get seeded frame embeddings (``frame_extra``). The
    attention launches are counted per attention layer (``attn_kinds``:
    a hybrid's sites, a decoder's layers; none for ssm). ``temperature``
    (None: the engine's default, greedy) samples every token from a
    generator seeded with ``serve_seed``."""
    import numpy as np
    import torch
    from repro_torch.core import attention
    from repro_torch.core.wave_index import prefill_layout
    from repro_torch.kernels.wave_attention import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServeEngine

    if params is None:
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = M.init_params(cfg, gen, device)
        if device == "cuda":
            torch.cuda.synchronize()
        log(f"  params: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f}"
            f" B in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m,
                    extra=patch_extra(cfg, patches, seed + i, device)
                    or frame_extra(cfg, seed + i, device))
            for i, (n, m) in enumerate(zip(prompt_lens, new_tokens))]
    engine = ServeEngine(cfg, params, prefill_chunk=chunk, device=device,
                         attn_impl=attn_impl, runtime=runtime,
                         admission=admission,
                         **({} if temperature is None
                            else {"temperature": temperature}))
    if engine.attn_impl != attn_impl:
        raise AssertionError(f"engine resolved {engine.attn_impl}")
    kinds = attn_kinds(cfg)
    n_attn = len(kinds)
    cap = Capture(ops, attention, n_attn, kinds, min_capture_pos)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    m, wall, counts = tapped_serve(engine, reqs, batch, cap, serve_seed)
    peak = torch.cuda.max_memory_allocated()
    path = IMPL_KERNEL[attn_impl] if runtime == "retro" and n_attn else None
    if path is not None:
        cap.finish(path)
    graph = engine.last_graph
    if (graph.captures, graph.replays) != (1, m.steps - 1):
        raise AssertionError(f"{graph.captures} captures, {graph.replays} "
                             f"replays for {m.steps} decode steps")
    if path is not None and cap.recorded != {path: n_attn}:
        raise AssertionError(f"the capture recorded {cap.recorded}")

    # --- what came out ---
    want = {k: 0 for k in counts}
    if path is not None:
        want[path] = n_attn * m.steps
    if counts != want:
        raise AssertionError(f"kernel launches {counts} for {m.steps} decode "
                             f"steps x {n_attn} attention layers: want "
                             f"{want}")
    if want_flush and m.flushes < 1:
        raise AssertionError("no decode-time flush ran")
    retro = cfg.retro
    kv = M.kv_states(cfg, engine.last_state)
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
            got_cl = int(st.n_clusters[slot]) if runtime == "retro" \
                else want_clusters
            if got_len != want_len or got_cl != want_clusters:
                raise AssertionError(
                    f"slot {slot}: length {got_len} (want {want_len}), "
                    f"clusters {got_cl} (want {want_clusters})")
    res = dict(attn_impl=attn_impl, runtime=runtime, admission=admission,
               arch=cfg.arch_id, wall_s=wall, steps=m.steps,
               launches=counts[path] if path else 0, all_launches=counts,
               flushes=m.flushes, tokens_out=m.tokens_out,
               prefill_tokens=m.prefill_tokens, prefill_s=m.prefill_s,
               prefill_tps=m.prefill_tps, decode_s=m.decode_s,
               decode_tps=m.decode_tps, ttft_s=[r.ttft_s for r in reqs],
               itl_p50_ms=m.itl_p50_s * 1e3, itl_p99_ms=m.itl_p99_s * 1e3,
               peak_mem_gib=peak / 2**30, held_before_gib=held / 2**30,
               graph_captures=graph.captures,
               graph_replays=graph.replays, temperature=engine.temperature,
               tokens=[list(map(int, r.out_tokens)) for r in reqs])
    log(f"  {cfg.arch_id} {runtime}/{admission}/{attn_impl}: decode steps "
        f"{m.steps} (1 warm-up + {graph.replays} replays of "
        f"{graph.captures} captured graph), launches {counts} "
        f"(= {n_attn} x steps of {path}), flushes {m.flushes}")
    log(f"  TTFT s {['%.3f' % t for t in res['ttft_s']]}; prefill "
        f"{res['prefill_tps']:.1f} tok/s; decode {res['decode_tps']:.2f} "
        f"tok/s; ITL p50/p99 {res['itl_p50_ms']:.2f}/"
        f"{res['itl_p99_ms']:.2f} ms; peak mem "
        f"{res['peak_mem_gib']:.2f} GiB ({res['held_before_gib']:.2f} held "
        f"before the run); wall {wall:.1f} s")
    if path is not None and set(cap.taken) != set(kinds):
        raise AssertionError(f"captured launches {sorted(cap.taken)}")
    # the replays' launches are counted from the capture; a profiled replay
    # shows the card running that many
    res["profiled_replay"] = profiled_replay(graph, path, n_attn)
    log(f"  one profiled replay after the run: "
        f"{res['profiled_replay']['attention_launches']} attention kernel "
        f"launches (split + combine per layer), "
        f"{res['profiled_replay']['kernels']} kernels")
    return res, cap.taken, engine


def patch_extra(cfg, patches, seed, device="cuda"):
    """A request's vlm extras: seeded normal bf16 patch embeddings (1, P,
    d_model), the reference's stub vision tower; None for ``patches`` 0."""
    import torch
    if not patches:
        return None
    g = torch.Generator(device=device).manual_seed(1000 + seed)
    return {"patch_embeds": torch.randn((1, patches, cfg.d_model),
                                        generator=g, device=device)
            .to(torch.bfloat16)}


def compare_impls(engine, layer, max_ctx, seed=7):
    """The three decode-attention impls on clones of one layer's state as
    the serve run left it, with one random query: "pallas" vs "fused" in f32
    (they differ only in the order of the f32 sums), "jnp" vs "pallas"
    within the reference kernel test's bf16 tolerance (atol = rtol = 3e-2,
    tests/test_kernels.py:40): "jnp" rounds q and p to the bf16 stores."""
    import torch
    from repro_torch.core import attention
    from repro_torch.core.wave_index import WaveState
    from repro_torch.core.zones import plan_zones
    cfg, st = engine.cfg, engine.last_state.kv[layer]
    plan = plan_zones(max_ctx, cfg.retro, engine.gen_headroom)
    B, dev = st.length.shape[0], st.length.device
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).to(torch.bfloat16).float()
    outs = {}
    for impl in ("fused", "pallas", "jnp"):
        clone = WaveState(*(t.clone() for t in st))
        outs[impl] = attention.wave_attention_decode(
            q, clone, cfg.retro, plan, window=engine.params["window"][layer],
            softcap=cfg.attn.softcap, impl=impl).out
        del clone
    f, p, j = outs["fused"], outs["pallas"], outs["jnp"]
    res = dict(layer=layer,
               pallas_vs_fused=(p - f).abs().max().item(),
               pallas_vs_fused_tol=2e-5 * (1 + f.abs().max().item()),
               jnp_vs_pallas=(j - p).abs().max().item(),
               jnp_vs_pallas_excess=((j - p).abs() - 3e-2 * (1 + p.abs()))
               .max().item())
    log(f"  impls on layer {layer}'s state: |pallas - fused| "
        f"{res['pallas_vs_fused']:.3e} (tol {res['pallas_vs_fused_tol']:.3e}); "
        f"|jnp - pallas| {res['jnp_vs_pallas']:.3e} (tol 3e-2 (1 + |pallas|))")
    if not all(torch.isfinite(o).all() for o in outs.values()):
        raise AssertionError("an impl's attention is not finite")
    if not res["pallas_vs_fused"] <= res["pallas_vs_fused_tol"]:
        raise AssertionError(f"pallas vs fused: {res}")
    if not res["jnp_vs_pallas_excess"] <= 0:
        raise AssertionError(f"jnp vs pallas: {res}")
    return res


def device_kernels(prof):
    """(device us, name, count) of every device kernel a ``torch.profiler``
    run saw, longest first (an aten op's row repeats the time of the
    kernels it launched, so only device rows count)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0) or \
            getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(ev, "device_type", None) == cuda:
            rows.append((dev_us, ev.key, ev.count))
    if not rows:
        raise AssertionError("profiler saw no device kernels")
    return sorted(rows, reverse=True)


PROFILER = dict(sessions=0, reruns=0)


def _profile_rows(fn, steps, complete=None, tries=8):
    """``fn`` run ``steps`` times under ``torch.profiler``: (device kernel
    rows, synced wall seconds). Now and then a session loses some or all
    of the card's records, whatever the work, and a loss can run on for a
    few sessions in a row. So a session that records no device kernel, or
    whose rows ``complete`` rejects, is run again, up to ``tries`` sessions
    (``PROFILER`` counts sessions and reruns). Rows that ``complete`` still
    rejects after the last session are returned, for the caller's check to
    refuse."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        PROFILER["sessions"] += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        try:
            rows = device_kernels(prof)
        except AssertionError:
            if attempt == tries - 1:
                raise
            rows = None
        if rows is not None and (complete is None or complete(rows)
                                 or attempt == tries - 1):
            return rows, wall
        PROFILER["reruns"] += 1
        log(f"  (profiler session saw {sum(r[2] for r in rows or ())} device "
            f"kernels, not all of them; profiling again)")


def _launch_count(rows, tag):
    """Device launches in ``rows`` of the kernels whose name holds ``tag``
    (none for no tag)."""
    return sum(c for _, k, c in rows if tag and tag in k)


def step_breakdown(fn, steps=8):
    """Host time to enqueue one step ``fn`` (no sync), the synced wall of a
    step, and device kernel time by name over ``steps`` profiled steps
    (device busy share = kernel time / the profiled wall)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    enq, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        enq.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    rows, prof_wall = _profile_rows(fn, steps)
    busy_s = sum(r[0] for r in rows) / 1e6
    # each attention kernel call is a split and a combine launch, both named
    # after the kernel's tile source
    attn = {name: dict(ms_per_step=sum(us for us, k, _ in rows if tag in k)
                       / 1e3 / steps,
                       launches_per_step=sum(c for _, k, c in rows
                                             if tag in k) / steps)
            for name, tag in KERNEL_TAGS.items()}
    return dict(enqueue_ms=1e3 * sum(enq) / steps,
                step_wall_ms=1e3 * sum(wall) / steps,
                profiled_step_ms=1e3 * prof_wall / steps,
                device_busy_ms=1e3 * busy_s / steps,
                device_busy_share=busy_s / prof_wall,
                kernels_per_step=sum(r[2] for r in rows) / steps,
                attention_kernels=attn,
                top_kernels=[dict(name=k[:90], ms_per_step=us / 1e3 / steps,
                                  calls_per_step=c / steps)
                             for us, k, c in rows[:10]])


KERNEL_TAGS = {"paged_wave_attention": "PagedSrc",
               "wave_attention_merge": "MergeSrc"}


def eager_step(graph, act):
    """``graph``'s decode step run eagerly on its static buffers, as its
    warm-up runs it (to measure or check a replay against)."""
    import torch
    graph.active.copy_(torch.from_numpy(act).pin_memory(), non_blocking=True)
    logits, _ = graph.fn(graph.state, graph.tokens, graph.active)
    ids = graph.sample(logits)
    graph.tokens.copy_(ids)
    return logits, ids


def fused_activation_graph(graph, act):
    """A second capture of ``graph``'s step, on its state and buffers, with
    torch's fused gelu and silu (one kernel each, rounded once) in place of
    the port's op-for-op ones: the MLP before the bf16 repair, to measure
    what the repair costs a replay. Warmed up and captured here (one step
    of the state)."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.serving.graphs import DecodeGraph
    alt = DecodeGraph(graph.fn, graph.sample, graph.state, graph.tokens)
    real = L.gelu_tanh, L.silu
    L.gelu_tanh, L.silu = (lambda x: F.gelu(x, approximate="tanh")), F.silu
    try:
        alt.step(act)
    finally:
        L.gelu_tanh, L.silu = real
    return alt


def decode_breakdown(engine, steps=4, upcast_too=False):
    """Where one decode step's time goes, on the state the serve run left
    (both slots active), in one call: the serve's captured step run eagerly
    on its static buffers, then replayed (``DecodeGraph``), then a replay of
    the same step captured with torch's fused activations (the MLP before
    the bf16 repair); with ``upcast_too``, first the full runtime's old
    formulation (the cache upcast to f32 for both products) eagerly. For
    each: host time to enqueue a step, synced wall, device busy and its
    share, kernels per step, top kernels (``step_breakdown``)."""
    import numpy as np
    import torch
    from repro_torch.core import attention
    graph = engine.last_graph
    act = np.ones(graph.tokens.shape[0], bool)
    res = {}
    with torch.inference_mode():
        if upcast_too:
            real = attention._f32_product
            attention._f32_product = lambda a, b: torch.matmul(a.float(),
                                                               b.float())
            try:
                res["eager_upcast"] = step_breakdown(
                    lambda: eager_step(graph, act), steps)
            finally:
                attention._f32_product = real
        res["eager"] = step_breakdown(lambda: eager_step(graph, act), steps)
        res["replay"] = step_breakdown(lambda: graph.step(act), steps)
        alt = fused_activation_graph(graph, act)
        res["replay_fused_act"] = step_breakdown(lambda: alt.step(act),
                                                 steps)
        del alt
    for name, r in res.items():
        log(f"  {name:16s} step (B={len(act)}): host enqueue "
            f"{r['enqueue_ms']:.2f} ms, synced wall {r['step_wall_ms']:.2f} "
            f"ms, device busy {r['device_busy_ms']:.2f} ms "
            f"({100 * r['device_busy_share']:.1f}% of the profiled wall), "
            f"{r['kernels_per_step']:.0f} kernels")
        for kname, a in r["attention_kernels"].items():
            if a["launches_per_step"]:
                log(f"    {kname} (split + combine): {a['ms_per_step']:.3f} "
                    f"ms/step in {a['launches_per_step']:.1f} launches")
        for k in r["top_kernels"][:6]:
            log(f"    {k['ms_per_step']:8.3f} ms/step "
                f"{k['calls_per_step']:6.1f} calls  {k['name']}")
    return res


def moe_ffn_step(params, cfg, batch=2, steps=8, seed=12, device="cuda"):
    """The MoE FFN of one decode step at ``batch`` tokens: every layer's
    ``moe_apply`` on a seeded (batch, d_model) input, profiled over
    ``steps`` steps: device ms per step (its kernels' durations), kernels
    per step and the bytes bound. At decode every expert's capacity (C >= 8)
    covers its tokens and the dropping MoE multiplies every expert's
    buffer, so a step reads every expert's weights (and the routers)."""
    import torch
    from repro_torch.models.moe import expert_capacity, moe_apply
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, cfg.d_model), generator=g, device=device) \
        .to(params["layers"][0]["moe"]["w_up"].dtype)

    def step():
        for lp in params["layers"]:
            moe_apply(lp["moe"], x, cfg.moe, cfg.act)
    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        rows, wall = _profile_rows(step, steps)
    busy = sum(us for us, _, _ in rows) / 1e3 / steps
    nbytes = sum(_nbytes(*lp["moe"].values()) for lp in params["layers"])
    bound_ms, bound_by = bound(nbytes, 0)
    res = dict(batch=batch, layers=cfg.n_layers,
               capacity=expert_capacity(batch, cfg.moe),
               device_ms_per_step=busy, synced_wall_ms_per_step=1e3 * wall
               / steps, kernels_per_step=sum(r[2] for r in rows) / steps,
               weight_gb=nbytes / 1e9, bound_ms=bound_ms, bound_by=bound_by,
               top_kernels=[dict(name=k[:90], ms_per_step=us / 1e3 / steps)
                            for us, k, _ in rows[:5]])
    log(f"  MoE FFN of one decode step ({cfg.n_layers} layers, {batch} "
        f"tokens, C {res['capacity']}): device {busy:.3f} ms (profiler), "
        f"{res['kernels_per_step']:.0f} kernels; bound {bound_ms:.3f} ms "
        f"({bound_by}: {res['weight_gb']:.2f} GB of expert and router "
        f"weights)")
    for k in res["top_kernels"][:3]:
        log(f"    {k['ms_per_step']:8.3f} ms/step  {k['name']}")
    return res


def config_case(name, args, softcap, op, timed):
    """``compare`` at a config's decode shape; ``timed``: also the kernel's
    time, its bound and its device duration (profiler)."""
    from repro_torch.kernels.wave_attention import ops
    res = compare(name, args, softcap, op=op, time_it=timed)
    if timed:
        res["bound_ms"], res["bound_by"] = BOUNDS[op](args)
        res["device_ms"] = device_ms(
            lambda: getattr(ops, op)(*args, softcap=softcap),
            KERNEL_TAGS[op])
        log(f"    bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
            f"device duration {res['device_ms']:.4f} ms (split + combine)")
    return res


def captured_launch(name, taken, kind, op="paged_wave_attention",
                    with_device=False):
    """A served path's captured launch of layer kind ``kind`` against the
    twin, timed, with its bound; ``with_device``: also its device duration
    (split + combine, profiler)."""
    from repro_torch.kernels.wave_attention import ops
    layer, args, softcap = taken[kind][:3]
    res = compare(f"{name}_captured_layer_{layer}", args, softcap, op=op,
                  time_it=True)
    res["bound_ms"], res["bound_by"] = BOUNDS[op](args)
    msg = f"    bound {res['bound_ms']:.4f} ms ({res['bound_by']})"
    if with_device:
        res["device_ms"] = device_ms(
            lambda: getattr(ops, op)(*args, softcap=softcap),
            KERNEL_TAGS[op])
        msg += f", device duration {res['device_ms']:.4f} ms"
    log(msg)
    return res


def state_layout(state):
    """[layer, field, shape, stride, contiguous, device, storage offset] of
    every tensor of a serve state."""
    return [[i, f, list(t.shape), list(t.stride()), t.is_contiguous(),
             str(t.device), t.storage_offset()]
            for i, st in enumerate(state.kv) for f, t in zip(st._fields, st)]


def replay_vs_eager(graph, restore, act, steps, tag, want_attn, name):
    """``steps`` eager steps of ``graph``'s decode step after ``restore``,
    then restored, one capture, restored again, ``steps`` replays: the
    logits bits and ids must be equal, and one profiled replay must launch
    ``want_attn`` kernels named after ``tag``, with one capture. Returns
    the result; raises on a breach."""
    import torch
    with torch.inference_mode():
        restore(graph)
        eager = [tuple(t.clone() for t in eager_step(graph, act))
                 for _ in range(steps)]
        restore(graph)
        graph.step(act)                             # warm-up + capture
        restore(graph)
        replay = [tuple(t.clone() for t in graph.step(act))
                  for _ in range(steps)]
        torch.cuda.synchronize()
        rows, _ = _profile_rows(
            lambda: graph.step(act), 1, complete=lambda rows:
            _launch_count(rows, tag) == want_attn)
    same = all(torch.equal(a[0], b[0]) for a, b in zip(eager, replay))
    ids = all(torch.equal(a[1], b[1]) for a, b in zip(eager, replay))
    finite = all(torch.isfinite(a[0]).all() for a in replay)
    n_attn = _launch_count(rows, tag)
    res = dict(bit_identical=same, ids_equal=ids, captures=graph.captures,
               replays=graph.replays,
               kernels_per_replay=sum(r[2] for r in rows),
               attention_launches_per_replay=n_attn)
    log(f"  {name}: {steps} eager vs {steps} replayed steps from one "
        f"state: logits bit-identical {same}, ids equal {ids}; one "
        f"profiled replay: {res['kernels_per_replay']} kernels, "
        f"{n_attn} attention launches (want {want_attn})")
    if not (same and ids and finite and n_attn == want_attn
            and graph.captures == 1):
        raise AssertionError(f"compiled step {name}: {res}")
    return res


def compiled_step_check(params, cfg, prompt_lens=(8192, 6000), steps=8,
                        seed=11, device="cuda", gen_headroom=1024,
                        paths=(("retro", ("fused", "pallas", "jnp")),
                               ("full", ("jnp",)))):
    """Phase 10: full-width decode states from blocking prefills of
    ``prompt_lens``; for each of "fused", "pallas", "jnp" and the full
    runtime, the engine's captured step (``DecodeGraph``) from one state
    copy: ``steps`` eager steps, the hot fields and tokens restored, one
    capture, restored again, ``steps`` replays. Replayed logits must equal
    the eager step's bits and the ids must be equal; one profiled replay
    must launch 2 x layers attention kernels (split + combine) for the
    impls that have one."""
    import numpy as np
    import torch
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    from repro_torch.models.transformer import HOT_FIELDS
    from repro_torch.serving.engine import Sampler, _DirectStore
    rng = np.random.default_rng(seed)
    S = max(prompt_lens)
    toks = np.zeros((len(prompt_lens), S), np.int64)
    for b, n in enumerate(prompt_lens):
        toks[b, :n] = rng.integers(0, cfg.vocab, n)
    B = len(prompt_lens)
    act = np.ones(B, bool)
    out = {}
    for runtime, impls in paths:
        plan = plan_zones(S, cfg.retro, gen_headroom)
        with torch.inference_mode():
            _, state = M.apply_prefill(
                params, cfg, {"tokens": torch.from_numpy(toks).to(device)},
                runtime=runtime, plan=plan, gen_headroom=gen_headroom,
                lengths=torch.tensor(prompt_lens, dtype=torch.int32,
                                     device=device),
                cache_len=S + gen_headroom)
        hot = HOT_FIELDS if runtime == "retro" else ("k", "v", "length")
        saved = [{f: getattr(st, f).clone() for f in hot} for st in state.kv]
        first = torch.tensor([1, 2], dtype=torch.int32, device=device)[:B]

        def restore(graph):
            for st, sv in zip(state.kv, saved):
                for f, t in sv.items():
                    getattr(st, f).copy_(t)
            graph.tokens.copy_(first)

        for impl in impls:
            graph = _DirectStore(cfg, params, plan, state, first.clone(),
                                 Sampler(device=device), runtime=runtime,
                                 attn_impl=impl,
                                 key=(B, S, impl, runtime)).graph
            name = "full" if runtime == "full" else impl
            tag = KERNEL_TAGS.get(IMPL_KERNEL.get(impl)) \
                if runtime == "retro" else None
            out[name] = replay_vs_eager(graph, restore, act, steps, tag,
                                        2 * cfg.n_layers if tag else 0, name)
            out[name]["attention_kernel"] = IMPL_KERNEL.get(impl) \
                if runtime == "retro" else None
            del graph
        del state, saved
        torch.cuda.empty_cache()
    return out


def family_compiled_check(engine, max_ctx, impls, steps=8):
    """Phase 10's method for the non-attention families, on the state the
    serve run of ``engine`` left (every slot holding its request's
    context, admitted as the engine admits these families: one blocking,
    unpadded prefill a prompt): for each impl, the engine's step of that
    geometry captured by a ``DecodeGraph``: ``steps`` eager steps, every
    state tensor restored, one capture, restored again, ``steps`` replays.
    Replayed logits must equal the eager step's bits and the ids must be
    equal; one profiled replay must launch 2 x (attention layers)
    attention kernels (none for ssm)."""
    import numpy as np
    import torch
    from repro_torch.core.zones import plan_zones
    from repro_torch.serving.engine import Sampler, _DirectStore
    from repro_torch.serving.graphs import leaves
    cfg, state, runtime = engine.cfg, engine.last_state, engine.runtime
    B = engine.last_graph.tokens.shape[0]
    act = np.ones(B, bool)
    plan = None if cfg.family == "ssm" else \
        plan_zones(max_ctx, cfg.retro, engine.gen_headroom)
    with torch.inference_mode():
        saved = [t.clone() for t in leaves(state)]
    first = torch.tensor([1, 2], dtype=torch.int32,
                         device=saved[0].device)[:B]

    def restore(graph):
        for t, sv in zip(leaves(state), saved):
            t.copy_(sv)
        graph.tokens.copy_(first)

    n_attn = len(attn_kinds(cfg))
    out = {}
    for impl in impls:
        graph = _DirectStore(cfg, engine.params, plan, state, first.clone(),
                             Sampler(device=engine.device), runtime=runtime,
                             attn_impl=impl,
                             key=(B, max_ctx, impl, runtime)).graph
        name = "full" if runtime == "full" else impl
        tag = KERNEL_TAGS.get(IMPL_KERNEL.get(impl)) \
            if runtime == "retro" and n_attn else None
        out[name] = replay_vs_eager(graph, restore, act, steps, tag,
                                    2 * n_attn if tag else 0,
                                    f"{cfg.arch_id} {name}")
        del graph
    del state, saved
    torch.cuda.empty_cache()
    return out


def reduced_family_across_devices(arch, attn_impl="fused", runtime="retro",
                                  seed=0, device="cuda"):
    """A non-attention family's reduced model on the card (kernel) vs on
    the CPU (twin): a blocking prefill of two 300-token prompts (frames
    for audio), then six decode steps through ``attn_impl``; the logits of
    the prefill and of every step agree within 1e-3."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import reduced_config
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    cfg = reduced_config(arch)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
        else [to(v) for v in t] if isinstance(t, list) \
        else t.to(device) if hasattr(t, "to") else t
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 300)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
    steps = rng.integers(0, cfg.vocab, (6, 2)).astype(np.int64)
    plan = None if cfg.family == "ssm" else plan_zones(300, cfg.retro, 256)
    runs = {}
    for dev, params in (("cpu", cpu), (device, to(cpu))):
        lg, st = M.apply_prefill(params, cfg, to(batch) if dev != "cpu"
                                 else batch, runtime=runtime, plan=plan,
                                 gen_headroom=256)
        out = [lg.float().cpu()]
        for t in range(6):
            lg, st = M.apply_decode(params, cfg, st,
                                    torch.from_numpy(steps[t]).to(dev),
                                    runtime=runtime, plan=plan,
                                    attn_impl=attn_impl)
            out.append(lg.float().cpu())
        runs[dev] = torch.stack(out)
    err = (runs[device] - runs["cpu"]).abs().max().item()
    log(f"  reduced {cfg.arch_id} ({runtime}, blocking admission, "
        f"{attn_impl}), card vs cpu logits of the prefill and 6 decode "
        f"steps: max|d| {err:.3e} (tol 1e-3)")
    if not torch.isfinite(runs[device]).all() or err > 1e-3:
        raise AssertionError(f"reduced model disagrees across devices: {err}")
    return err


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "numel"):
        yield tree


def reduced_across_devices(attn_impl, runtime="retro", admission="chunked",
                           seed=0, device="cuda", arch="gemma2_2b"):
    """The reduced model of ``arch`` on the card (kernel) vs on the CPU
    (twin): chunked or blocking prefill of two ragged prompts, then six
    decode steps under ``runtime`` (retro: through ``attn_impl``); logits
    agree."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import reduced_config
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    cfg = reduced_config(arch)
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
        def decode(st, rows):
            out = []
            for t in range(6):
                lg, st = M.apply_decode(
                    params, cfg, st, torch.from_numpy(steps[t, rows]).to(dev),
                    runtime=runtime, plan=plan, attn_impl=attn_impl)
                out.append(lg.float().cpu())
            return out

        if admission == "blocking":
            lg, st = M.apply_prefill(
                params, cfg, {"tokens": torch.from_numpy(toks).to(dev)},
                runtime=runtime, plan=plan, gen_headroom=256,
                lengths=torch.from_numpy(lens).to(dev), cache_len=320 + 256)
            runs[dev] = torch.stack([lg.float().cpu()]
                                    + decode(st, slice(0, 2)))
            continue
        cs = M.make_prefill_chunk_state(cfg, 2, 320, chunk=64,
                                        runtime=runtime, gen_headroom=256,
                                        device=dev)
        for c0 in range(0, 320, 64):
            cl = torch.from_numpy(np.clip(lens - c0, 0, 64)).to(dev)
            _, cs = M.apply_prefill_chunk(
                params, cfg, {"tokens": torch.from_numpy(toks[:, c0:c0 + 64])
                              .to(dev)}, cs, runtime=runtime, chunk_lens=cl)
        # rows finalize at their own length: finalize each row separately
        logits = []
        for b in range(2):
            row = type(cs)(cache=[c._replace(k=c.k[b:b + 1], v=c.v[b:b + 1],
                                             length=c.length[b:b + 1])
                                  for c in cs.cache],
                           wave=[w and _row_cp(w, b) for w in cs.wave])
            st = M.finalize_prefill_chunk(cfg, row, runtime=runtime,
                                          total_len=int(lens[b]))
            logits += decode(st, slice(b, b + 1))
        runs[dev] = torch.stack(logits)
    err = (runs[device] - runs["cpu"]).abs().max().item()
    log(f"  reduced {cfg.arch_id} ({runtime}, {admission} admission"
        f"{', ' + attn_impl if runtime == 'retro' else ''}), card vs cpu "
        f"logits: max|d| {err:.3e} (tol 1e-3)")
    if not torch.isfinite(runs[device]).all() or err > 1e-3:
        raise AssertionError(f"reduced model disagrees across devices: {err}")
    return err


def _row_cp(cp, b):
    st = cp.state
    return cp._replace(
        state=type(st)(*(t[b:b + 1] for t in st)),
        stage_k=cp.stage_k[b:b + 1], stage_v=cp.stage_v[b:b + 1],
        staged=cp.staged[b:b + 1], seen=cp.seen[b:b + 1])


# ---------------------------------------------------------------------------
# host offload
# ---------------------------------------------------------------------------

def serve_offload(cfg, prompt_lens, new_tokens, *, attn_impl="fused",
                  chunk=256, batch=2, device="cuda", seed=0,
                  min_capture_pos=4096):
    """Drive the offload path: ServeEngine(offload=True) with the config's
    cache fraction and policy, recording spans; every kernel's launch count
    is set to 0 just before the serve and read just after (``LaunchTap``:
    the capture's recorded calls added once per replayed step). Checks one
    capture of the offload stage and a replay for every later step,
    launches, requests, sizes, one ``admit_slot`` span a request and the
    control plane's counters."""
    import numpy as np
    import torch
    from repro_torch.core import attention
    from repro_torch.core.wave_index import prefill_layout
    from repro_torch.core.zones import plan_zones
    from repro_torch.kernels.wave_attention import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServeEngine

    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, gen, device)
    rng = np.random.default_rng(seed)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in zip(prompt_lens, new_tokens)]
    engine = ServeEngine(cfg, params, prefill_chunk=chunk, device=device,
                         attn_impl=attn_impl, offload=True, spans=True)
    cap = Capture(ops, attention, cfg.n_layers, cfg.layer_kinds(),
                  min_capture_pos)
    real_ops = attention.wa_ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()                                # count this path only
    attention.wa_ops = cap
    try:
        t0 = time.perf_counter()
        m = engine.serve(reqs, batch_size=batch, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attention.wa_ops = real_ops
    plane = engine.last_plane
    stage = plane.stage
    counts = cap.served({k: fn.launches for k, fn in
                         launch_counters().items()}, stage)
    peak = torch.cuda.max_memory_allocated()
    path = IMPL_KERNEL[attn_impl]
    cap.finish(path)
    if (stage.captures, stage.replays) != (1, m.steps - 1) or \
            len(stage.graphs) != cfg.n_layers + 1:
        raise AssertionError(f"offload stage: {stage.captures} captures, "
                             f"{stage.replays} replays for {m.steps} steps")
    if cap.recorded != {path: cfg.n_layers}:
        raise AssertionError(f"the capture recorded {cap.recorded}")

    want = {k: 0 for k in counts}
    want[IMPL_KERNEL[attn_impl]] = cfg.n_layers * m.steps
    if counts != want:
        raise AssertionError(f"offload kernel launches {counts} for {m.steps}"
                             f" steps x {cfg.n_layers} layers: want {want}")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or r.status != "ok" or \
                not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"offload request: {len(r.out_tokens)}/"
                                 f"{r.max_new_tokens} tokens ({r.status})")
    plan = plan_zones(max(prompt_lens), cfg.retro, engine.gen_headroom)
    want_C = max(1, min(int(engine.placement.cache_frac * plan.m_max),
                        plan.m_max))
    if (plane.M, plane.r, plane.C) != (plan.m_max, plan.r, want_C):
        raise AssertionError(f"plane sizes M {plane.M} r {plane.r} C "
                             f"{plane.C}")
    blk = plane.cache_k[0].shape
    # C + r slots and the dead slot that padded writes reach
    if tuple(blk) != (batch, cfg.n_kv_heads, plane.C + plane.r + 1,
                      cfg.retro.cluster_cap, cfg.head_dim):
        raise AssertionError(f"device block cache {tuple(blk)}")
    last = {r.slot: r for r in reqs}
    kv = engine.last_state.kv
    for slot, r in last.items():
        want_cl = prefill_layout(len(r.prompt), cfg.retro)[2]
        for st in kv:
            if int(st.length[slot]) != len(r.prompt) + r.max_new_tokens or \
                    int(st.n_clusters[slot]) != want_cl or \
                    plane.ncl[slot] != want_cl:
                raise AssertionError(f"offload slot {slot}: length "
                                     f"{int(st.length[slot])}, clusters "
                                     f"{int(st.n_clusters[slot])} / mirror "
                                     f"{plane.ncl[slot]} (want {want_cl})")
    admit_slot_s = [s.seconds for s in m.spans.records
                    if s.name == "admit_slot"]
    if len(admit_slot_s) != len(reqs) or plane.retired.lookups == 0:
        raise AssertionError("a slot's buffers were not retired on reuse")
    c = m.cache
    if c.lookups == 0 or c.bytes_over_link == 0 or c.failed_fetches or \
            m.degraded_steps:
        raise AssertionError(f"offload counters {m.cache}")
    host_bytes = sum(s.nbytes for layer in plane.layers
                     for s in layer.stores if s is not None)
    cache_bytes = sum(t.numel() * t.element_size() for ts in
                      (plane.cache_k, plane.cache_v, plane.cache_p)
                      for t in ts)
    res = dict(attn_impl=attn_impl, wall_s=wall, steps=m.steps,
               launches=counts[IMPL_KERNEL[attn_impl]], all_launches=counts,
               m_max=plane.M, r=plane.r, C=plane.C,
               graph_captures=stage.captures, graph_replays=stage.replays,
               graphs_per_step=len(stage.graphs),
               host_store_gb=host_bytes / 1e9,
               device_cache_gb=cache_bytes / 1e9, peak_mem_gib=peak / 2**30,
               held_before_gib=held / 2**30,
               admit_slot_s=admit_slot_s,
               tokens_out=m.tokens_out, prefill_tps=m.prefill_tps,
               decode_s=m.decode_s, decode_tps=m.decode_tps,
               ttft_s=[r.ttft_s for r in reqs],
               itl_p50_ms=m.itl_p50_s * 1e3, itl_p99_ms=m.itl_p99_s * 1e3,
               hit_ratio=c.hit_ratio,
               effective_hit_ratio=c.effective_hit_ratio,
               bytes_over_link=c.bytes_over_link,
               bytes_from_cache=c.bytes_from_cache,
               retries=c.retries, degraded_steps=m.degraded_steps,
               cache=dict(vars(c)))
    log(f"  offload ({attn_impl}): m_max {plane.M}, r {plane.r}, C "
        f"{plane.C}; block cache {tuple(blk)}; host store "
        f"{res['host_store_gb']:.2f} GB packed f32 (both slots), device "
        f"cache {res['device_cache_gb']:.3f} GB, peak device memory "
        f"{res['peak_mem_gib']:.2f} GiB ({res['held_before_gib']:.2f} held "
        f"before the run)")
    log(f"  decode steps {m.steps} (1 warm-up + {stage.replays} replays of "
        f"{stage.captures} captured stage, {len(stage.graphs)} graphs a "
        f"step), launches {counts} (= {cfg.n_layers} x steps of "
        f"{IMPL_KERNEL[attn_impl]}); admit_slot s "
        f"{['%.2f' % t for t in res['admit_slot_s']]}")
    log(f"  TTFT s {['%.3f' % t for t in res['ttft_s']]}; prefill "
        f"{res['prefill_tps']:.1f} tok/s; decode {res['decode_tps']:.2f} "
        f"tok/s; ITL p50/p99 {res['itl_p50_ms']:.2f}/"
        f"{res['itl_p99_ms']:.2f} ms; wall {wall:.1f} s")
    log(f"  hit ratio {res['hit_ratio']:.4f} (effective "
        f"{res['effective_hit_ratio']:.4f}), over the link "
        f"{c.bytes_over_link / 1e6:.1f} MB, from the cache "
        f"{c.bytes_from_cache / 1e6:.1f} MB, retries {c.retries}, "
        f"degraded steps {m.degraded_steps}")
    if "g" not in cap.taken:
        raise AssertionError(f"captured launches {sorted(cap.taken)}")
    return res, cap.taken, engine


def _copy_state(state):
    from repro_torch.core.wave_index import WaveState
    from repro_torch.models.transformer import ServeState
    return ServeState(kv=[WaveState(*(t.clone() for t in w))
                          for w in state.kv])


def _live_copy(state):
    """A copy of a serve state's device-resident (live) fields, the payload
    stores left out: what an offload step reads and writes."""
    from repro_torch.models.transformer import LIVE_FIELDS, ServeState
    return ServeState(kv=[w._replace(k_store=None, v_store=None,
                                     pos_store=None,
                                     **{f: getattr(w, f).clone()
                                        for f in LIVE_FIELDS})
                          for w in state.kv])


def plane_copy(engine, plane, max_ctx):
    """A new offload plane of ``engine`` (its current ``attn_impl``, its
    own stage and pinned stagings, not captured) holding a copy of
    ``plane``'s device block caches and a deep copy of every other field of
    ``plane`` (wave buffers, transport, queued admissions with their rows,
    counters, in one copy, so what they share stays shared); the host
    stores, which a decode step only reads, and the config are shared with
    ``plane``."""
    import copy
    from repro_torch.core.zones import plan_zones
    from repro_torch.serving.engine import _OffloadPlane
    new = _OffloadPlane(engine.cfg, engine.params,
                        plan_zones(max_ctx, engine.cfg.retro,
                                   engine.gen_headroom), plane.B, max_ctx,
                        attn_impl=engine.attn_impl, sample=plane.stage.sample,
                        placement=engine.placement, device=engine.device)
    memo = {id(s): s for layer in plane.layers
            for s in layer.stores if s is not None}
    memo[id(plane.cfg)] = plane.cfg
    caches = ("cache_k", "cache_v", "cache_p")
    for name, value in vars(plane).items():
        if name not in ("stage", "h_rows", "host_rows") + caches:
            setattr(new, name, copy.deepcopy(value, memo))
    for name in caches:
        for t, u in zip(getattr(new, name), getattr(plane, name)):
            t.copy_(u)
    return new


def plane_counters(plane):
    """Every wave-buffer counter of a plane, its degraded and dropped
    counts, and its bytes to the device."""
    from repro_torch.serving.engine import ServeMetrics
    m = ServeMetrics()
    plane.export_stats(m)
    return dict(cache=dict(vars(m.cache)), degraded=m.degraded_steps,
                dropped=m.dropped_cluster_steps,
                h2d_bytes=plane.counts["h2d_bytes"])


def offload_vs_direct(engine, max_ctx, steps=4):
    """From the state an offload serve left (the stores on the device are
    the admitted ones: no flush ran), decode ``steps`` steps through the
    direct ``apply_decode`` on a copy and through the serve's offload plane,
    replaying its captured stage, on the state itself. The payloads are the
    same bits, but the offload attend always carries the retrieval cover,
    as the reference does: r gated entries that add exact zeros yet
    lengthen the estimation fold, which changes the f32 rounding of the
    attention, and a changed rounding of the bf16 residual stream is one
    bf16 ulp that later layers carry to the logits. So the logits must
    agree within the reference kernel test's bf16 tolerance, |offload -
    direct| <= 3e-2 (1 + |direct|) elementwise (tests/test_kernels.py:40).
    Returns the result and the served state."""
    import numpy as np
    import torch
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    cfg, plane = engine.cfg, engine.last_plane
    plan = plan_zones(max_ctx, cfg.retro, engine.gen_headroom)
    off = engine.last_state
    direct = _copy_state(off)
    B, dev = plane.B, engine.device
    active = np.ones(B, bool)
    act = torch.ones((B,), dtype=torch.bool, device=dev)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    tokens = plane.stage.tokens              # the captured token buffer
    worst, excess, same = 0.0, -1.0, True
    with torch.inference_mode():
        for _ in range(steps):
            tokens.copy_(tok)
            a, direct = M.apply_decode(engine.params, cfg, direct, tok,
                                       plan=plan, active=act,
                                       attn_impl=engine.attn_impl)
            b, _ = plane.step(off, tokens, active)
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError("offload/direct logits not finite")
            d = (a - b).abs()
            worst = max(worst, d.max().item())
            excess = max(excess, (d - 3e-2 * (1 + a.abs())).max().item())
            same = same and bool(torch.equal(a, b))
            tok = a.argmax(-1).to(torch.int32)
    del direct
    res = dict(steps=steps, max_abs_diff=worst, tol_excess=excess,
               bit_identical=same)
    log(f"  offload vs direct, {steps} steps from one state: logits max|d| "
        f"{worst:.3e} (tol 3e-2 (1 + |direct|), worst excess {excess:.3e}), "
        f"bit-identical {same}")
    if not excess <= 0:
        raise AssertionError(f"offload and direct logits differ: {res}")
    return res, off


OFFLOAD_TIMES = (("id_wait_ms", "readback_ids"), ("translate_ms", "translate"),
                 ("h2d_staging_ms", "stage"), ("launch_ms", "launch"),
                 ("drain_ms", "drain_admissions"))


def offload_step_stats(plane, state, tokens, steps=8):
    """Where one offload decode step's time goes (both slots decoding):
    host time until ``step`` returns, split by the plane's spans into
    the id waits, the translate, the staging of the pieces' inputs (pinned
    writes and copies to the device), the launch of the pieces (replays, or
    the eager enqueue) and the drain, the rest being glue; the synced wall;
    bytes to the device; device kernel time by name from ``torch.profiler``
    (busy share over the profiled wall)."""
    import numpy as np
    import torch
    from repro_torch import spans
    active = np.ones(plane.B, bool)
    for _ in range(2):
        plane.step(state, tokens, active)
    torch.cuda.synchronize()
    h2d_before = plane.counts["h2d_bytes"]
    host, wall = [], []
    with spans.recording(plane.dev) as rec:
        for _ in range(steps):
            t0 = time.perf_counter()
            plane.step(state, tokens, active)
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
    per = {k: rec.seconds(k) / steps for _, k in OFFLOAD_TIMES}
    per["h2d_bytes"] = (plane.counts["h2d_bytes"] - h2d_before) / steps
    rows, prof_wall = _profile_rows(
        lambda: plane.step(state, tokens, active), steps)
    busy_s = sum(r[0] for r in rows) / 1e6
    host_ms = 1e3 * sum(host) / steps
    res = dict(step_host_ms=host_ms, step_wall_ms=1e3 * sum(wall) / steps)
    for name, k in OFFLOAD_TIMES:
        res[name] = 1e3 * per[k]
    res["rest_ms"] = host_ms - sum(res[n] for n, _ in OFFLOAD_TIMES)
    res.update(
        h2d_mb_per_step=per["h2d_bytes"] / 1e6,
        profiled_step_ms=1e3 * prof_wall / steps,
        device_busy_ms=1e3 * busy_s / steps,
        device_busy_share=busy_s / prof_wall,
        kernels_per_step=sum(r[2] for r in rows) / steps,
        attention_kernels={name: dict(
            ms_per_step=sum(us for us, k, _ in rows if tag in k) / 1e3 / steps,
            launches_per_step=sum(c for _, k, c in rows if tag in k) / steps)
            for name, tag in KERNEL_TAGS.items()},
        top_kernels=[dict(name=k[:90], ms_per_step=us / 1e3 / steps,
                          calls_per_step=c / steps)
                     for us, k, c in rows[:10]])
    return res


def offload_breakdown(engine, state, max_ctx, steps=4):
    """The offload decode step eagerly and replayed, in one call from one
    state: a copy of the serve's plane (host control plane and block
    caches) stepping a copy of the state's live fields through its stage
    run eagerly, then the serve's own plane replaying its captured stage
    (``offload_step_stats`` each). Then one replayed step profiled alone:
    its attention launches (split + combine per layer) are what the
    capture recorded."""
    import numpy as np
    import torch
    plane = engine.last_plane
    tokens = plane.stage.tokens
    res = {}
    with torch.inference_mode():
        eager = plane_copy(engine, plane, max_ctx)
        eager_state = _live_copy(state)
        eager_tok = tokens.clone()
        res["eager"] = offload_step_stats(eager, eager_state, eager_tok,
                                          steps)
        del eager, eager_state
        res["replay"] = offload_step_stats(plane, state, tokens, steps)
        tag = KERNEL_TAGS[IMPL_KERNEL[engine.attn_impl]]
        want = 2 * engine.cfg.n_layers
        rows, _ = _profile_rows(
            lambda: plane.step(state, tokens, np.ones(plane.B, bool)),
            1, complete=lambda rows: _launch_count(rows, tag) == want)
    n = _launch_count(rows, tag)
    res["profiled_replay"] = dict(attention_launches=n,
                                  kernels=sum(r[2] for r in rows))
    for name in ("eager", "replay"):
        r = res[name]
        log(f"  offload {name:6s} step (B={plane.B}): host "
            f"{r['step_host_ms']:.2f} ms = id wait {r['id_wait_ms']:.2f} + "
            f"translate {r['translate_ms']:.2f} + H2D staging "
            f"{r['h2d_staging_ms']:.2f} + launch {r['launch_ms']:.2f} + "
            f"drain {r['drain_ms']:.2f} + rest {r['rest_ms']:.2f}; synced "
            f"wall {r['step_wall_ms']:.2f} ms; host->device "
            f"{r['h2d_mb_per_step']:.3f} MB per step; device busy "
            f"{r['device_busy_ms']:.2f} ms ({100 * r['device_busy_share']:.1f}"
            f"% of the profiled wall), {r['kernels_per_step']:.0f} kernels")
        for k in r["top_kernels"][:6]:
            log(f"    {k['ms_per_step']:8.3f} ms/step "
                f"{k['calls_per_step']:6.1f} calls  {k['name']}")
    log(f"  one profiled replayed step: {n} attention kernel launches "
        f"(want {2 * engine.cfg.n_layers}), "
        f"{res['profiled_replay']['kernels']} kernels")
    if n != 2 * engine.cfg.n_layers:
        raise AssertionError(f"a profiled offload replay launched {n} "
                             f"attention kernels")
    return res


def compiled_offload_check(engine, state, max_ctx, steps=8):
    """Phase 10's offload part, on the state an offload serve left: for
    "fused", "pallas" and "jnp", two copies of the serve's plane (host
    control plane and block caches) and of the state's live fields; one
    plane steps eagerly, the other captures (its first step eagerly, then
    replays), ``steps`` steps each. The logits must be the same bits, the
    ids and every wave-buffer counter, degraded count and byte count the
    same; one profiled replayed step must launch 2 x layers attention
    kernels for the impls that have one."""
    import numpy as np
    import torch
    plane = engine.last_plane
    served_impl = engine.attn_impl
    active = np.ones(plane.B, bool)
    out = {}
    try:
        for impl in ("fused", "pallas", "jnp"):
            engine.attn_impl = impl
            runs = {}
            with torch.inference_mode():
                for capture in (False, True):
                    p = plane_copy(engine, plane, max_ctx)
                    st, tok = _live_copy(state), plane.stage.tokens.clone()
                    seq = []
                    step = p.decode_step if capture else p.step
                    for _ in range(steps):
                        lg, ids = step(st, tok, active)
                        seq.append((lg.clone(), ids.clone()))
                    torch.cuda.synchronize()
                    runs[capture] = (p, st, tok, seq, plane_counters(p),
                                     p.stage.replays)
                p, st, tok = runs[True][:3]
                tag = KERNEL_TAGS.get(IMPL_KERNEL.get(impl))
                want_attn = 2 * engine.cfg.n_layers if tag else 0
                rows, _ = _profile_rows(
                    lambda: p.step(st, tok, active), 1,
                    complete=lambda rows:
                    _launch_count(rows, tag) == want_attn)
            (pe, _, _, eager, ce, _), (pg, _, _, replay, cg, replays) = \
                runs[False], runs[True]
            same = all(torch.equal(a[0], b[0]) for a, b in zip(eager, replay))
            ids = all(torch.equal(a[1], b[1]) for a, b in zip(eager, replay))
            finite = all(torch.isfinite(a[0]).all() for a in replay)
            n_attn = _launch_count(rows, tag)
            name = "offload_" + impl
            out[name] = dict(
                bit_identical=same, ids_equal=ids, counters_equal=ce == cg,
                captures=pg.stage.captures, replays=replays,
                kernels_per_replay=sum(r[2] for r in rows),
                attention_launches_per_replay=n_attn,
                attention_kernel=IMPL_KERNEL.get(impl), counters=cg)
            log(f"  {name}: {steps} eager vs {steps} captured steps (1 "
                f"warm-up + {replays} replays) from one state and "
                f"one copied host plane: logits bit-identical {same}, ids "
                f"equal {ids}, counters equal {ce == cg} ("
                f"{cg['cache']['lookups']} lookups, {cg['cache']['hits']} "
                f"hits, {cg['h2d_bytes'] / 1e6:.2f} MB to the device); one "
                f"profiled replayed step: {out[name]['kernels_per_replay']} "
                f"kernels, {n_attn} attention launches (want {want_attn})")
            if not (same and ids and finite and ce == cg
                    and n_attn == want_attn and pg.stage.captures == 1
                    and replays == steps - 1):
                raise AssertionError(f"compiled offload {impl}: {out[name]}")
            del runs, pe, pg, p, st, tok, eager, replay
            torch.cuda.empty_cache()
    finally:
        engine.attn_impl = served_impl
    return out


def _serve_summary(cfg, params, impl, device, **kw):
    import numpy as np
    from repro_torch.serving.engine import Request, ServeEngine
    rng = np.random.default_rng(13)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in ((384, 8), (256, 6), (320, 136))]
    eng = ServeEngine(cfg, params, gen_headroom=256, max_context=384,
                      prefill_chunk=96, attn_impl=impl, offload=True,
                      device=device, **kw)
    m = eng.serve(reqs, batch_size=2)
    return dict(tokens=[r.out_tokens for r in reqs],
                status=[r.status for r in reqs], steps=m.steps,
                flushes=m.flushes, cache=dict(vars(m.cache)),
                degraded=m.degraded_steps, dropped=m.dropped_cluster_steps)


def _plane_logits(cfg, params, impl, device, steps=6, **kw):
    """Two requests served directly, then ``steps`` offload decode steps
    from an offload plane whose rows are admitted from that state."""
    import numpy as np
    import torch
    from repro_torch.core.wave_index import WaveState
    from repro_torch.models.transformer import ServeState
    from repro_torch.core.zones import plan_zones
    from repro_torch.serving.engine import (Request, Sampler, ServeEngine,
                                            _OffloadPlane)
    eng = ServeEngine(cfg, params, gen_headroom=256, max_context=384,
                      prefill_chunk=96, attn_impl=impl, device=device, **kw)
    rng = np.random.default_rng(1)
    eng.serve([Request(rng.integers(0, cfg.vocab, n).astype(np.int32), 2)
               for n in (384, 300)], batch_size=2)
    st = eng.last_state
    plane = _OffloadPlane(cfg, params, plan_zones(384, cfg.retro, 256), 2,
                          384, attn_impl=eng.attn_impl,
                          sample=Sampler(device=device),
                          placement=eng.placement, device=device)
    for i in range(2):
        plane.admit_slot(i, ServeState(kv=[
            WaveState(*(t[i:i + 1].clone() for t in w)) for w in st.kv]))
    tok = torch.tensor([5, 7], dtype=torch.int32, device=device)
    out = []
    with torch.inference_mode():
        for _ in range(steps):
            lg, _ = plane.step(st, tok, np.ones(2, bool))
            out.append(lg.float().cpu())
            tok = lg.argmax(-1).to(torch.int32)
    return torch.stack(out), plane.degraded_steps


def reduced_offload_across_devices(attn_impl, seed=0, device="cuda"):
    """Reduced gemma2-2b (untied head, so the greedy tokens vary) served
    with offload under a seeded fault profile and a fetch deadline, on the
    card and on the CPU: the same tokens, statuses and every wave-buffer
    counter; then offload decode logits within 1e-3."""
    import torch
    from repro_torch.configs.gemma2_2b import reduced
    from repro_torch.models import model as M
    cfg = reduced().replace(tie_embeddings=False)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
        else [to(v) for v in t] if isinstance(t, list) \
        else t.to(device) if hasattr(t, "to") else t
    card = to(cpu)
    kw = dict(cache_frac=0.25, fault_profile="transient=0.2,spike=0.1,seed=3",
              fetch_deadline_s=0.01)
    want = _serve_summary(cfg, cpu, attn_impl, "cpu", **kw)
    got = _serve_summary(cfg, card, attn_impl, device, **kw)
    lg_cpu, deg_cpu = _plane_logits(cfg, cpu, attn_impl, "cpu", **kw)
    lg_card, deg_card = _plane_logits(cfg, card, attn_impl, device, **kw)
    err = (lg_card - lg_cpu).abs().max().item()
    c = got["cache"]
    res = dict(attn_impl=attn_impl, equal=got == want, logits_err=err,
               steps=got["steps"], flushes=got["flushes"],
               degraded=got["degraded"], dropped=got["dropped"],
               faults=c["faults"], retries=c["retries"],
               failed_fetches=c["failed_fetches"], lookups=c["lookups"],
               hits=c["hits"], plane_degraded=(deg_cpu, deg_card))
    log(f"  reduced offload ({attn_impl}), card vs cpu under "
        f"'{kw['fault_profile']}', deadline {kw['fetch_deadline_s']}: tokens,"
        f" statuses and counters equal {res['equal']} ({got['steps']} steps,"
        f" {got['flushes']} flush(es), {c['lookups']} lookups, {c['hits']} "
        f"hits, {c['faults']} faults, {c['retries']} retries, "
        f"{c['failed_fetches']} failed fetches, {got['degraded']} degraded "
        f"steps); logits max|d| {err:.3e} (tol 1e-3) over steps with "
        f"{deg_card} degraded")
    if not res["equal"]:
        raise AssertionError(f"reduced offload differs across devices: "
                             f"card {got} cpu {want}")
    if not torch.isfinite(lg_card).all() or err > 1e-3 or \
            deg_card != deg_cpu or got["degraded"] == 0:
        raise AssertionError(f"reduced offload logits/degradation: {res}")
    return res


# ---------------------------------------------------------------------------
# the other dense configs' decode shapes
# ---------------------------------------------------------------------------

CONFIG_CASES = ("minitron_8b", "gemma3_1b", "mixtral_8x22b",
                "llava_next_34b", "kimi_k2_1t_a32b")
TIMED_CASES = ("mixtral_8x22b", "llava_next_34b", "kimi_k2_1t_a32b")


def config_decode_cases(ctx=8192, gen_headroom=1024):
    """(name, kwargs of ``ref.random_decode_inputs``, kwargs of
    ``ref.random_merge_inputs``, softcap) at the decode shapes of the other
    configs at full width, a ``ctx``-token context, their RetroConfig:
    minitron-8b (8 KV heads, G 4, hd 128, no softcap or window), gemma3-1b
    (one KV head, G 4, hd 256, window 512), mixtral-8x22b (8 KV heads, G 6,
    hd 128, window 4096), llava-next-34b (8 KV heads, G 7, hd 128) and
    kimi-k2 (8 KV heads, G 8, hd 128)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.zones import plan_zones
    out = []
    for arch in CONFIG_CASES:
        cfg = get_config(arch)
        a, retro = cfg.attn, cfg.retro
        plan = plan_zones(ctx, retro, gen_headroom)
        heads = dict(H=a.n_kv_heads, G=a.n_heads // a.n_kv_heads,
                     hd=a.head_dim)
        paged = dict(heads, M=plan.m_max, cap=retro.cluster_cap,
                     lbuf=plan.local_buf, r=plan.r, e=plan.e,
                     q_pos=(ctx + 30, ctx - 2000),
                     local_len=(100, plan.local_buf),
                     window=a.sliding_window and float(a.sliding_window))
        merge = dict(heads, T=plan.sink + plan.local_buf
                     + plan.r * retro.cluster_cap, E=plan.e + plan.r)
        out.append((f"{arch}_decode", paged, merge, a.softcap))
    return out


# ---------------------------------------------------------------------------
# blocking admission (phase 7)
# ---------------------------------------------------------------------------

def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _layer0_kv(params, cfg, tokens):
    """The first layer's post-RoPE K/V (B, S, Hkv, hd) of ``tokens``."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import embed_tokens
    a = cfg.attn
    lp = params["layers"][0]
    h = L.rms_norm(embed_tokens(params, cfg, tokens), lp["ln1"],
                   cfg.norm_eps)
    _, k, v = L.attention_qkv(lp["attn"], h, a.n_heads, a.n_kv_heads,
                              a.head_dim, torch.arange(tokens.shape[1],
                                                       device=tokens.device),
                              a.rope_theta)
    return k, v


def build_bit_check(params, cfg, n=9000, chunk=256, seed=3,
                    device="cuda"):
    """``prefill_build`` against the chunked builder (``chunk``-token
    chunks) on the first layer's K/V of an ``n``-token prompt, on the card:
    every field of the two states must be the same bits."""
    import numpy as np
    import torch
    from repro_torch.core import wave_index as W
    from repro_torch.core.zones import plan_zones
    from repro_torch.models.transformer import torch_dtype
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, n)).astype(np.int64)).to(device)
    with torch.inference_mode():
        k, v = _layer0_kv(params, cfg, toks)
        M_ = plan_zones(n, cfg.retro, 1024).m_max
        dt = torch_dtype(cfg)
        t0 = time.perf_counter()
        built = W.prefill_build(k, v, cfg.retro, M_, dtype=dt)
        _sync(device)
        build_s = time.perf_counter() - t0
        cp = W.init_chunked_prefill(1, cfg.n_kv_heads, cfg.head_dim, M_,
                                    cfg.retro, chunk, dt, device=device)
        for c0 in range(0, n, chunk):
            c = min(chunk, n - c0)
            pad = lambda a: torch.nn.functional.pad(
                a[:, c0:c0 + c], (0, 0, 0, 0, 0, chunk - c))
            cp = W.prefill_append_chunk(
                cp, pad(k), pad(v), cfg.retro,
                torch.full((1,), c, dtype=torch.int32, device=device))
        chunked = W.prefill_finalize(cp, cfg.retro, n)
        _sync(device)
    diff = [f for f, a, b in zip(built._fields, built, chunked)
            if not torch.equal(a, b)]
    res = dict(prompt=n, clusters=int(built.n_clusters[0]),
               fields_differing=diff, prefill_build_s=build_s)
    log(f"  prefill_build vs the chunked builder, layer 0 of a {n}-token "
        f"prompt on the card: {res['clusters']} clusters, fields that "
        f"differ: {diff or 'none'} (build {build_s:.2f} s)")
    if diff:
        raise AssertionError(f"prefill_build differs from the chunked "
                             f"build in {diff}")
    return res


def blocking_vs_chunked_logits(params, cfg, n=9000, chunk=256, seed=4,
                               gen_headroom=1024, device="cuda", patches=0):
    """First-token logits of one ``n``-token prompt through blocking
    admission (``apply_prefill``: flash attention, online softmax) and
    through chunked admission (exact chunk attention). Both compute the
    attention in f32 and round its output to the model dtype, at other
    places; in bf16 a one-ulp difference in the residual stream grows
    through the layers of a random-weight model, so the bf16 run must
    give the same greedy token (the reference's own criterion,
    tests/test_system.py:141) and its distance from the bf16 tolerance
    3e-2 (1 + |chunked|) is reported. The algorithms are held at full
    width in f32 (weights from the same seed): elementwise within
    1e-3 (1 + |chunked|). ``patches`` > 0: the prompt's first
    ``patches`` positions take seeded bf16 patch embeddings (vlm), handed
    whole to the prefill and to every chunk."""
    import numpy as np
    import torch
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, n)).astype(np.int64)).to(device)
    plan = plan_zones(n, cfg.retro, gen_headroom)
    extra = patch_extra(cfg, patches, seed, device) or {}

    def both(params, cfg):
        with torch.inference_mode():
            blk, st = M.apply_prefill(
                params, cfg, {"tokens": toks, **extra}, plan=plan,
                gen_headroom=gen_headroom,
                lengths=torch.tensor([n], device=device))
            del st
            cs = M.make_prefill_chunk_state(cfg, 1, n, chunk=chunk,
                                            gen_headroom=gen_headroom,
                                            device=device)
            for c0 in range(0, n, chunk):
                c = min(chunk, n - c0)
                t = torch.zeros((1, chunk), dtype=toks.dtype, device=device)
                t[:, :c] = toks[:, c0:c0 + c]
                chk, cs = M.apply_prefill_chunk(
                    params, cfg, {"tokens": t, **extra}, cs,
                    chunk_lens=torch.tensor([c], device=device))
            del cs
        d = (blk - chk).abs()
        return blk, chk, d.max().item()

    blk, chk, d16 = both(params, cfg)
    excess16 = ((blk - chk).abs() - 3e-2 * (1 + chk.abs())).max().item()
    same = bool((blk.argmax(-1) == chk.argmax(-1)).all())
    cfg32 = cfg.replace(dtype="float32")
    params32 = M.init_params(cfg32, torch.Generator(device=device)
                             .manual_seed(seed), device)
    blk32, chk32, d32 = both(params32, cfg32)
    del params32
    excess32 = ((blk32 - chk32).abs()
                - 1e-3 * (1 + chk32.abs())).max().item()
    res = dict(prompt=n, patches=patches, bf16_max_abs_diff=d16,
               bf16_excess_over_3e_2=excess16,
               bf16_same_argmax=same, f32_max_abs_diff=d32,
               f32_excess_over_1e_3=excess32,
               f32_same_argmax=bool((blk32.argmax(-1)
                                     == chk32.argmax(-1)).all()))
    log(f"  blocking vs chunked first-token logits ({n} tokens, {patches} "
        f"patch positions, {cfg.n_layers} layers): bf16 max|d| "
        f"{d16:.3e} (excess over 3e-2 (1 + |chunked|): {excess16:.3e}), "
        f"same argmax {same}; f32 max|d| {d32:.3e} (excess over "
        f"1e-3 (1 + |chunked|): {excess32:.3e})")
    if not (torch.isfinite(blk).all() and same and excess32 <= 0
            and res["f32_same_argmax"]):
        raise AssertionError(f"blocking and chunked logits differ: {res}")
    return res


def sparse_prefill_request(params, cfg, n=8192, blocks=16, new_tokens=8,
                           seed=5, device="cuda"):
    """One ``n``-token request served with ``sparse_prefill_blocks=blocks``
    (set here with ``cfg.replace``; the published config is dense), which
    admits through the block-sparse blocking prefill, decoding through the
    paged kernel; then its first-token logits against the dense prefill's,
    which must correlate above 0.9 (tests/test_sparse_prefill.py:75)."""
    import numpy as np
    import torch
    from repro_torch.kernels.wave_attention import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServeEngine
    scfg = cfg.replace(sparse_prefill_blocks=blocks)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, n) \
        .astype(np.int32)
    engine = ServeEngine(scfg, params, device=device, attn_impl="fused")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    req = Request(prompt, new_tokens)
    tap = LaunchTap(ops)
    m, wall, counts = tapped_serve(engine, [req], 1, tap)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: 0 for k in counts}
    want["paged_wave_attention"] = cfg.n_layers * m.steps
    if counts != want or len(req.out_tokens) != new_tokens:
        raise AssertionError(f"sparse-prefill request: launches {counts} "
                             f"(want {want}), {len(req.out_tokens)} tokens")
    toks = torch.from_numpy(prompt[None].astype(np.int64)).to(device)
    with torch.inference_mode():
        sparse, st = M.apply_prefill(params, scfg, {"tokens": toks})
        del st
        dense, st = M.apply_prefill(params, cfg, {"tokens": toks})
        del st
    corr = float(np.corrcoef(sparse.float().cpu().numpy().ravel(),
                             dense.float().cpu().numpy().ravel())[0, 1])
    res = dict(prompt=n, blocks=blocks, steps=m.steps,
               launches=counts["paged_wave_attention"], ttft_s=req.ttft_s,
               wall_s=wall, peak_mem_gib=peak, corr_vs_dense=corr)
    log(f"  block-sparse prefill ({blocks} blocks) request of {n} tokens: "
        f"TTFT {req.ttft_s:.3f} s, {m.steps} decode steps, paged launches "
        f"{res['launches']}, peak {peak:.2f} GiB; first-token logits "
        f"correlate {corr:.4f} with the dense prefill's (need > 0.9)")
    if not corr > 0.9:
        raise AssertionError(f"sparse prefill logits: correlation {corr}")
    return res


# ---------------------------------------------------------------------------
# the full runtime (phase 8)
# ---------------------------------------------------------------------------

def full_attention_check(engine, max_ctx, device="cuda"):
    """One decode step from the state the full-runtime serve left, as the
    engine's captured step runs it (the whole cache, each row's tail
    masked), with every layer's ``full_attention_decode`` held, on its own
    inputs, against an f32 softmax over each row's valid prefix (no bf16
    rounding of p), within 2e-3 (1 + |ref|) elementwise."""
    import math
    import torch
    from repro_torch.core import attention
    from repro_torch.core.zones import plan_zones
    from repro_torch.models import model as M
    cfg = engine.cfg
    kinds = cfg.layer_kinds()
    real = attention.full_attention_decode
    worst = {}
    nbytes = []

    def check(q, cache, *, window=None, softcap=None, span=None):
        if span is not None:
            raise AssertionError("the decode step read a cache prefix")
        out = real(q, cache, window=window, softcap=softcap)
        B, Hq, hd = q.shape
        Hkv = cache.k.shape[1]
        # the least bytes: each row's valid K/V read once, q, the lengths
        # and the output
        nbytes.append(2 * int(cache.length.sum()) * Hkv * hd
                      * cache.k.element_size()
                      + _nbytes(q, cache.length, out))
        qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
        for b in range(B):
            n = int(cache.length[b])
            k, v = cache.k[b, :, :n].float(), cache.v[b, :, :n].float()
            s = torch.einsum("hgd,htd->hgt", qg[b], k) / math.sqrt(hd)
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            pos = torch.arange(n, device=q.device)
            s = torch.where(pos > n - 1 - window, s, -math.inf) \
                if window is not None else s
            ref = torch.einsum("hgt,htd->hgd", torch.softmax(s, -1), v)
            ref = ref.reshape(Hq, hd)
            ex = ((out[b].float() - ref).abs()
                  - 2e-3 * (1 + ref.abs())).max().item()
            kind = kinds[len(seen) % cfg.n_layers]
            worst[kind] = max(worst.get(kind, -1.0), ex)
        seen.append(1)
        return out

    seen = []
    plan = plan_zones(max_ctx, cfg.retro, engine.gen_headroom)
    B = engine.last_state.kv[0].length.shape[0]
    tok = torch.zeros((B,), dtype=torch.int32, device=device)
    attention.full_attention_decode = check
    try:
        with torch.inference_mode():
            lg, _ = M.apply_decode(engine.params, cfg, engine.last_state,
                                   tok, runtime="full", plan=plan)
    finally:
        attention.full_attention_decode = real
    res = dict(layers=len(seen), worst_excess_by_kind=worst,
               bound_ms_per_step=bound(sum(nbytes), 0)[0])
    log(f"  full_attention_decode vs an f32 softmax over the cache prefix, "
        f"{len(seen)} layers of one decode step: worst excess over "
        f"2e-3 (1 + |ref|) by layer kind {worst}; bytes bound of the "
        f"step's attention {res['bound_ms_per_step']:.3f} ms")
    if len(seen) != cfg.n_layers or not torch.isfinite(lg).all() or \
            set(worst) != set(kinds) or max(worst.values()) > 0:
        raise AssertionError(f"full attention check: {res}")
    return res


def run_families(results):
    """Phases 14-16: the non-attention families at published width and
    depth, blocking admission (their only one). Appends each captured
    attention launch to ``results``; returns every phase's results."""
    import torch
    from repro_torch.configs.rwkv6_3b import CONFIG as RWKV
    from repro_torch.configs.whisper_tiny import CONFIG as WHISPER
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    out = {}

    def served(key, *args, **kw):
        out[key], taken, engine = serve_main_path(
            *args, admission="blocking", want_flush=False, **kw)
        return taken, engine

    # ---- phase 14: zamba2-1.2b ---------------------------------------------
    log("phase 14: serve zamba2-1.2b at published width and depth (38 "
        "layers, d_model 2048, 32/32 heads, hd 64, d_ff 8192, ssm state 64, "
        "expand 2; the shared attention block after every 6th layer: 6 "
        "sites, G 1) with blocking admission, through attn_impl='fused', "
        "'pallas' (one request) and runtime='full'")
    lens, news = (8192, 6000), (64, 32)
    taken, engine = served("serve_zamba2", ZAMBA, lens, news,
                           attn_impl="fused")
    out["zamba2_launch"] = captured_launch("zamba2", taken, "g",
                                           with_device=True)
    results["paged_wave_attention"].append(out["zamba2_launch"])
    del taken
    log("  decode-step breakdown (after the run, both slots decoding)")
    out["decode_breakdown_zamba2"] = decode_breakdown(engine)
    log("  the compiled decode stage at zamba2's width, on the run's state: "
        "eager vs replayed steps (fused, pallas)")
    out["compiled_step_zamba2"] = family_compiled_check(
        engine, max(lens), ("fused", "pallas"))
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    taken, engine = served("serve_zamba2_pallas", ZAMBA, lens[:1], (32,),
                           attn_impl="pallas", batch=1, params=params)
    out["zamba2_merge_launch"] = captured_launch(
        "zamba2_merge", taken, "g", op="wave_attention_merge",
        with_device=True)
    results["wave_attention_merge"].append(out["zamba2_merge_launch"])
    del taken, engine
    torch.cuda.empty_cache()
    _, engine = served("serve_zamba2_full", ZAMBA, lens, news,
                       runtime="full", params=params)
    del engine, params
    torch.cuda.empty_cache()
    out["reduced_zamba2_card_vs_cpu"] = reduced_family_across_devices(
        "zamba2_1p2b")

    # ---- phase 15: rwkv6-3b ------------------------------------------------
    log("phase 15: serve rwkv6-3b at published width and depth (32 layers, "
        "d_model 2560, d_ff 8960, head_dim 64, vocab 65536; attention-free) "
        "with blocking admission")
    lens = (4096, 3000)
    _, engine = served("serve_rwkv6", RWKV, lens, news, attn_impl="fused")
    log("  decode-step breakdown (after the run, both slots decoding)")
    out["decode_breakdown_rwkv6"] = decode_breakdown(engine)
    log("  the compiled decode stage at rwkv6's width, on the run's state: "
        "eager vs replayed steps")
    out["compiled_step_rwkv6"] = family_compiled_check(engine, max(lens),
                                                       ("jnp",))
    del engine
    torch.cuda.empty_cache()
    out["reduced_rwkv6_card_vs_cpu"] = reduced_family_across_devices(
        "rwkv6_3b")

    # ---- phase 16: whisper-tiny --------------------------------------------
    log("phase 16: serve whisper-tiny at published width and depth (4 + 4 "
        "layers, d_model 384, 6/6 heads, hd 64, G 1; 1500 encoder frames of "
        "seeded bf16 stub embeddings a request) with blocking admission, "
        "through attn_impl='fused' and runtime='full'")
    lens, news = (448, 300), (32, 24)
    taken, engine = served("serve_whisper", WHISPER, lens, news,
                           attn_impl="fused", min_capture_pos=256)
    out["whisper_launch"] = captured_launch("whisper", taken, "g",
                                            with_device=True)
    results["paged_wave_attention"].append(out["whisper_launch"])
    del taken
    log("  decode-step breakdown (after the run, both slots decoding)")
    out["decode_breakdown_whisper"] = decode_breakdown(engine)
    log("  the compiled decode stage at whisper's width, on the run's "
        "state: eager vs replayed steps")
    out["compiled_step_whisper"] = family_compiled_check(engine, max(lens),
                                                         ("fused",))
    params = engine.params
    del engine
    _, engine = served("serve_whisper_full", WHISPER, lens, news,
                       runtime="full", params=params)
    del engine, params
    torch.cuda.empty_cache()
    out["reduced_whisper_card_vs_cpu"] = reduced_family_across_devices(
        "whisper_tiny")
    for name, key in (("zamba2 fused, phase 14", "serve_zamba2"),
                      ("zamba2 pallas, phase 14", "serve_zamba2_pallas"),
                      ("zamba2 full, phase 14", "serve_zamba2_full"),
                      ("rwkv6, phase 15", "serve_rwkv6"),
                      ("whisper fused, phase 16", "serve_whisper"),
                      ("whisper full, phase 16", "serve_whisper_full")):
        r = out[key]
        log(f"  {name}: decode {r['decode_tps']:.2f} tok/s, ITL p50/p99 "
            f"{r['itl_p50_ms']:.2f}/{r['itl_p99_ms']:.2f} ms, TTFT s "
            f"{['%.2f' % t for t in r['ttft_s']]}, prefill "
            f"{r['prefill_s']:.2f} s, peak {r['peak_mem_gib']:.2f} GiB "
            f"({r['held_before_gib']:.2f} held before)")
    return out


# ---------------------------------------------------------------------------
# training (phase 17) and sampling (phase 18)
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12                # H100 SXM, bf16 tensor cores, dense
TRAIN_B, TRAIN_T, TRAIN_STEPS = 2, 1024, 8


def _to_device(state, device):
    """A ``TrainState`` copied to ``device`` (grad flags kept)."""
    from repro_torch.training.optimizer import tree_map
    return tree_map(lambda t: t.detach().to(device).requires_grad_(
        t.requires_grad), state)


def _tree_err(got, want, per_leaf_max):
    """max over leaves of |got - want| / (1 + |want|) (elementwise) or
    / (1 + max |want|) (``per_leaf_max``), on the CPU in f64."""
    from repro_torch.training.optimizer import tree_leaves
    err = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        scale = 1 + (w.abs().max() if per_leaf_max else w.abs())
        err = max(err, float(((g - w).abs() / scale).max()))
    return err


def training_across_devices(seed=0, B=2, T=256):
    """Phase 17a: reduced gemma2-2b in f32 on the card against the same
    model on the CPU, from one initial state and one batch: the loss within
    1e-5 (1 + |cpu|), every grad leaf within 1e-4 (1 + max |cpu|), and one
    AdamW step of the card's grads on each device (parameters and moments
    within 1e-5 (1 + |cpu|)); then a checkpoint of the card's state
    written and restored bit for bit."""
    import shutil
    import torch
    from repro_torch.configs.gemma2_2b import reduced
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                tree_leaves, tree_map)
    from repro_torch.training.train_loop import (batch_to_device,
                                                 init_train_state,
                                                 loss_and_grads)
    cfg = reduced()
    cpu = init_train_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    card = _to_device(cpu, "cuda")
    batch = next(lm_batches(cfg, B, T, seed=seed))
    loss_c, g_c = loss_and_grads(cfg, cpu.params,
                                 batch_to_device(batch, "cpu"))
    loss_g, g_g = loss_and_grads(cfg, card.params,
                                 batch_to_device(batch, "cuda"))
    res = dict(loss_cpu=float(loss_c), loss_card=float(loss_g))
    res["loss_err"] = abs(res["loss_card"] - res["loss_cpu"]) \
        / (1 + abs(res["loss_cpu"]))
    res["grad_err"] = _tree_err(g_g, g_c, per_leaf_max=True)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    adamw_update(opt, g_g, card.opt, card.params)
    adamw_update(opt, tree_map(lambda t: t.cpu(), g_g), cpu.opt, cpu.params)
    res["step_param_err"] = _tree_err(card.params, cpu.params, False)
    res["step_moment_err"] = max(_tree_err(card.opt.mu, cpu.opt.mu, False),
                                 _tree_err(card.opt.nu, cpu.opt.nu, False))
    path = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(path, ignore_errors=True)
    ckpt.save(str(path), card, step=1)
    restored, step = ckpt.restore(str(path), card)
    shutil.rmtree(path)
    a, b = tree_leaves(card), tree_leaves(restored)
    res["checkpoint_leaves"] = len(a)
    res["checkpoint_bit_equal"] = step == 1 and len(a) == len(b) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for x, y in zip(a, b))
    log(f"  reduced gemma2-2b f32, card vs CPU: loss {res['loss_card']:.6f} "
        f"vs {res['loss_cpu']:.6f} (err {res['loss_err']:.2e}, tol 1e-5), "
        f"grads {res['grad_err']:.2e} (tol 1e-4), AdamW step params "
        f"{res['step_param_err']:.2e} / moments {res['step_moment_err']:.2e}"
        f" (tol 1e-5); checkpoint of {len(a)} leaves round trip bit-equal "
        f"{res['checkpoint_bit_equal']}")
    if not (res["loss_err"] <= 1e-5 and res["grad_err"] <= 1e-4
            and res["step_param_err"] <= 1e-5
            and res["step_moment_err"] <= 1e-5
            and res["checkpoint_bit_equal"]):
        raise AssertionError(f"training card vs cpu: {res}")
    return res


def train_full_width(cfg, steps=TRAIN_STEPS, B=TRAIN_B, T=TRAIN_T, seed=0):
    """Phase 17b: ``train`` at full width and depth in bf16 on
    ``lm_batches(seed=0)`` (made before the clock starts), metrics read
    back every step: each step's synced wall time, tokens/s over the steps
    after the first, the loss curve, peak memory beside its reckoning and
    the step beside its compute bound (6 x params x tokens at the card's
    dense bf16 peak)."""
    import math
    import torch
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import init_train_state, train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(device="cuda")
                             .manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in tree_leaves(state.params))
    data = lm_batches(cfg, B, T, seed=0)
    batches = [next(data) for _ in range(steps)]
    stamps, hist = [], []

    def stamp(i, m):                    # after the step's metrics readback
        stamps.append(time.perf_counter())
        hist.append(m)

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    state, _ = train(cfg, AdamWConfig(lr=3e-4, warmup_steps=2,
                                      total_steps=steps),
                     iter(batches), steps, log_every=1, callback=stamp,
                     device="cuda", state=state)
    step_ms = [(b - a) * 1e3 for a, b in zip([t_start] + stamps, stamps)]
    peak = torch.cuda.max_memory_allocated()
    later = step_ms[1:]
    tok_s = B * T * len(later) / (sum(later) / 1e3)
    bound_ms = 6 * n * B * T / BF16_FLOPS * 1e3
    gb = 1e9
    reck = dict(params_gb=2 * n / gb, grads_gb=2 * n / gb,
                moments_gb=8 * n / gb, logits_f32_gb=4 * B * T * cfg.vocab
                / gb)
    reck["state_gb"] = reck["params_gb"] + reck["grads_gb"] \
        + reck["moments_gb"]
    res = dict(arch=cfg.arch_id, params=n, batch=B, seq=T, steps=steps,
               init_s=init_s, step_ms=step_ms,
               step_ms_mean_after_first=sum(later) / len(later),
               tokens_per_s=tok_s, loss=[m["loss"] for m in hist],
               grad_norm=[m["grad_norm"] for m in hist],
               lr=[m["lr"] for m in hist], peak_mem_gb=peak / gb,
               held_before_gb=held / gb, reckoning=reck,
               compute_bound_ms=bound_ms,
               flops_per_step=6 * n * B * T)
    log(f"  {cfg.arch_id} bf16, {n / 1e9:.3f} B params, B {B} x T {T}: "
        f"init {init_s:.1f} s; step ms {['%.1f' % t for t in step_ms]}; "
        f"mean after step 0 {res['step_ms_mean_after_first']:.1f} ms "
        f"(compute bound {bound_ms:.1f} ms: 6 x {n / 1e9:.3f}e9 x {B * T} "
        f"= {6 * n * B * T:.3e} FLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s "
        f"bf16); {tok_s:.0f} tokens/s")
    log(f"  loss {['%.4f' % l for l in res['loss']]}; grad norm "
        f"{['%.3f' % g for g in res['grad_norm']]}")
    log(f"  peak memory {peak / gb:.2f} GB ({held / gb:.2f} held before); "
        f"reckoning: bf16 params {reck['params_gb']:.1f} + bf16 grads "
        f"{reck['grads_gb']:.1f} + f32 moments {reck['moments_gb']:.1f} = "
        f"{reck['state_gb']:.1f} GB, + f32 logits {reck['logits_f32_gb']:.1f}"
        f" GB a copy, + one layer's recompute: expected 40-50 GB")
    bad = [i for i, m in enumerate(hist)
           if not (math.isfinite(m["loss"]) and m["loss"] > 0
                   and math.isfinite(m["grad_norm"]) and m["grad_norm"] > 0)]
    if bad or len(hist) != steps:
        raise AssertionError(f"training steps {bad} not finite and positive: "
                             f"{hist}")
    res["breakdown"] = train_breakdown(cfg, state, batches[0])
    del state
    torch.cuda.empty_cache()
    return res


KERNEL_GROUPS = (("gemm", ("gemm", "xmma", "cutlass", "sm90", "nvjet")),
                 ("softmax", ("softmax",)),
                 ("reduce", ("reduce",)),
                 ("index", ("index", "scatter", "gather", "embedding")),
                 ("copy", ("copy", "cat", "fill")))


def _kernel_group(name):
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise/other"


def train_breakdown(cfg, state, batch, steps=2):
    """Where a training step's time goes, after ``train``: the host's time
    to enqueue a step (no sync) against the synced wall, the device's
    kernel time by group over one profiled step, and the AdamW update
    alone (enqueue and synced wall) on one step's grads."""
    import torch
    from repro_torch.training.optimizer import AdamWConfig, adamw_update
    from repro_torch.training.train_loop import (batch_to_device,
                                                 loss_and_grads,
                                                 make_train_step)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    step = make_train_step(cfg, opt)
    tb = batch_to_device(batch, "cuda")
    enq, wall = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, tb)
        enq.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    rows, prof_wall = _profile_rows(lambda: step(state, tb), 1)
    busy_ms = sum(r[0] for r in rows) / 1e3
    groups = {}
    for us, name, count in rows:
        g = groups.setdefault(_kernel_group(name), [0.0, 0])
        g[0] += us / 1e3
        g[1] += count
    _, grads = loss_and_grads(cfg, state.params, tb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adamw_update(opt, grads, state.opt, state.params)
    opt_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    opt_wall = time.perf_counter() - t0
    del grads
    res = dict(enqueue_ms=1e3 * sum(enq) / steps,
               wall_ms=1e3 * sum(wall) / steps,
               profiled_wall_ms=prof_wall * 1e3, device_busy_ms=busy_ms,
               kernels=sum(r[2] for r in rows),
               groups={k: dict(ms=v[0], kernels=v[1])
                       for k, v in sorted(groups.items(),
                                          key=lambda kv: -kv[1][0])},
               top=[(round(us / 1e3, 3), name[:80], n)
                    for us, name, n in rows[:10]],
               adamw_enqueue_ms=opt_enq * 1e3, adamw_wall_ms=opt_wall * 1e3)
    log(f"  one step: host enqueue {res['enqueue_ms']:.1f} ms, synced wall "
        f"{res['wall_ms']:.1f} ms; profiled: device busy {busy_ms:.1f} ms of "
        f"{res['profiled_wall_ms']:.1f} ms, {res['kernels']} kernels; AdamW "
        f"alone: enqueue {res['adamw_enqueue_ms']:.1f} ms, synced "
        f"{res['adamw_wall_ms']:.1f} ms")
    log("  device ms by group: " + ", ".join(
        f"{k} {v['ms']:.1f} ({v['kernels']})"
        for k, v in res["groups"].items()))
    for ms, name, n in res["top"]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {name}")
    return res


def train_one_step(cfg, B=1, T=512, seed=0):
    """Phase 17c: one ``make_train_step`` step at full width (T 512: the
    recurrences' chunked remat runs, two 256-step chunks), synced."""
    import math
    import torch
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import (batch_to_device,
                                                 init_train_state,
                                                 make_train_step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device="cuda")
                             .manual_seed(seed), "cuda")
    n = sum(p.numel() for p in tree_leaves(state.params))
    batch = batch_to_device(next(lm_batches(cfg, B, T, seed=0)), "cuda")
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=2,
                                            total_steps=8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    m = {k: float(v) for k, v in m.items()}
    step_s = time.perf_counter() - t0
    res = dict(arch=cfg.arch_id, params=n, batch=B, seq=T, step_s=step_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **m)
    log(f"  {cfg.arch_id} bf16, {n / 1e9:.3f} B params, B {B} x T {T}: one "
        f"step {step_s:.2f} s, loss {m['loss']:.4f}, grad norm "
        f"{m['grad_norm']:.3f}, peak {res['peak_mem_gb']:.2f} GB")
    if not (math.isfinite(m["loss"]) and m["loss"] > 0
            and math.isfinite(m["grad_norm"])):
        raise AssertionError(f"{cfg.arch_id} training step: {res}")
    del state
    torch.cuda.empty_cache()
    return res


def run_training():
    """Phase 17: the training path on the card."""
    from repro_torch.configs.gemma2_2b import CONFIG as GEMMA
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    log("phase 17: training: reduced gemma2-2b card vs CPU (f32) and a "
        "checkpoint round trip; gemma2-2b at full width and depth in bf16, "
        f"{TRAIN_STEPS} steps of train at B {TRAIN_B} x T {TRAIN_T}; one "
        "step of zamba2-1.2b at full width (B 1 x T 512)")
    reset_launches()
    out = dict(card_vs_cpu=training_across_devices())
    out["gemma2_2b"] = train_full_width(GEMMA)
    out["zamba2_1p2b"] = train_one_step(ZAMBA)
    out["launches"] = {k: fn.launches for k, fn in launch_counters().items()}
    log(f"  kernel launches while training: {out['launches']} (attention "
        f"is plain torch in both packages)")
    if any(out["launches"].values()):
        raise AssertionError(f"training launched {out['launches']}")
    return out


def sampled_compiled_check(engine, max_ctx, steps=8, seed=7,
                           temperature=None):
    """Phase 18: the captured decode step at ``temperature`` (default the
    engine's) on the state the sampled serve left: a ``DecodeGraph`` whose
    sampler's generator is registered with the graph; ``steps`` eager
    steps, then (state, tokens and generator rewound to one saved state)
    one capture and ``steps`` replays: the same logits bits and ids
    (``replay_vs_eager``). Also counts the distinct ids the replays drew
    (fresh numbers each replay make them differ at a high temperature)."""
    import numpy as np
    import torch
    from repro_torch.core.zones import plan_zones
    from repro_torch.serving.engine import Sampler, _DirectStore
    from repro_torch.serving.graphs import leaves
    cfg, state = engine.cfg, engine.last_state
    B = engine.last_graph.tokens.shape[0]
    plan = plan_zones(max_ctx, cfg.retro, engine.gen_headroom)
    temperature = engine.temperature if temperature is None else temperature
    sampler = Sampler(temperature, seed, engine.device)
    with torch.inference_mode():
        saved = [t.clone() for t in leaves(state)]
    rng0 = sampler.generator.get_state()
    first = torch.tensor([1, 2], dtype=torch.int32,
                         device=engine.device)[:B]

    def restore(graph):
        for t, sv in zip(leaves(state), saved):
            t.copy_(sv)
        graph.tokens.copy_(first)
        sampler.generator.set_state(rng0)

    graph = _DirectStore(cfg, engine.params, plan, state, first.clone(),
                         sampler, runtime=engine.runtime,
                         attn_impl=engine.attn_impl,
                         key=(B, max_ctx, "fused", "sampled")).graph
    ids = []
    real = graph.step

    def step(act):                      # the replays' ids, as drawn
        out = real(act)
        if graph.graph is not None:
            ids.append(out[1].clone())
        return out

    graph.step = step
    res = replay_vs_eager(graph, restore, np.ones(B, bool), steps,
                          KERNEL_TAGS["paged_wave_attention"],
                          2 * cfg.n_layers, f"sampled fused at T {temperature}")
    res["temperature"] = temperature
    res["distinct_replay_ids"] = len({i for t in ids for i in t.tolist()})
    log(f"  {res['distinct_replay_ids']} distinct ids over the replays")
    del graph, saved
    torch.cuda.empty_cache()
    return res


def run_sampling(cfg, greedy_path):
    """Phase 18: full-width gemma2-2b served through ``fused`` at a
    temperature (blocking admission), each serve checked as the main path
    is (one capture, a replay for every later step, launches, every id in
    the vocabulary); the captured sampled step replays equal to eager with
    the generator rewound; one seed twice gives one token stream; at
    ``temperature=0`` the engine serves the greedy engine's tokens (the
    engine of ``greedy_path``'s phase, built without a temperature)."""
    import torch
    from repro_torch.models import model as M
    log("phase 18: serve gemma2-2b at full width through attn_impl='fused' "
        "at temperature 0.7 (blocking admission; prompts 8192 / 6000 "
        "generating 32 / 24)")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    lens, news = (8192, 6000), (32, 24)
    kw = dict(admission="blocking", want_flush=False, params=params)
    out = {}
    out["serve"], taken, engine = serve_main_path(cfg, lens, news,
                                                  temperature=0.7,
                                                  serve_seed=1, **kw)
    del taken
    out["compiled"] = sampled_compiled_check(engine, max(lens))
    # near-uniform draws: every replay must draw fresh numbers
    out["compiled_hot"] = sampled_compiled_check(engine, max(lens),
                                                 temperature=1e4)
    if out["compiled_hot"]["distinct_replay_ids"] < 2:
        raise AssertionError(f"replays drew the same ids: "
                             f"{out['compiled_hot']}")
    del engine
    torch.cuda.empty_cache()

    def tokens_of(**k):                 # a serve's results, its state freed
        res, taken, engine = serve_main_path(cfg, lens, news, **k, **kw)
        del taken, engine
        torch.cuda.empty_cache()
        return res

    again = tokens_of(temperature=0.7, serve_seed=1)
    zero = tokens_of(temperature=0.0, serve_seed=5)
    greedy = tokens_of()
    out["same_seed_same_tokens"] = again["tokens"] == out["serve"]["tokens"]
    out["zero_is_greedy"] = zero["tokens"] == greedy["tokens"]
    out["distinct_sampled_ids"] = len({t for r in out["serve"]["tokens"]
                                       for t in r})
    out["greedy_serve"] = greedy
    log(f"  sampled tokens (seed 1) {out['serve']['tokens'][0][:12]}...; "
        f"{out['distinct_sampled_ids']} distinct ids; the same seed again "
        f"gives the same tokens {out['same_seed_same_tokens']}; "
        f"temperature=0 gives the greedy engine's tokens "
        f"{out['zero_is_greedy']} ({greedy_path})")
    if not (out["same_seed_same_tokens"] and out["zero_is_greedy"]):
        raise AssertionError(f"sampling: {out}")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the step functions (phase 19) and sharded retrieval (phase 20)
# ---------------------------------------------------------------------------

STEP_T, STEP_STEPS, STEP_TRAIN_T = 8192, 16, 1024
SPLIT_TOL = 1e-4            # tests/test_system.py:519-533 (atol and rtol)
SHARD_FULL_N, SHARD_LONG_N, SHARD_RANKS = 16384, 524288, 2


def _synced_ms(fn):
    """``fn()`` between two CUDA events, synced: -> (its result, ms)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def step_functions(cfg, T=STEP_T, steps=STEP_STEPS, train_T=STEP_TRAIN_T,
                  seed=0, device="cuda"):
    """Phase 19: the step functions of ``serving/steps.py`` at ``cfg``'s
    width through the paged kernel: ``make_step``'s prefill step (B 1 x
    T), ``steps`` decode steps through ``make_serve_step`` and, from a copy
    of the same prefilled state and on the same tokens, through
    ``make_serve_step_split``: logits within ``SPLIT_TOL``, the cold tensors
    bit for bit as before, the hot ones equal to the monolithic state's,
    attention-layers x steps paged launches each; then one ``make_step``
    train step (B 1 x ``train_T``) and the dry-run of ``cfg`` x decode_32k
    on one H100, traced on the host's CPU."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import materialize_batch
    from repro_torch.kernels.wave_attention import ops
    from repro_torch.launch.dryrun import lower_one
    from repro_torch.models import model as M
    from repro_torch.models.transformer import HOT_FIELDS, split_state
    from repro_torch.serving.steps import (make_serve_step,
                                           make_serve_step_split, make_step)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import init_train_state
    cfg = cfg.replace(retro=dataclasses.replace(cfg.retro, attn_impl="fused"))
    gen = lambda: torch.Generator(device=device).manual_seed(seed)
    n_attn = len(attn_kinds(cfg))
    params = M.init_params(cfg, gen(), device)
    shape = InputShape(f"prefill_{T}", T, 1, "prefill")
    batch = materialize_batch(cfg, shape, gen(), device)
    reset_launches()
    (logits, state), prefill_ms = _synced_ms(
        lambda: make_step(cfg, shape)(params, batch))
    if not bool(torch.isfinite(logits).all()) or logits.shape != (1, cfg.vocab):
        raise AssertionError(f"prefill step logits {tuple(logits.shape)}")
    mono = _copy_state(state)
    cold, hot = split_state(state.kv)
    before = [{k: t.clone() for k, t in c.items()} for c in cold]
    serve = make_serve_step(cfg, T)
    split = make_serve_step_split(cfg, T)
    tok = logits.argmax(-1).to(torch.int32)
    toks, mono_lg, mono_ms = [], [], []
    reset_launches()
    for _ in range(steps):
        toks.append(tok)
        (lg, mono), ms = _synced_ms(lambda: serve(params, mono, tok))
        mono_lg.append(lg)
        mono_ms.append(ms)
        tok = lg.argmax(-1).to(torch.int32)
    mono_launches = ops.paged_wave_attention.launches
    reset_launches()
    split_ms, err, close = [], 0.0, True
    for i in range(steps):
        (lg, hot), ms = _synced_ms(lambda: split(params, cold, hot, toks[i]))
        split_ms.append(ms)
        err = max(err, float((lg - mono_lg[i]).abs().max()))
        close &= bool(torch.allclose(lg, mono_lg[i], atol=SPLIT_TOL,
                                     rtol=SPLIT_TOL))
    split_launches = ops.paged_wave_attention.launches
    cold_same = all(torch.equal(c[k], b[k]) for c, b in zip(cold, before)
                    for k in c)
    hot_same = all(torch.equal(h[k], getattr(st, k))
                   for h, st in zip(hot, mono.kv) for k in HOT_FIELDS)
    mean = lambda xs: sum(xs[1:]) / max(len(xs) - 1, 1)
    out = dict(arch=cfg.arch_id, prompt=T, steps=steps, prefill_ms=prefill_ms,
               mono_ms=mono_ms, split_ms=split_ms,
               mono_ms_mean=mean(mono_ms), split_ms_mean=mean(split_ms),
               max_abs_diff=err, within_tol=close, cold_bit_identical=cold_same,
               hot_equal=hot_same, mono_launches=mono_launches,
               split_launches=split_launches,
               want_launches=n_attn * steps)
    log(f"  prefill step B 1 x T {T}: {prefill_ms:.2f} ms; decode ms per step "
        f"(steps 2-{steps}, synced, CUDA events): monolithic "
        f"{out['mono_ms_mean']:.2f}, split {out['split_ms_mean']:.2f}")
    log(f"  split vs monolithic logits: max |diff| {err:.3e} (tol "
        f"{SPLIT_TOL} atol and rtol: {close}); cold tensors bit-identical: "
        f"{cold_same}; hot tensors equal: {hot_same}; paged launches "
        f"monolithic {mono_launches}, split {split_launches} (want "
        f"{n_attn} x {steps} = {n_attn * steps})")
    if not (close and cold_same and hot_same
            and mono_launches == split_launches == n_attn * steps):
        raise AssertionError(f"split decode step: {out}")
    del params, state, mono, cold, hot, before, mono_lg, logits, lg
    torch.cuda.empty_cache()

    tshape = InputShape(f"train_{train_T}", train_T, 1, "train")
    ts = init_train_state(cfg, gen(), device)
    tbatch = materialize_batch(cfg, tshape, gen(), device)
    train = make_step(cfg, tshape, opt_cfg=AdamWConfig(
        lr=3e-4, warmup_steps=2, total_steps=8))
    (ts, m), train_ms = _synced_ms(lambda: train(ts, tbatch))
    out["train_ms"], out["train_loss"] = train_ms, float(m["loss"])
    log(f"  train step B 1 x T {train_T}: {train_ms:.2f} ms (first step, "
        f"synced), loss {out['train_loss']:.4f}")
    if not math.isfinite(out["train_loss"]):
        raise AssertionError(f"train step loss {out['train_loss']}")
    del ts, tbatch, m
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec = lower_one("gemma2_2b", "decode_32k", mesh="h100", verbose=False)
    out["dryrun"] = rec
    log(f"  dryrun gemma2-2b x decode_32k on one H100 (the host's CPU, "
        f"{time.perf_counter() - t0:.1f} s): {rec['flops_per_chip']:.4e} "
        f"FLOP (model_flops {rec['model_flops_global']:.4e}), "
        f"{rec['bytes_per_chip']:.4e} B unfused, terms compute "
        f"{rec['compute_s'] * 1e3:.3f} ms, memory {rec['memory_s'] * 1e3:.3f}"
        f" ms, collective {rec['collective_s'] * 1e3:.3f} ms "
        f"(H100 data sheet rates), dominant {rec['dominant']}")
    if not rec["flops_per_chip"] > rec["model_flops_global"] > 0:
        raise AssertionError(f"dryrun: {rec}")
    return out


def _phase20_rank(rank, n, cases, retro, softcap, reps):
    """One gloo rank of phase 20 on cuda:0: ``distributed_wave_attention``
    over its block of each case's state (the parent's tensors, shared by
    IPC), then on the long case the rank's pieces timed with CUDA events
    (``reps`` calls each): its ranking, its attend (partial merge) and both
    reductions."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.core.attention import (wave_attention_attend,
                                            wave_decode_rank)
    out = {}
    probe = torch.full((4,), float(rank), device="cuda")
    try:
        dist.all_reduce(probe, op=dist.ReduceOp.MAX)
        out["gloo_cuda_max"] = bool((probe == n - 1).all())
    except Exception as e:  # noqa: BLE001 — reported, not relied on
        out["gloo_cuda_max"] = f"{type(e).__name__}: {str(e)[:160]}"
    for name, (q, state, plan) in cases.items():
        shard = D.shard_state(state, rank, n)
        out[name] = D.distributed_wave_attention(
            q, shard, retro, plan, softcap=softcap).cpu()
    q, state, plan = cases["long"]
    shard = D.shard_state(state, rank, n)
    m_loc = shard.centroid.shape[2]
    lp = D.shard_plan(plan, n, m_loc)
    B, Hq, hd = q.shape
    qg = q.reshape(B, shard.centroid.shape[1], -1, hd)
    pieces = dict(
        rank=lambda: wave_decode_rank(qg, shard, retro, lp, softcap=softcap,
                                      cluster_offset=rank * m_loc),
        attend=lambda: wave_attention_attend(
            q, shard, retro, lp, *ranked, softcap=softcap,
            include_steady=rank == 0, return_parts=True),
        reductions=lambda: D.merge_parts(*parts[:3]),
        total=lambda: D.distributed_wave_attention(q, shard, retro, plan,
                                                   softcap=softcap))
    ranked = pieces["rank"]()
    parts = pieces["attend"]()
    for name, fn in pieces.items():
        fn()
        dist.barrier()
        out[f"{name}_ms"] = sum(_synced_ms(fn)[1] for _ in range(reps)) / reps
    out["m_loc"], out["r_loc"], out["e_loc"] = m_loc, lp.r, lp.e
    return out


def sharded_retrieval(cfg, full_n=SHARD_FULL_N, long_n=SHARD_LONG_N,
                      n_ranks=SHARD_RANKS, seed=0, reps=10, device="cuda"):
    """Phase 20: sharded retrieval on one global layer of ``cfg`` (B 1),
    ``n_ranks`` gloo ranks on ``device`` spawned with a deadline, each
    holding its ``shard_state`` block of the clusters: at ``full_n`` tokens
    with r = every local cluster and e = 0 it must match serial
    ``wave_attention_decode`` within 1e-4; at ``long_n`` tokens (clustered
    keys, the default plan) its error against full attention must be at
    most 2x the serial path's plus 1e-3 (the reference's bound). Then
    perfcmp's three modes timed on the card: full, baseline (serial, jnp
    and fused, the fused one held against its twin and against jnp), dist
    (per rank: ranking, attend, both reductions)."""
    import dataclasses
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.attention import DenseCache
    from repro_torch.core.wave_index import prefill_build
    from repro_torch.core.zones import plan_zones
    from repro_torch.data.pipeline import clustered_keys
    from repro_torch.kernels.wave_attention import ops
    from repro_torch.launch.perfcmp import mode_step
    a = cfg.attn
    Hkv, Hq, hd, softcap = a.n_kv_heads, a.n_heads, a.head_dim, a.softcap
    bf16 = getattr(torch, cfg.dtype)
    retro = dataclasses.replace(cfg.retro, serial_prefill_segments=True)
    g = torch.Generator(device=device).manual_seed(seed)
    # q in f32 holding bf16 values: outputs compared in f32, not rounded
    q_of = lambda t: t.to(bf16).float()

    k = torch.randn((1, full_n, Hkv, hd), generator=g, device=device).to(bf16)
    v = torch.randn((1, full_n, Hkv, hd), generator=g, device=device).to(bf16)
    plan1 = plan_zones(full_n, retro, 1024)
    st1 = prefill_build(k, v, retro, plan1.m_max, dtype=bf16)
    del k, v
    pf = plan1._replace(r=plan1.m_max, e=0)
    q1 = q_of(torch.randn((1, Hq, hd), generator=g, device=device))
    serial1 = mode_step("baseline", cfg.replace(retro=retro), pf)(q1, st1)

    keys, qv, _ = clustered_keys(long_n, hd, n_hot=6, seed=seed + 1)
    vals = np.random.default_rng(seed).standard_normal((long_n, hd),
                                                       dtype=np.float32)
    per_head = lambda x: torch.from_numpy(x).to(device).to(bf16)[None, :, None] \
        .expand(1, long_n, Hkv, hd).contiguous()
    k, v = per_head(keys), per_head(vals)
    del keys, vals
    t0 = time.perf_counter()
    plan2 = plan_zones(long_n, retro, 1024)
    st2 = prefill_build(k, v, retro, plan2.m_max, dtype=bf16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cache = DenseCache(k.transpose(1, 2).contiguous(),
                       v.transpose(1, 2).contiguous(),
                       torch.full((1,), long_n, dtype=torch.int32,
                                  device=device))
    del k, v
    q2 = q_of(torch.from_numpy(qv).to(device)[None, None].expand(1, Hq, hd))
    cfg2 = cfg.replace(retro=retro)
    full = mode_step("full", cfg2, plan2)(q2, cache)
    serial2 = mode_step("baseline", cfg2, plan2)(q2, st2)
    t0 = time.perf_counter()
    ranks = D.run_ranks(_phase20_rank, n_ranks,
                        ({"full": (q1, st1, pf), "long": (q2, st2, plan2)},
                         retro, softcap, reps), backend="gloo", timeout=300)
    ranks_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    err_full = max(float((r["full"].to(device) - serial1).abs().max())
                   for r in ranks)
    same = all(torch.equal(r["full"], ranks[0]["full"])
               and torch.equal(r["long"], ranks[0]["long"]) for r in ranks)
    e_ser = float(torch.linalg.norm(serial2 - full))
    e_dist = float(torch.linalg.norm(ranks[0]["long"].to(device) - full))
    out = dict(layer=f"{cfg.arch_id} global layer: Hkv {Hkv}, G {Hq // Hkv}, "
               f"hd {hd}, softcap {softcap}, {cfg.dtype}, B 1",
               ranks=n_ranks, full_n=full_n, full_clusters=plan1.m_max,
               full_coverage_err=err_full, ranks_agree=same, long_n=long_n,
               long_clusters=plan2.m_max, plan=dict(r=plan2.r, e=plan2.e),
               e_ser=e_ser, e_dist=e_dist, build_s=build_s, ranks_s=ranks_s,
               gloo_cuda_max=ranks[0]["gloo_cuda_max"],
               per_rank=[{k: r[k] for k in ("rank_ms", "attend_ms",
                                            "reductions_ms", "total_ms",
                                            "m_loc", "r_loc", "e_loc")}
                         for r in ranks],
               store_gb=st2.k_store.numel() * st2.k_store.element_size() / 1e9,
               cache_gb=2 * cache.k.numel() * cache.k.element_size() / 1e9)
    log(f"  {out['layer']}; {n_ranks} gloo ranks on {device} ({ranks_s:.1f} s "
        f"with their start); a gloo MAX of a CUDA tensor as it is: "
        f"{out['gloo_cuda_max']}")
    log(f"  full coverage, {full_n} tokens ({plan1.m_max} clusters, r = "
        f"every local cluster, e = 0): max |dist - serial| {err_full:.3e} "
        f"(tol 1e-4); ranks agree bit for bit: {same}")
    log(f"  {long_n} tokens ({plan2.m_max} clusters, {out['store_gb']:.2f} GB "
        f"a store, dense cache {out['cache_gb']:.2f} GB, index built in "
        f"{build_s:.1f} s; plan r {plan2.r}, e {plan2.e}): e_ser "
        f"{e_ser:.4e}, e_dist {e_dist:.4e} (bound 2 e_ser + 1e-3 = "
        f"{2 * e_ser + 1e-3:.4e})")
    if not (err_full <= 1e-4 and same and e_dist <= 2 * e_ser + 1e-3):
        raise AssertionError(f"sharded retrieval: {out}")

    # the fused baseline at these shapes (r ~600 clusters, e ~7600): the
    # paged kernel against its plain twin on the same path (the kernel
    # row's tolerance), and against the "jnp" baseline within the bf16
    # bound that "jnp" vs the kernels is held to (it rounds q and p to the
    # stores' bf16; tests/test_kernels.py:40)
    fused_step = mode_step("baseline", cfg2, plan2, impl="fused")
    fused2 = fused_step(q2, st2)
    with mock.patch.object(ops, "paged_wave_attention",
                           ops.paged_wave_attention_plain):
        twin2 = fused_step(q2, st2)
    torch.cuda.synchronize()
    check = dict(case=f"perfcmp_baseline_fused_{long_n}",
                 max_abs_err=float((fused2 - twin2).abs().max()),
                 tol=2e-5 * (1.0 + float(twin2.abs().max())),
                 jnp_diff=float((fused2 - serial2).abs().max()),
                 jnp_excess=float(((fused2 - serial2).abs()
                                   - 3e-2 * (1 + fused2.abs())).max()))
    out["fused_check"] = check
    log(f"  fused baseline at {long_n} tokens: max |kernel - twin| "
        f"{check['max_abs_err']:.3e} (tol {check['tol']:.3e}); max |fused - "
        f"jnp| {check['jnp_diff']:.3e} (tol 3e-2 (1 + |fused|), worst "
        f"excess {check['jnp_excess']:.3e})")
    if not (bool(torch.isfinite(fused2).all())
            and check["max_abs_err"] <= check["tol"]
            and check["jnp_excess"] <= 0):
        raise AssertionError(f"fused baseline: {check}")

    reset_launches()
    times = dict(
        full_ms=time_ms(lambda: mode_step("full", cfg2, plan2)(q2, cache)),
        baseline_jnp_ms=time_ms(
            lambda: mode_step("baseline", cfg2, plan2)(q2, st2)),
        baseline_fused_ms=time_ms(lambda: fused_step(q2, st2)))
    out["fused_launches"] = ops.paged_wave_attention.launches
    out.update(times)
    log(f"  perfcmp modes on the card, {long_n} tokens (CUDA events, L2 "
        f"cold): full {times['full_ms']:.3f} ms; baseline jnp "
        f"{times['baseline_jnp_ms']:.3f} ms, fused "
        f"{times['baseline_fused_ms']:.3f} ms ({out['fused_launches']} "
        f"paged launches; max |kernel - twin| {check['max_abs_err']:.3e})")
    for i, r in enumerate(out["per_rank"]):
        log(f"  dist rank {i} of {n_ranks} ({r['m_loc']} clusters, r "
            f"{r['r_loc']}, e {r['e_loc']}): rank {r['rank_ms']:.3f} ms, "
            f"attend {r['attend_ms']:.3f} ms, both reductions "
            f"{r['reductions_ms']:.3f} ms, whole {r['total_ms']:.3f} ms "
            f"(both ranks share the card)")
    del st1, st2, cache
    torch.cuda.empty_cache()
    return out


# phase 21: the port's retrolint on the card
LINT_PROMPTS, LINT_NEW = (4096, 3000), 8


def run_lint(cfg, card):
    """Phase 21: the port's retrolint gate on the card. The static passes
    over the shipped tree (AST, CUDA kernels; the empty port baseline), the
    stage contract over two serves of full-width gemma2-2b through the paged
    kernel (chunked + offload, blocking + direct; B 2, prompts of
    ``LINT_PROMPTS`` tokens, ``LINT_NEW`` new tokens each: the captures are
    real, so RL103 counts one ``OffloadStage`` and one ``DecodeGraph``
    capture), and the numerics pass on real CUDA tensors with the kernels
    launched. The flush stages, which a few decode steps never reach, are
    left to the CPU pass (its tiny serves cross flushes). Any finding that
    is an error fails the phase."""
    import torch
    from repro_torch.analysis import ast_rules, kernel_check, stage_check
    from repro_torch.analysis.findings import (BASELINE_NAME, apply_baseline,
                                               load_baseline)
    from repro_torch.analysis.numerics_check import run_numerics_checks
    from repro_torch.kernels.wave_attention import ops
    from repro_torch.models import model as M

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    static = ast_rules.lint_tree(str(ROOT)) + kernel_check.check_tree(
        str(ROOT))
    static_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    reports = []
    ops.paged_wave_attention.launches = 0
    contract = stage_check.run_contract_checks(
        cfg=cfg, params=params, device="cuda", lengths=LINT_PROMPTS,
        max_new=LINT_NEW, attn_impl="fused",
        unplanned=("flush", "offload_flush"), reports=reports)
    torch.cuda.synchronize()
    contract_s = time.perf_counter() - t0
    launches = ops.paged_wave_attention.launches
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numerics = run_numerics_checks(device="cuda", fake=False)
    torch.cuda.synchronize()
    numerics_s = time.perf_counter() - t0
    findings = apply_baseline(static + contract + numerics,
                              load_baseline(str(ROOT / BASELINE_NAME)))
    errors = [f for f in findings if f.severity == "error"]
    advice = [f for f in findings if f.severity != "error"]
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        log("  " + f.render())
    captures = stage_check.captures_per_stage(reports)
    calls = {r.label: {n: rec.calls for n, rec in
                       sorted(r.recorder.records.items())} for r in reports}
    res = dict(errors=len(errors), advice=len(advice),
               inventory=sum(f.rule == "RL406" for f in advice),
               captures=captures, stage_calls=calls,
               paged_launches=launches,
               serve_s={r.label: r.seconds for r in reports},
               static_s=static_s, contract_s=contract_s,
               numerics_s=numerics_s,
               seconds=time.perf_counter() - t_all, card=card)
    log(json.dumps({"lint": res}))
    if errors:
        raise RuntimeError(f"phase 21: {len(errors)} lint error(s), first: "
                           f"{errors[0].render()}")
    want = {s: 1 for s in ("decode", "embed_tokens", "rank_fn", "attend_fn",
                           "unembed_logits", "cache_upd", "cache_stage")}
    if captures != want:
        raise RuntimeError(f"phase 21: captures per stage {captures}, "
                           f"expected {want}")
    if launches == 0:
        raise RuntimeError("phase 21: the stage pass never launched the "
                           "paged kernel")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every result (cases, serve runs, decode "
                         "breakdown) to this file")
    opts = ap.parse_args(argv)
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gemma2_2b import CONFIG
    from repro_torch.kernels import build
    from repro_torch.kernels.wave_attention.ref import (random_decode_inputs,
                                                       random_merge_inputs)

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
    recs = build.build([ROOT / src for src, _ in KERNELS.values()])
    build_s = time.perf_counter() - t0
    for rec in recs:
        log(f"  {Path(rec['source']).name}: {rec['seconds']:.1f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())
    log(f"  build total {build_s:.1f} s")

    # ---- phase 2: paged kernel vs twin on synthetic full-width cases -------
    log("phase 2: paged kernel vs plain twin (full-width decode shapes)")
    results = {k: [] for k in KERNELS}
    for name, kw, softcap in edge_cases():
        args = random_decode_inputs(device="cuda", **kw)
        results["paged_wave_attention"].append(compare(
            name, args, softcap, time_it=name == "full_width_global_bf16"))
        del args
    torch.cuda.empty_cache()

    # ---- phase 2b: the other kernels vs their twins --------------------------
    log("phase 2b: gathered-buffer merge, block gather, k-means step vs twins")
    for name, kw, softcap in merge_cases():
        args = random_merge_inputs(device="cuda", **kw)
        results["wave_attention_merge"].append(compare(
            name, args, softcap, op="wave_attention_merge",
            time_it=name == "merge_full_width_bf16"))
        del args
    log("phase 2c: both attention kernels vs twins at the decode shapes of "
        "minitron-8b and gemma3-1b (G 4), mixtral-8x22b (G 6), "
        "llava-next-34b (G 7) and kimi-k2 (G 8) (8192-token context; the "
        "last three timed)")
    group_cases = {}
    for name, paged_kw, merge_kw, softcap in config_decode_cases():
        timed = name.removesuffix("_decode") in TIMED_CASES
        args = random_decode_inputs(device="cuda", **paged_kw)
        res = config_case(name, args, softcap, "paged_wave_attention", timed)
        results["paged_wave_attention"].append(res)
        args = random_merge_inputs(device="cuda", **merge_kw)
        mres = config_case("merge_" + name, args, softcap,
                           "wave_attention_merge", timed)
        results["wave_attention_merge"].append(mres)
        if timed:
            group_cases[name] = dict(G=paged_kw["G"], hd=paged_kw["hd"],
                                     paged=res, merge=mres)
        del args
    results["block_gather"].append(gather_case())
    log("phase 2d: prefill attention vs twin at the admission shapes of "
        "mistral-7b (T 16384, G 4), mixtral-8x22b (T 4096, G 6) and "
        "k-exaone's sliding (W 128) and global layers (T 16384, G 8), timed")
    prefill_attn = [
        prefill_attention_case("mistral_16384", 16384, 32, 8),
        prefill_attention_case("mixtral_4096", 4096, 48, 8),
        prefill_attention_case("kexaone_w128", 16384, 64, 8, window=128,
                               rows=2048),
        prefill_attention_case("kexaone_global", 16384, 64, 8, rows=2048)]
    torch.cuda.empty_cache()
    kmeans = kmeans_case()
    results["kmeans_step"].append(kmeans)
    torch.cuda.empty_cache()

    # ---- phase 3: serve full-width gemma2-2b through "fused" ---------------
    log("phase 3: serve gemma2-2b at full width through attn_impl='fused' "
        "(bf16, random weights)")
    prompt_lens = (16384, 12288, 9000, 16384)
    serve, taken, engine = serve_main_path(
        CONFIG, prompt_lens, (1100, 48, 32, 64), attn_impl="fused")
    main_path = {}
    for kind, label in (("l", "captured_local_layer"),
                        ("g", "captured_global_layer")):
        layer, args, softcap = taken[kind]
        res = compare(f"{label}_{layer}", args, softcap, time_it=True)
        res["bound_ms"], res["bound_by"] = kernel_bound(args)
        log(f"    bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        main_path[kind] = res
        results["paged_wave_attention"].append(res)
    del taken
    log("  decode-step breakdown (after the run, both slots decoding): the "
        "captured step eagerly, then replayed")
    breakdown = decode_breakdown(engine)
    layout3 = state_layout(engine.last_state)
    del engine
    torch.cuda.empty_cache()

    # ---- phase 4: reduced model, card vs cpu --------------------------------
    log("phase 4: reduced model on the card vs the CPU")
    red_err = {impl: reduced_across_devices(impl)
               for impl in ("fused", "pallas")}
    for runtime, admission in (("retro", "blocking"), ("full", "chunked"),
                               ("full", "blocking")):
        red_err[f"{runtime}_{admission}"] = reduced_across_devices(
            "fused", runtime=runtime, admission=admission)

    # ---- phase 5: serve full-width gemma2-2b through "pallas" --------------
    log("phase 5: serve gemma2-2b at full width through attn_impl='pallas'")
    prompt_lens5 = (16384, 9000)
    serve5, taken5, engine5 = serve_main_path(
        CONFIG, prompt_lens5, (64, 32), attn_impl="pallas", want_flush=False)
    merge_path = {}
    for kind, label in (("l", "merge_captured_local_layer"),
                        ("g", "merge_captured_global_layer")):
        layer, args, softcap, _ = taken5[kind]
        res = compare(f"{label}_{layer}", args, softcap,
                      op="wave_attention_merge", time_it=True)
        res["bound_ms"], res["bound_by"] = merge_bound(args)
        log(f"    bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        merge_path[kind] = res
        results["wave_attention_merge"].append(res)
    g_layer, _, _, (idx, ks, vs) = taken5["g"]
    gather = check_gather(f"gather_captured_global_layer_{g_layer}",
                          idx.to(torch.int32), ks, vs, time_it=True)
    results["block_gather"].append(gather)
    del taken5, idx, ks, vs
    impls = compare_impls(engine5, g_layer, max(prompt_lens5))
    log("  decode-step breakdown (after the run, both slots decoding)")
    breakdown5 = decode_breakdown(engine5)
    del engine5
    torch.cuda.empty_cache()

    # ---- phase 6: host offload ---------------------------------------------
    log("phase 6: serve gemma2-2b at full width with the cluster stores in "
        "host memory (offload, attn_impl='fused')")
    prompt_lens6 = (8192, 6000, 8192)
    serve6, taken6, engine6 = serve_offload(CONFIG, prompt_lens6,
                                            (48, 32, 40))
    layer, args, softcap = taken6["g"]
    offload_launch = compare(f"offload_captured_global_layer_{layer}", args,
                             softcap, time_it=True)
    offload_launch["bound_ms"], offload_launch["bound_by"] = \
        kernel_bound(args)
    offload_launch["block_store"] = list(args[6].shape)
    log(f"    block store {tuple(args[6].shape)} (C + r + 1 slots), bound "
        f"{offload_launch['bound_ms']:.4f} ms ({offload_launch['bound_by']})")
    results["paged_wave_attention"].append(offload_launch)
    del taken6, args
    vs_direct, off_state = offload_vs_direct(engine6, max(prompt_lens6))
    log("  offload decode-step breakdown (after the run, both slots "
        "decoding): a copy of the plane stepping eagerly, then the served "
        "plane replaying")
    breakdown6 = offload_breakdown(engine6, off_state, max(prompt_lens6))
    log("phase 10 (offload part, on phase 6's state): the captured offload "
        "stage against the eager one (fused, pallas, jnp)")
    compiled_offload = compiled_offload_check(engine6, off_state,
                                              max(prompt_lens6))
    del engine6, off_state
    torch.cuda.empty_cache()
    red_offload = {impl: reduced_offload_across_devices(impl)
                   for impl in ("fused", "pallas")}

    # ---- phase 7: blocking admission, retro, fused --------------------------
    log("phase 7: serve gemma2-2b at full width with blocking admission "
        "(prefill_build), attn_impl='fused'")
    serve7, taken7, engine7 = serve_main_path(
        CONFIG, prompt_lens5, (64, 32), attn_impl="fused",
        admission="blocking", want_flush=False)
    del taken7
    log("  decode-step breakdown (after the run, both slots decoding)")
    breakdown7 = decode_breakdown(engine7)
    # the state after blocking admission against phase 3's after chunked
    # admission, tensor by tensor (an eager step's host time differs
    # between the phases: the layout is not why)
    layout7 = state_layout(engine7.last_state)
    layout_diff = [(a, b) for a, b in zip(layout3, layout7) if a != b]
    log(f"  host time: state layout after blocking vs chunked admission: "
        f"{len(layout7)} tensors, {len(layout_diff)} differ "
        f"{layout_diff[:4] or ''}")
    eager_ms = {name: b["eager"]["enqueue_ms"] for name, b in (
        ("phase3", breakdown), ("phase7", breakdown7))}
    host_check = dict(layout_tensors=len(layout7), layout_differs=layout_diff,
                      eager_host_ms=eager_ms)
    log(f"  host time: eager ms per step: phase 3 {eager_ms['phase3']:.2f}, "
        f"phase 7 {eager_ms['phase7']:.2f}")
    params7 = engine7.params
    del engine7
    torch.cuda.empty_cache()
    build_check = build_bit_check(params7, CONFIG)
    blk_vs_chk = blocking_vs_chunked_logits(params7, CONFIG)
    sparse = sparse_prefill_request(params7, CONFIG)
    del params7
    torch.cuda.empty_cache()

    # ---- phase 8: runtime="full" --------------------------------------------
    log("phase 8: serve gemma2-2b at full width through runtime='full' "
        "(dense cache, exact attention), chunked and blocking admission")
    serve8, breakdown8, full_check = {}, {}, {}
    for admission in ("chunked", "blocking"):
        serve8[admission], _, engine8 = serve_main_path(
            CONFIG, prompt_lens5, (64, 32), runtime="full",
            admission=admission, want_flush=False)
        if admission == "chunked":
            full_check = full_attention_check(engine8, max(prompt_lens5))
            log("  decode-step breakdown (after the run, both slots "
                "decoding): the old formulation (cache upcast) eagerly, "
                "the new one eagerly and replayed")
            breakdown8 = decode_breakdown(engine8, upcast_too=True)
        del engine8
        torch.cuda.empty_cache()
    for name, r in (("retro fused, phase 3", serve),
                    ("retro pallas, phase 5", serve5),
                    ("retro fused blocking, phase 7", serve7),
                    ("full chunked, phase 8", serve8["chunked"]),
                    ("full blocking, phase 8", serve8["blocking"])):
        log(f"  {name}: decode {r['decode_tps']:.2f} tok/s, ITL p50/p99 "
            f"{r['itl_p50_ms']:.2f}/{r['itl_p99_ms']:.2f} ms, TTFT s "
            f"{['%.2f' % t for t in r['ttft_s']]}, peak "
            f"{r['peak_mem_gib']:.2f} GiB")

    # ---- phase 9: minitron-8b -----------------------------------------------
    log("phase 9: serve minitron-8b at full published width through "
        "attn_impl='fused' (hd 128, G 4)")
    from repro_torch.configs.minitron_8b import CONFIG as MINITRON
    prompt_lens9 = (8192, 6000)
    serve9, taken9, engine9 = serve_main_path(
        MINITRON, prompt_lens9, (32, 24), attn_impl="fused",
        want_flush=False)
    minitron_launch = captured_launch("minitron", taken9, "g")
    results["paged_wave_attention"].append(minitron_launch)
    log("  decode-step breakdown (after the run, both slots decoding)")
    breakdown9 = decode_breakdown(engine9)
    del taken9, engine9
    torch.cuda.empty_cache()

    # ---- phase 10: the compiled decode stage, eager vs replay ---------------
    log("phase 10: gemma2-2b at full width, the captured decode step against "
        "the eager step (fused, pallas, jnp, full)")
    from repro_torch.models import model as M
    params10 = M.init_params(CONFIG, torch.Generator(device="cuda")
                             .manual_seed(10), "cuda")
    compiled = compiled_step_check(params10, CONFIG)
    compiled.update(compiled_offload)
    del params10
    torch.cuda.empty_cache()

    # ---- phase 11: mixtral-8x22b --------------------------------------------
    from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as KIMI
    from repro_torch.configs.llava_next_34b import CONFIG as LLAVA
    from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL
    mixtral = MIXTRAL.replace(n_layers=8)
    log("phase 11: serve mixtral-8x22b at full published width (d_model "
        "6144, 48/8 heads, hd 128, 8 experts top-2, d_expert 16384, window "
        "4096) through attn_impl='fused'; depth cut 56 -> 8 layers (one "
        "card), chunked then blocking admission")
    lens11, news11 = (16384, 9000), (64, 32)
    serve11, taken11, engine11 = serve_main_path(
        mixtral, lens11, news11, attn_impl="fused", want_flush=False)
    mixtral_launch = captured_launch("mixtral", taken11, "l")
    results["paged_wave_attention"].append(mixtral_launch)
    del taken11
    log("  decode-step breakdown (after the run, both slots decoding)")
    breakdown11 = decode_breakdown(engine11)
    params11 = engine11.params
    del engine11
    torch.cuda.empty_cache()
    moe11 = moe_ffn_step(params11, mixtral)
    serve11b, _, engine11 = serve_main_path(
        mixtral, lens11, news11, attn_impl="fused", admission="blocking",
        want_flush=False, params=params11)
    del engine11
    torch.cuda.empty_cache()
    log("  the compiled decode stage at mixtral's width: eager vs replayed "
        "steps (fused, pallas)")
    compiled11 = compiled_step_check(
        params11, mixtral, paths=(("retro", ("fused", "pallas")),))
    del params11
    torch.cuda.empty_cache()
    red11 = reduced_across_devices("fused", arch="mixtral_8x22b")

    # ---- phase 12: llava-next-34b -------------------------------------------
    llava = LLAVA.replace(n_layers=16)
    patches = llava.num_patch_tokens
    log(f"phase 12: serve llava-next-34b at full published width (d_model "
        f"7168, 56/8 heads, hd 128, d_ff 20480) with {patches} seeded bf16 "
        f"patch embeddings a request, through attn_impl='fused' (chunked, "
        f"blocking) and 'pallas' (one request); depth cut 60 -> 16 layers")
    lens12, news12 = (8192, 6000), (32, 24)
    serve12, taken12, engine12 = serve_main_path(
        llava, lens12, news12, attn_impl="fused", want_flush=False,
        patches=patches)
    llava_launch = captured_launch("llava", taken12, "g")
    results["paged_wave_attention"].append(llava_launch)
    del taken12
    log("  decode-step breakdown (after the run, both slots decoding)")
    breakdown12 = decode_breakdown(engine12)
    params12 = engine12.params
    del engine12
    torch.cuda.empty_cache()
    serve12b, _, engine12 = serve_main_path(
        llava, lens12, news12, attn_impl="fused", admission="blocking",
        want_flush=False, params=params12, patches=patches)
    del engine12
    torch.cuda.empty_cache()
    serve12p, taken12p, engine12 = serve_main_path(
        llava, lens12[:1], (16,), attn_impl="pallas", batch=1,
        want_flush=False, params=params12, patches=patches)
    llava_merge = captured_launch("llava_merge", taken12p, "g",
                                  op="wave_attention_merge")
    results["wave_attention_merge"].append(llava_merge)
    del taken12p, engine12
    torch.cuda.empty_cache()
    blk_vs_chk12 = blocking_vs_chunked_logits(params12, llava, n=8192,
                                              patches=patches)
    del params12
    torch.cuda.empty_cache()

    # ---- phase 13: kimi-k2 -------------------------------------------------
    kimi = KIMI.replace(n_layers=1)
    log("phase 13: serve kimi-k2 at full published width (d_model 7168, "
        "64/8 heads, hd 128, 384 experts top-8, d_expert 2048, vocab "
        "163840) through attn_impl='fused'; depth cut 61 -> 1 layer")
    serve13, taken13, engine13 = serve_main_path(
        kimi, (4096,), (16,), attn_impl="fused", batch=1, want_flush=False,
        min_capture_pos=2048)
    kimi_launch = captured_launch("kimi", taken13, "g")
    results["paged_wave_attention"].append(kimi_launch)
    del taken13
    params13 = engine13.params
    del engine13
    torch.cuda.empty_cache()
    moe13 = moe_ffn_step(params13, kimi, batch=1)
    del params13
    torch.cuda.empty_cache()
    red13 = reduced_across_devices("fused", arch="kimi_k2_1t_a32b")
    for name, r in (("mixtral chunked, phase 11", serve11),
                    ("mixtral blocking, phase 11", serve11b),
                    ("llava chunked, phase 12", serve12),
                    ("llava blocking, phase 12", serve12b),
                    ("llava pallas, phase 12", serve12p),
                    ("kimi chunked, phase 13", serve13)):
        log(f"  {name}: decode {r['decode_tps']:.2f} tok/s, ITL p50/p99 "
            f"{r['itl_p50_ms']:.2f}/{r['itl_p99_ms']:.2f} ms, TTFT s "
            f"{['%.2f' % t for t in r['ttft_s']]}, peak "
            f"{r['peak_mem_gib']:.2f} GiB")

    fam = run_families(results)
    t0 = time.perf_counter()
    train17 = run_training()
    train17["phase_s"] = time.perf_counter() - t0
    log(f"  phase 17: {train17['phase_s']:.1f} s")
    t0 = time.perf_counter()
    sample18 = run_sampling(CONFIG, "the engine as phase 3 builds it")
    sample18["phase_s"] = time.perf_counter() - t0
    log(f"  phase 18: {sample18['phase_s']:.1f} s")

    # ---- phase 19: the step functions at full width -------------------------
    log(f"phase 19: the step functions, gemma2-2b at full width through "
        f"attn_impl='fused': make_step's prefill (B 1 x T {STEP_T}), "
        f"{STEP_STEPS} decode steps monolithic and hot/cold split from one "
        f"state, one train step (B 1 x T {STEP_TRAIN_T}), the dry-run")
    t0 = time.perf_counter()
    steps19 = step_functions(CONFIG)
    steps19["phase_s"] = time.perf_counter() - t0
    log(f"  phase 19: {steps19['phase_s']:.1f} s")

    # ---- phase 20: sharded retrieval ---------------------------------------
    from repro_torch.configs.gemma2_9b import CONFIG as GEMMA9
    log(f"phase 20: sharded retrieval, one global layer of gemma2-9b over "
        f"{SHARD_RANKS} gloo ranks on cuda:0: full coverage at "
        f"{SHARD_FULL_N} tokens, the default plan at {SHARD_LONG_N}, "
        f"perfcmp's modes timed")
    t0 = time.perf_counter()
    shard20 = sharded_retrieval(GEMMA9)
    results["paged_wave_attention"].append(shard20["fused_check"])
    shard20["phase_s"] = time.perf_counter() - t0
    log(f"  phase 20: {shard20['phase_s']:.1f} s")

    # ---- phase 21: the port's retrolint on the card --------------------------
    log(f"phase 21: retrolint on the card: the static passes over the "
        f"shipped tree, the stage contract over full-width gemma2-2b served "
        f"through the paged kernel (chunked + offload, blocking + direct; "
        f"prompts {LINT_PROMPTS}, {LINT_NEW} new tokens), the numerics pass "
        f"on CUDA tensors")
    lint21 = run_lint(CONFIG, card)
    log(f"  phase 21: {lint21['seconds']:.1f} s")

    # the kernel line: launches on the path that runs the kernel (the serve
    # run of its impl; for the two kernels no serving path calls, one call
    # of their op entry point); times and bound at that path's captured
    # global-layer launch (k-means: the full-width step); the error of the
    # case nearest its tolerance, beside that tolerance
    timed = dict(paged_wave_attention=main_path["g"],
                 wave_attention_merge=merge_path["g"], block_gather=gather,
                 kmeans_step=kmeans)
    launches = dict(paged_wave_attention=serve["launches"],
                    wave_attention_merge=serve5["launches"],
                    block_gather=gather["launches"],
                    kmeans_step=kmeans["launches"])
    by_path = dict(paged_wave_attention=dict(
        fused=serve["launches"], offload_fused=serve6["launches"],
        blocking_fused=serve7["launches"],
        sparse_prefill_fused=sparse["launches"],
        minitron_fused=serve9["launches"],
        full=sum(r["launches"] for r in serve8.values()),
        mixtral_fused=serve11["launches"],
        mixtral_blocking_fused=serve11b["launches"],
        llava_fused=serve12["launches"],
        llava_blocking_fused=serve12b["launches"],
        kimi_fused=serve13["launches"],
        zamba2_fused=fam["serve_zamba2"]["launches"],
        zamba2_full=fam["serve_zamba2_full"]["launches"],
        rwkv6=fam["serve_rwkv6"]["launches"],
        whisper_fused=fam["serve_whisper"]["launches"],
        whisper_full=fam["serve_whisper_full"]["launches"],
        sampled_fused=sample18["serve"]["launches"],
        training=train17["launches"]["paged_wave_attention"],
        serve_step_fused=steps19["mono_launches"],
        serve_step_split_fused=steps19["split_launches"],
        perfcmp_baseline_fused=shard20["fused_launches"],
        lint_contract_fused=lint21["paged_launches"]),
        wave_attention_merge=dict(
            pallas=serve5["launches"], llava_pallas=serve12p["launches"],
            zamba2_pallas=fam["serve_zamba2_pallas"]["launches"]))
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = timed[name]
        worst = max(results[name],
                    key=lambda r: r["max_abs_err"] / max(r["tol"], 1e-30))
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=worst["max_abs_err"], max_err=worst["max_abs_err"],
            tol=worst["tol"], worst_case=worst["case"], ms=t["ms"],
            kernel_ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t.get("library_ms"),
            launches_by_path=by_path.get(name, {}),
            **{key: t[key] for key in ("bound_f32_ms", "device_ms",
                                       "device_ms_clean_l2") if key in t}))
    script_s = time.perf_counter() - t_script
    log(f"profiler: {PROFILER['sessions']} sessions, {PROFILER['reruns']} "
        f"run again for records the profiler lost")
    log(f"script {script_s:.1f} s")
    if opts.json is not None:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        opts.json.write_text(json.dumps(dict(
            card=card, build_s=build_s, script_s=script_s, cases=results, serve=serve,
            profiler=PROFILER,
            decode_breakdown=breakdown, reduced_card_vs_cpu_err=red_err,
            serve_pallas=serve5, decode_breakdown_pallas=breakdown5,
            impls=impls, serve_offload=serve6,
            offload_vs_direct=vs_direct, decode_breakdown_offload=breakdown6,
            reduced_offload_card_vs_cpu=red_offload, serve_blocking=serve7,
            decode_breakdown_blocking=breakdown7,
            decode_breakdown_minitron=breakdown9, host_time_check=host_check,
            compiled_step=compiled,
            build_bit_check=build_check, blocking_vs_chunked=blk_vs_chk,
            sparse_prefill=sparse, serve_full=serve8,
            decode_breakdown_full=breakdown8, full_attention_check=full_check,
            serve_minitron=serve9, minitron_launch=minitron_launch,
            group_size_cases=group_cases, serve_mixtral=serve11,
            serve_mixtral_blocking=serve11b, mixtral_launch=mixtral_launch,
            decode_breakdown_mixtral=breakdown11, moe_ffn_mixtral=moe11,
            compiled_step_mixtral=compiled11,
            reduced_mixtral_card_vs_cpu=red11, serve_llava=serve12,
            serve_llava_blocking=serve12b, serve_llava_pallas=serve12p,
            llava_launch=llava_launch, llava_merge_launch=llava_merge,
            decode_breakdown_llava=breakdown12,
            llava_blocking_vs_chunked=blk_vs_chk12, serve_kimi=serve13,
            kimi_launch=kimi_launch, moe_ffn_kimi=moe13,
            reduced_kimi_card_vs_cpu=red13, kernels=kernels,
            training=train17, sampling=sample18, step_functions=steps19,
            sharded_retrieval=shard20, lint=lint21,
            prefill_attention=prefill_attn, **fam),
            indent=1))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
