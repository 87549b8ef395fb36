"""Serving launcher: continuous-batching demo on the port, with the
wave-index runtime or the full-attention (dense cache) comparator, under
chunked or blocking admission. Port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b \
        --device cuda --requests 4 --batch 2 --prompt-lens 8192,6000 \
        --new-tokens 32 --stagger 8 [--runtime full] \
        [--admission blocking --prefill-bucket 64] [--offload --cache-frac 0.2] \
        [--temperature 0.7 --seed 3] [--trace]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_tiny \
        --device cpu --reduced --prompt-lens 60,40 --new-tokens 4

``--trace`` serves with the engine's spans on (``repro_torch.spans``) and
prints, for each span name, its count, seconds and self seconds, and with
``--offload`` the plane's per-layer seconds.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServeEngine

# the offload plane's per-layer spans, in the order a layer runs them
PLANE_SPANS = ("readback_ids", "translate", "stage", "launch",
               "drain_admissions")


def print_spans(rec) -> None:
    """A call's spans by name (count, seconds, self seconds), longest
    first; then the offload plane's spans by layer (seconds)."""
    print(f"spans: {'name':18s} {'count':>7s} {'s':>10s} {'self s':>10s}")
    for name, (n, sec, own) in sorted(rec.totals().items(),
                                      key=lambda kv: -kv[1][1]):
        print(f"       {name:18s} {n:7d} {sec:10.4f} {own:10.4f}")
    by_layer = rec.totals(by="layer")
    layers = sorted({lyr for name, lyr in by_layer if name in PLANE_SPANS})
    if layers:
        print("offload plane by layer, s: layer "
              + " ".join(f"{n:>16s}" for n in PLANE_SPANS))
        for lyr in layers:
            print(f"{lyr:32d} " + " ".join(
                f"{by_layer.get((n, lyr), (0, 0.0))[1]:16.4f}"
                for n in PLANE_SPANS))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b",
                    help="gemma2_2b, gemma2_9b, gemma3_1b, minitron_8b, "
                         "mixtral_8x22b, kimi_k2_1t_a32b, llava_next_34b, "
                         "zamba2_1p2b, rwkv6_3b or whisper_tiny (or their "
                         "dashed names); llava is served without patch "
                         "embeddings, as by the reference's launcher; "
                         "whisper's requests get seeded normal frame "
                         "embeddings (the stubbed audio frontend). ssm, "
                         "hybrid and audio admit blocking only, and refuse "
                         "--offload")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runtime", default="retro", choices=["retro", "full"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-lens", default="640",
                    help="comma-separated lengths, cycled over the queue")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--stagger", type=int, default=0,
                    help="request i generates new-tokens + i*stagger tokens")
    ap.add_argument("--admission", default="chunked",
                    choices=["chunked", "blocking"])
    ap.add_argument("--attn-impl", default=None, choices=["jnp", "fused"],
                    help="retro decode-attention implementation: 'jnp' "
                         "(reference execution-buffer path) or 'fused' "
                         "(gather-free paged CUDA wave-attention kernel — "
                         "retrieved clusters read from the stores in place, "
                         "no gather temp; its plain twin on the CPU). "
                         "Default: the config's retro.attn_impl")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="chunked-admission tokens per scheduler iteration")
    ap.add_argument("--prefill-bucket", type=int, default=1,
                    help="blocking-mode prompt-length bucket")
    ap.add_argument("--offload", action="store_true",
                    help="host-offload wave buffer (paper Sec. 4.3): the "
                         "cluster payload stores live in host memory; decode "
                         "retrieval reads a device block cache through "
                         "cache-slot ids, misses fetched from the host")
    ap.add_argument("--cache-frac", type=float, default=None,
                    help="device block-cache size as a fraction of the "
                         "cluster store (offload; at least one slot). "
                         "Default: the config's retro.cache_frac")
    ap.add_argument("--cache-policy", default=None,
                    choices=["lru", "fifo", "clock"],
                    help="block-cache replacement policy (offload)")
    ap.add_argument("--fault-profile", default=None,
                    help="inject link faults into the offload miss fetches, "
                         "e.g. 'transient=0.2,corrupt=0.01,spike=0.1,seed=3' "
                         "(seeded; per-attempt probabilities). A failed "
                         "fetch is masked out of the retrieval zone and "
                         "covered by the estimation zone")
    ap.add_argument("--fetch-deadline", type=float, default=None,
                    help="per-translate virtual fetch budget in seconds; "
                         "overdue misses degrade instead of stalling")
    ap.add_argument("--fetch-retries", type=int, default=2,
                    help="bounded retries per miss fetch (exponential "
                         "virtual backoff)")
    ap.add_argument("--max-decode-steps", type=int, default=None,
                    help="per-request watchdog: finish a request with "
                         "status='timeout' after this many decode steps")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample at this temperature (Gumbel-max from a "
                         "generator seeded by --seed); 0: greedy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="record the call's spans and print them by name "
                         "(and the offload plane's by layer)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, dev)
    lens = [int(x) for x in args.prompt_lens.split(",")]
    engine = ServeEngine(cfg, params, runtime=args.runtime, gen_headroom=512,
                         admission=args.admission,
                         prefill_chunk=args.prefill_chunk,
                         prefill_bucket=args.prefill_bucket,
                         attn_impl=args.attn_impl, offload=args.offload,
                         cache_frac=args.cache_frac,
                         cache_policy=args.cache_policy,
                         fault_profile=args.fault_profile,
                         fetch_deadline_s=args.fetch_deadline,
                         fetch_retries=args.fetch_retries,
                         max_decode_steps=args.max_decode_steps,
                         temperature=args.temperature, spans=args.trace,
                         device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, lens[i % len(lens)])
                    .astype(np.int32),
                    max_new_tokens=args.new_tokens + i * args.stagger)
            for i in range(args.requests)]
    if cfg.family == "audio":
        for r in reqs:
            r.extra = {"frames": rng.standard_normal(
                (1, cfg.encoder_frames, cfg.d_model)).astype(np.float32)}
    m = engine.serve(reqs, batch_size=args.batch, seed=args.seed)
    offload = engine.placement.offload
    print(f"served {len(reqs)} requests on {args.batch} slots "
          f"({engine.runtime}{'+offload' if offload else ''}, "
          f"{engine.admission} admission, {engine.attn_impl} attention, "
          f"{dev}): "
          f"prefill {m.prefill_s:.2f}s, "
          f"decode {m.tokens_out} tokens @ {m.decode_tps:.1f} tok/s, "
          f"slot occupancy {m.slot_occupancy:.2f}, "
          f"itl p50/p99 {m.itl_p50_s * 1e3:.1f}/{m.itl_p99_s * 1e3:.1f} ms")
    if offload:
        c = m.cache
        print(f"  wave buffer: hit {c.hit_ratio:.3f} "
              f"(effective {c.effective_hit_ratio:.3f}, "
              f"{c.pending_hits} pending hits), "
              f"link {c.bytes_over_link / 2**20:.1f} MiB, "
              f"cache {c.bytes_from_cache / 2**20:.1f} MiB")
        if args.fault_profile or c.faults or m.degraded_steps:
            print(f"  link faults: {c.faults} faults, {c.retries} retries, "
                  f"{c.corrupt_fetches} corrupt, "
                  f"{c.failed_fetches} failed fetches; "
                  f"{m.degraded_steps}/{m.steps} degraded steps "
                  f"({m.dropped_cluster_steps} cluster-steps dropped)")
    for i, r in enumerate(reqs):
        status = "" if r.status == "ok" else f" [{r.status}]"
        print(f"  req {i}: prompt {len(r.prompt)}, out {len(r.out_tokens)}, "
              f"ttft {r.ttft_s:.2f}s, decode {r.decode_tps:.1f} tok/s"
              f"{status}")
    print("sample output tokens:", reqs[0].out_tokens[:10])
    if args.trace:
        print_spans(m.spans)


if __name__ == "__main__":
    main()
