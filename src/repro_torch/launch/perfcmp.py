"""One decode-attention layer at full geometry under three runtimes, traced
on the CPU like the dry-run, with its roofline terms on the H100. Port of
``repro/launch/perfcmp.py``:

  full      dense-KV full attention (the paper's baseline comparator);
  baseline  serial wave attention on one device (global top r);
  dist      sharded retrieval (``core/distributed.py``): rank 0 of the
            'model' axis ranks its own M / n clusters, retrieves its local
            top r / n, and the ranks combine with one MAX and one SUM
            reduction of B * Hq * (hd + 2) floats.

    PYTHONPATH=src python -m repro_torch.launch.perfcmp --arch gemma2_9b \\
        --shape long_500k --mode all --out perf.jsonl

FLOPs, unfused bytes and the tallied collective bytes are one device's
program: full and baseline hold the whole layer on one device, dist is
rank 0 of ``--mesh``'s 'model' axis. ``mode_step`` is shared with
``chip_smoke.py``, which times the three modes on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Callable, Dict

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core import attention as wa
from repro_torch.core.distributed import (distributed_wave_attention,
                                          shard_state)
from repro_torch.core.wave_index import init_wave_state
from repro_torch.core.zones import plan_zones
from repro_torch.launch import roofline as R
from repro_torch.launch.dryrun import (MESHES, fake_group, fake_mode,
                                       trace_cost)

MODES = ("full", "baseline", "dist")


def mode_step(mode: str, cfg, plan, *, impl: str = "jnp") -> Callable:
    """The layer's attention under ``mode``: ``fn(q, kv)`` with ``kv`` a
    DenseCache (full) or a WaveState (baseline: the whole state; dist:
    this rank's block). Global layer: no window."""
    softcap = cfg.attn.softcap
    if mode == "full":
        return lambda q, cache: wa.full_attention_decode(q, cache,
                                                         softcap=softcap)
    if mode == "baseline":
        return lambda q, st: wa.wave_attention_decode(
            q, st, cfg.retro, plan, softcap=softcap, impl=impl).out
    return lambda q, st: distributed_wave_attention(
        q, st, cfg.retro, plan, softcap=softcap)


def layer_inputs(mode: str, cfg, B: int, seq_len: int, plan, *,
                 n_ranks: int = 1, gen_headroom: int = 1024):
    """Empty (q, kv) of one layer on the CPU (fake inside ``fake_mode``):
    q (B, Hq, hd) in the config's dtype; a dense cache of seq_len +
    gen_headroom slots, or a wave state of ``plan.m_max`` clusters (dist:
    rank 0's block of ``n_ranks``)."""
    a = cfg.attn
    dt = getattr(torch, cfg.dtype)
    q = torch.empty((B, a.n_heads, a.head_dim), dtype=dt)
    if mode == "full":
        return q, wa.init_dense_cache(B, a.n_kv_heads, seq_len + gen_headroom,
                                      a.head_dim, dt, "cpu")
    st = init_wave_state(B, a.n_kv_heads, a.head_dim, plan.m_max, cfg.retro,
                         dt, "cpu")
    if mode == "dist":
        st = shard_state(st, 0, n_ranks)
    return q, st


def lower_mode(arch: str, shape_name: str, mode: str, *, mesh: str = "node",
               gen_headroom: int = 1024, verbose: bool = True) -> Dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind != "decode":
        raise ValueError(f"{shape_name} is not a decode shape")
    B, seq = shape.global_batch, shape.seq_len
    plan = plan_zones(seq, cfg.retro, gen_headroom)
    n = MESHES[mesh]().shape["model"] if mode == "dist" else 1
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if mode == "dist":
            stack.enter_context(fake_group(n))
        stack.enter_context(fake_mode())
        q, kv = layer_inputs(mode, cfg, B, seq, plan, n_ranks=n,
                             gen_headroom=gen_headroom)
        cost = trace_cost(mode_step(mode, cfg, plan), q, kv)
    trace_s = time.perf_counter() - t0
    coll = cost["coll"]
    rec = R.derive(cfg, shape, f"{mode}:{n}", n, cost, coll,
                   note=f"attnlayer-{mode}").as_dict()
    rec.update({"mode": mode, "trace_s": round(trace_s, 2),
                "per_device": f"rank 0 of {n} (exact)" if mode == "dist"
                else "one device (exact)",
                "bytes_kind": "unfused: every op's operands and results",
                "coll_breakdown": {k: v for k, v in coll.items() if v}})
    if verbose:
        print(f"[perfcmp] {arch} x {shape_name} [{mode}]: "
              f"flops={rec['flops_per_chip']:.3e} "
              f"bytes={rec['bytes_per_chip']:.3e} "
              f"coll={rec['coll_bytes_per_chip']:.3e} "
              f"terms(s)=({rec['compute_s']:.2e},{rec['memory_s']:.2e},"
              f"{rec['collective_s']:.2e}) dom={rec['dominant']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2_9b")
    ap.add_argument("--shape", default="long_500k",
                    choices=["decode_32k", "long_500k"])
    ap.add_argument("--mode", default="all", choices=list(MODES) + ["all"])
    ap.add_argument("--mesh", default="node", choices=list(MESHES),
                    help="dist: rank 0 of this mesh's 'model' axis")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    modes = MODES if args.mode == "all" else (args.mode,)
    for mode in modes:
        rec = lower_mode(args.arch, args.shape, mode, mesh=args.mesh)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
