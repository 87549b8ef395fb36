"""The control of a cell's check, read on the chip beside the program's own
readings:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--out F]

For each seed, in one process: the cell's weights from the seed, one
``serve`` call of the mix's first batch at the cell's own load (the
shortest window that finishes the mix's longest requests), then the run's
own check (``bench.judge``: the cell's sample, number, router margin and
limit) twice: on the program's served tokens, and on the control's, the
tokens that the fp8 reference (``precision="fp8"``) puts first at each
position of the same sequences, read by the float32 reference. The
program has to come out correct and the control not. One JSON line per
seed on standard output, also appended to ``--out``. The benchmark's runs
never run this."""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def read_seed(name, seed, device, warm, conf=None, cell=None, mix=None):
    """One seed's checks, the program's and the control's, each with its
    verdict. ``conf``, ``cell`` and ``mix`` replace the cell's files (the
    test at a small size on the CPU)."""
    import torch
    from perfbench.lib import bench, check, spec, traffic
    run = bench.build(name, seed, device, conf=conf, cell=cell)
    if warm:
        bench.warm_up(run)
    wl = spec.workload(spec.benchmark(), name)
    mix = mix or spec.traffic(wl["traffic"])
    reqs = bench.make_requests(traffic.call_requests(mix, run.cfg.vocab,
                                                     seed, 0))
    t0 = time.perf_counter()
    run.calls.append(run.engine.serve(reqs, run.cell["batch"]))
    run.requests = reqs
    out = {"seed": seed, "workload": name,
           "serve_s": time.perf_counter() - t0,
           "tokens_out": run.calls[0].tokens_out}
    bench.free(run.engine)
    run.engine = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    for side, precision in (("program", "f32"), ("control", "fp8")):
        t0 = time.perf_counter()
        numbers = bench.judge(run, precision)
        out[side] = {"correct": check.passed(numbers), "checks": numbers,
                     "check_s": time.perf_counter() - t0}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = read_seed(args.workload, seed, torch.device("cuda"),
                         warm=n == 0)
        line["card"] = card
        for side in ("program", "control"):
            for k, v in line[side]["checks"].items():
                print(f"control: seed {seed} {side} {k}: {v['value']!r} "
                      f"(limit {v['limit']!r})", file=sys.stderr)
            print(f"control: seed {seed} {side} correct: "
                  f"{line[side]['correct']}", file=sys.stderr)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
