"""retrolint self-tests of the port: every rule against a known-good and a
known-bad fixture, in PyTorch and CUDA idiom.

Counterpart of ``repro/analysis/selftest.py``. The bad fixtures double as
the CI tripwire: each is a complete source snippet that, seeded into the
port's tree at its path, MUST make ``repro_torch.launch.lint`` exit non-zero
(the good twin must stay silent). ``run_selftests()`` executes the table and
returns the failures; the CLI (``--selftest``) and the tests consume it.

The fixtures are string literals on purpose: the reference's lint walks
every ``.py`` under ``src/``, so a bad fixture saved as a file would trip it.
AST and kernel fixtures run through the real source-level checkers; the trace
rules (RL101-RL104, RL401-RL405) run on tiny stages and functions, the
schedule rules (RL301-RL305) on op-sequence schedules.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Dict, List

from repro_torch.analysis.ast_rules import GRAPHS_PATH, lint_source
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.kernel_check import (check_cuda_source,
                                               check_python_source)

WAVE_OPS_PATH = "src/repro_torch/kernels/wave_attention/ops.py"

# --------------------------------------------------------------- AST fixtures
_RL001_BAD = '''
import torch

def decode_step(state):  # retrolint: hot
    n = state.n_clusters.cpu()            # unsanctioned host sync
    return n
'''

_RL001_GOOD = '''
import torch

def decode_step(state):  # retrolint: hot
    n = state.n_clusters.cpu()  # retrolint: sync(control-plane readback)
    return n

def cold_path(state):
    return state.n_clusters.tolist()      # not a hot function: fine
'''

# seeded at graphs.py, where DecodeGraph._run is a captured body
_RL002_BAD = '''
import torch

class DecodeGraph:
    def _run(self):
        logits, state = self.fn(self.state, self.tokens, self.active)
        if (logits > 0).any():                # tensor-valued branch
            logits = -logits
        return logits
'''

_RL002_GOOD = '''
import torch

class DecodeGraph:
    def _run(self):
        logits, state = self.fn(self.state, self.tokens, self.active)
        if self.graph is None:                # static identity check: fine
            logits = logits + 0
        for i in range(logits.shape[0]):      # shape is static: fine
            logits = logits + i
        return torch.where(logits > 0, logits, -logits)   # on the card
'''

_RL003_BAD = '''
import torch

def capture_all(steps):
    graphs = []
    for step in steps:
        g = torch.cuda.CUDAGraph()            # a fresh capture per iteration
        graphs.append(g)
    return graphs
'''

_RL003_GOOD = '''
import torch

def capture_all(steps):
    graph = torch.cuda.CUDAGraph()            # built once

    def replay_all():
        for _ in steps:                       # replaying in a loop is fine
            graph.replay()
    return replay_all
'''

_RL004_BAD = '''
import torch

SERVE_STAGES = {"step": dict(donate=(0,), fn="fixture:step")}

def step(state, x):
    state.add_(x)
    return state

def loop(state, x):
    before = state                            # an alias, not a copy
    state = step(state, x)
    return (state - before).abs().max()       # always 0: before moved too
'''

_RL004_GOOD = _RL004_BAD.replace(
    "before = state                            # an alias, not a copy",
    "before = state.clone()                    # a copy of the old values")

# ----------------------------------------------------------- kernel fixtures
_CUDA_HELPERS = r'''
#include <stdint.h>
namespace {
constexpr int STAGES = 2;
constexpr int TILE_BYTES = 4096;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
'''

# a producer warp fills a two-slot ring with bulk copies; the consumers wait
# on full[slot] at the use's parity, read, and release the slot
_RL201_GOOD = _CUDA_HELPERS + r'''
__global__ void ring_kernel(const float* src, float* out, int T) {
  extern __shared__ uint8_t ring[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
  }
  __syncthreads();
  if (tid < 32) {
    for (int step = 0; step < T; ++step) {
      const int slot = step % STAGES;
      mbar_wait(&empty[slot], ((step / STAGES) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(&full[slot], TILE_BYTES);
        bulk_g2s(smem_u32(ring + slot * TILE_BYTES), src + step * 1024,
                 TILE_BYTES, &full[slot]);
      }
    }
    return;
  }
  float acc = 0.f;
  for (int step = 0; step < T; ++step) {
    const int slot = step % STAGES;
    mbar_wait(&full[slot], (step / STAGES) & 1);
    const float* tile = reinterpret_cast<const float*>(ring + slot * TILE_BYTES);
    acc += tile[tid];
    if (tid == 32) mbar_arrive(&empty[slot]);
  }
  out[tid] = acc;
}
}  // namespace
'''

# read without waiting for the fill: the headline silent data race
_RL201_BAD_NOWAIT = _RL201_GOOD.replace(
    "    mbar_wait(&full[slot], (step / STAGES) & 1);\n", "")
# the consumer waits on the previous phase's parity (passes on stale data)
_RL201_BAD_PARITY = _RL201_GOOD.replace(
    "mbar_wait(&full[slot], (step / STAGES) & 1);",
    "mbar_wait(&full[slot], ((step / STAGES) & 1) ^ 1);")
# the producer refills a slot without waiting for its release
_RL201_BAD_REFILL = _RL201_GOOD.replace(
    "      mbar_wait(&empty[slot], ((step / STAGES) & 1) ^ 1);\n", "")
# the slot is released before it is read
_RL201_BAD_RELEASE = _RL201_GOOD.replace(
    "    acc += tile[tid];\n    if (tid == 32) mbar_arrive(&empty[slot]);",
    "    if (tid == 32) mbar_arrive(&empty[slot]);\n    acc += tile[tid];")

# one buffer in, one bulk store out: the store must have read shared memory
# before the block exits
_RL201_STORE_GOOD = r'''
#include <stdint.h>
__global__ void copy_kernel(const uint8_t* src, uint8_t* dst, int bytes) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const uint32_t sb = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  const uint32_t mb = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mb)
               : "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
      "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sb), "l"(src), "r"(bytes), "r"(mb)
      : "memory");
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mb) : "memory");
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(sb), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
'''

_RL201_STORE_BAD = _RL201_STORE_GOOD.replace(
    '  asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");\n',
    "")

# seeded at wave_attention/ops.py: a planner reading a tensor value
_RL202_BAD = '''
def _grid(rows, n_tiles, e_tiles):
    return dict(rows=rows, splits=n_tiles + e_tiles, tiles_per_split=1)


def paged_grid(*args):
    n_live = int(args[10].sum())          # live clusters: a tensor value
    return _grid(args[0].shape[0] * args[0].shape[1], n_live, 1)
'''

_RL202_GOOD = '''
def _grid(rows, n_tiles, e_tiles):
    return dict(rows=rows, splits=n_tiles + e_tiles, tiles_per_split=1)


def paged_grid(*args):
    B, H = args[0].shape[:2]              # shapes only
    return _grid(B * H, args[9].shape[2], 1)
'''

_RL203_GOOD = r'''
#include <stdint.h>
namespace {
constexpr int STAGES = 2;
constexpr int STAGE_BYTES = 65536;
}
__global__ void staged_kernel(float* out) {
  extern __shared__ uint8_t smem[];
  __shared__ float red[32];
  red[threadIdx.x % 32] = smem[threadIdx.x];
  out[threadIdx.x] = red[0];
}
extern "C" int launch(float* out, void* stream) {
  cudaFuncSetAttribute(staged_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       STAGES * STAGE_BYTES);
  staged_kernel<<<1, 128, STAGES * STAGE_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(out);
  return cudaGetLastError();
}
'''

# four 64 KB stages: 256 KB, past the H100's 227 KB per block
_RL203_BAD = _RL203_GOOD.replace("constexpr int STAGES = 2;",
                                 "constexpr int STAGES = 4;")
# past 48 KB of dynamic shared memory without raising the kernel's limit
_RL203_BAD_OPT_IN = _RL203_GOOD.replace(
    """  cudaFuncSetAttribute(staged_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       STAGES * STAGE_BYTES);
""", "")

_RL401_CUDA_GOOD = r'''
#include <cuda_bf16.h>
__global__ void softmax_row(const __nv_bfloat16* x, float* out, float m) {
  out[threadIdx.x] = expf(__bfloat162float(x[threadIdx.x]) - m);
}
'''

_RL401_CUDA_BAD = r'''
#include <cuda_bf16.h>
__global__ void softmax_row(const __nv_bfloat16* x, float* out, float m) {
  out[threadIdx.x] = __bfloat162float(hexp(x[threadIdx.x]));
}
'''

_RL406_CUDA = r'''
#include <cuda_bf16.h>
#include <stdint.h>
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  __device__ static void lds(const __nv_bfloat16* p, float* out) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 f = __bfloat1622float2(h);
    out[0] = f.x; out[1] = f.y;
  }
};
template <> struct Vec<float> {
  __device__ static void lds(const float* p, float* out) {
    out[0] = p[0]; out[1] = p[1];
  }
};
template <typename KV>
__global__ void dot_rows(const KV* k, const float* q, float* out) {
  float kf[2];
  Vec<KV>::lds(k + 2 * threadIdx.x, kf);
  out[threadIdx.x] = q[0] * kf[0] + q[1] * kf[1];
}
'''


@dataclass
class Fixture:
    rule: str
    bad: str
    good: str
    checker: Callable[[str], List[Finding]]
    path: str = "src/repro_torch/selftest_fixture.py"   # where to seed it


def _ast(path: str) -> Callable[[str], List[Finding]]:
    return lambda src: lint_source(src, path)


def _cuda(src: str) -> List[Finding]:
    return check_cuda_source(src, "src/repro_torch/kernels/x/csrc/x.cu")


def _planner(src: str) -> List[Finding]:
    return check_python_source(src, WAVE_OPS_PATH)


_PY = "src/repro_torch/selftest_fixture.py"
_CU = "src/repro_torch/kernels/x/csrc/x.cu"
FIXTURES: List[Fixture] = [
    Fixture("RL001", _RL001_BAD, _RL001_GOOD, _ast(_PY)),
    Fixture("RL002", _RL002_BAD, _RL002_GOOD, _ast(GRAPHS_PATH), GRAPHS_PATH),
    Fixture("RL003", _RL003_BAD, _RL003_GOOD, _ast(_PY)),
    Fixture("RL004", _RL004_BAD, _RL004_GOOD, _ast(_PY)),
    Fixture("RL201", _RL201_BAD_NOWAIT, _RL201_GOOD, _cuda, _CU),
    Fixture("RL201", _RL201_BAD_PARITY, _RL201_GOOD, _cuda, _CU),
    Fixture("RL201", _RL201_BAD_REFILL, _RL201_GOOD, _cuda, _CU),
    Fixture("RL201", _RL201_BAD_RELEASE, _RL201_GOOD, _cuda, _CU),
    Fixture("RL201", _RL201_STORE_BAD, _RL201_STORE_GOOD, _cuda, _CU),
    Fixture("RL202", _RL202_BAD, _RL202_GOOD, _planner, WAVE_OPS_PATH),
    Fixture("RL203", _RL203_BAD, _RL203_GOOD, _cuda, _CU),
    Fixture("RL203", _RL203_BAD_OPT_IN, _RL203_GOOD, _cuda, _CU),
    Fixture("RL401", _RL401_CUDA_BAD, _RL401_CUDA_GOOD, _cuda, _CU),
]

# bad fixtures by rule (first per rule), with the path to seed them at, so
# tests can plant them in a fake tree and assert the CLI gate trips
BAD_FIXTURES: Dict[str, Fixture] = {}
for _fx in FIXTURES:
    BAD_FIXTURES.setdefault(_fx.rule, _fx)


# ------------------------------------------------------ stage-rule fixtures
# Tiny stages, called through this module so the recorder's patch applies.
def _stage_sync(x):
    if bool(x.sum() > 0):                   # an implicit host sync
        return x + 1
    return x


def _stage_pure(x):
    return x + 1


def _stage_rebind(state):
    return [t + 1 for t in state]           # new tensors, not in place


def _stage_inplace(state):
    for t in state:
        t.add_(1)
    return state


def _stage_copy(x):
    return x * 2.0                          # a fresh copy of a large input


_MOD = "repro_torch.analysis.selftest"


def _stages(**entries) -> Dict[str, Dict]:
    return {name: dict(fn=f"{_MOD}:{fn}", donate=donate, budget="eager",
                       space="device")
            for name, (fn, donate) in entries.items()}


def _record(table, calls) -> Dict[str, List[Finding]]:
    """Each ``(fn, arg)`` of ``calls`` through the recorder; the findings
    per stage."""
    from repro_torch.analysis.stage_check import StageRecorder
    rec = StageRecorder(table)
    with rec:
        mod = sys.modules[__name__]
        for fn, arg in calls:
            getattr(mod, fn)(arg() if callable(arg) else arg)
    return {n: r.findings for n, r in rec.records.items()}


def _selftest_rl101() -> List[str]:
    import torch
    got = _record(_stages(bad=("_stage_sync", ()), good=("_stage_pure", ())),
                  [("_stage_sync", torch.ones(4)),
                   ("_stage_pure", torch.ones(4))])
    fails = []
    if not any(f.rule == "RL101" for f in got.get("bad", [])):
        fails.append("RL101: a stage that syncs was not flagged")
    if got.get("good"):
        fails.append(f"RL101: a pure stage was flagged: "
                     f"{got['good'][0].render()}")
    return fails


def _selftest_rl102() -> List[str]:
    import torch
    state = lambda: [torch.zeros(8), torch.zeros(8)]
    got = _record(_stages(rebind=("_stage_rebind", (0,)),
                          inplace=("_stage_inplace", (0,))),
                  [("_stage_rebind", state), ("_stage_inplace", state)])
    undeclared = _record(_stages(undeclared=("_stage_inplace", ())),
                         [("_stage_inplace", state)])
    fails = []
    if not any(f.rule == "RL102" for f in got.get("rebind", [])):
        fails.append("RL102: a stage that rebinds its state was not flagged")
    if got.get("inplace"):
        fails.append(f"RL102: an in-place stage was flagged: "
                     f"{got['inplace'][0].render()}")
    if not any(f.rule == "RL102" for f in undeclared.get("undeclared", [])):
        fails.append("RL102: an undeclared in-place write was not flagged")
    return fails


class _Graph:
    STAGES = ("decode",)

    def __init__(self, captures: int):
        self.captures = captures


def rl103_findings(captures_per_build: List[int], device: str = "cuda",
                   eager_calls: int = 1) -> List[Finding]:
    """RL103 over a seeded run: graphs of the "decode" stage built with
    these capture counts, and an eager stage called ``eager_calls`` times."""
    from repro_torch.analysis.stage_check import (RunReport, StageRecord,
                                                  StageRecorder,
                                                  budget_findings)
    table = {"decode": dict(budget="per_geometry", space="device"),
             "flush": dict(budget="eager", space="device")}
    rec = StageRecorder(table)
    rec.graphs = [_Graph(c) for c in captures_per_build]
    rec.records["decode"] = StageRecord("decode", calls=2)  # warm-up, capture
    if eager_calls:
        rec.records["flush"] = StageRecord("flush", calls=eager_calls)
    run = RunReport("seeded", rec, ("decode", "flush"), device)
    return budget_findings(run, table)


def _selftest_rl103() -> List[str]:
    fails = []
    if not any(f.rule == "RL103" for f in rl103_findings([8])):
        fails.append("RL103: a capture per step was not flagged")
    if not any(f.rule == "RL103" for f in rl103_findings([1, 1])):
        fails.append("RL103: a second graph of one geometry was not flagged")
    if not any(f.rule == "RL103" for f in rl103_findings([1], eager_calls=0)):
        fails.append("RL103: a bypassed eager stage was not flagged")
    if rl103_findings([1]) or rl103_findings([0], device="cpu"):
        fails.append("RL103: a stage within its budget was flagged")
    return fails


def _selftest_rl104() -> List[str]:
    import torch
    got = _record(_stages(copy=("_stage_copy", ()), good=("_stage_pure", ())),
                  [("_stage_copy", torch.zeros(1 << 15)),
                   ("_stage_pure", torch.zeros(16))])
    fails = []
    if not any(f.rule == "RL104" and f.severity == "advice"
               for f in got.get("copy", [])):
        fails.append("RL104: a fresh copy of a large input was not advised")
    if got.get("good"):
        fails.append("RL104: a small stage was advised")
    return fails


# ---------------------------------------------- retrosched (RL3xx) fixtures
# Schedule fixtures are op sequences resolved through the port's
# SERVE_STAGES effects (schedule_model.build_trace), so each exercises
# exactly the model the live engine is held to.
def _sched_check(schedule, rule: str, expect: bool, label: str) -> List[str]:
    from repro_torch.analysis.schedule_check import check_trace
    from repro_torch.analysis.schedule_model import build_trace
    hits = [f for f in check_trace(build_trace(schedule, 2))
            if f.rule == rule]
    if expect and not hits:
        return [f"{rule}: {label} schedule not flagged"]
    if not expect and hits:
        return [f"{rule}: {label} schedule falsely flagged: "
                f"{hits[0].render()}"]
    return []


def _selftest_rl301() -> List[str]:
    from repro_torch.analysis.schedule_check import reference_schedule
    bad: List[tuple] = []
    held = None
    for ev in reference_schedule():
        if ev[2] in ("cache_stage", "cache_upd"):
            held = ev
            continue
        bad.append(ev)
        if ev[2] == "attend_fn" and held is not None:
            bad.append(held)
            held = None
    fails = _sched_check(bad, "RL301", True, "attend-before-staging-write")
    fails += _sched_check(reference_schedule(), "RL301", False,
                          "pipelined reference")
    return fails


def _selftest_rl302() -> List[str]:
    from repro_torch.analysis.schedule_check import reference_schedule
    fails = _sched_check(reference_schedule(drop_mirror=True), "RL302",
                         True, "mirror-dropping")
    fails += _sched_check(reference_schedule(), "RL302", False,
                          "pipelined reference")
    return fails


def _selftest_rl303() -> List[str]:
    from repro_torch.analysis.schedule_check import reference_schedule
    mirror = {"effects": {"writes": ("cache_body[l]",)}}
    logits_sync = {"effects": {"reads": ("logits",)}}

    def with_host_mirror(synced: bool):
        sched = list(reference_schedule(steps=1))
        tail = [(0, 1, "host_mirror", "host", mirror)]
        if synced:
            tail.insert(0, (0, -1, "sample_sync", "sync", logits_sync))
        return sched + tail

    fails = _sched_check(with_host_mirror(False), "RL303", True,
                         "unsynced host mirror")
    fails += _sched_check(with_host_mirror(True), "RL303", False,
                          "synced host mirror")
    return fails


def _selftest_rl304() -> List[str]:
    from repro_torch.analysis.schedule_check import reference_schedule
    fails = _sched_check(reference_schedule(pipelined=False), "RL304",
                         True, "unpipelined")
    fails += _sched_check(reference_schedule(), "RL304", False,
                          "pipelined reference")
    return fails


def _selftest_rl305() -> List[str]:
    from repro_torch.analysis.schedule_check import reference_schedule
    leaky = {"effects": {"reads": ("hidden", "live[l]"),
                         "writes": ("ctx[l]", "ids[l]"),
                         "donates": ("live[l]",)}}
    bad = [ev if ev[2] != "rank_fn" else ev[:4] + (leaky,)
           for ev in reference_schedule(steps=1)]
    fails = _sched_check(bad, "RL305", True, "donation-without-rebind")
    fails += _sched_check(reference_schedule(), "RL305", False,
                          "pipelined reference")
    return fails


# ------------------------------------------------------- retronum (RL4xx)
def _num_check(fn, make_args, rule: str, want_bad: bool,
               label: str) -> List[str]:
    """Trace ``fn`` on fake CUDA tensors through the numerics pass; assert
    the rule fires (bad twin) or that no error fires at all (good twin)."""
    from repro_torch.analysis.numerics_check import numerics_findings
    fs, _ = numerics_findings(fn, make_args, label,
                              path="src/repro_torch/analysis/selftest.py")
    errs = [f for f in fs if f.severity == "error"]
    if want_bad:
        return [] if any(f.rule == rule for f in errs) \
            else [f"{rule}: {label} not flagged"]
    return [f"{rule}: {label} falsely flagged: {errs[0].render()}"] \
        if errs else []


def _fake(*specs):
    """make_args for fake CUDA tensors of (shape, dtype) specs."""
    import torch

    def make():
        return tuple(torch.zeros(shape, dtype=getattr(torch, dt),
                                 device="cuda") for shape, dt in specs)
    return make


def _selftest_rl401() -> List[str]:
    import torch
    x = _fake(((8, 16), "bfloat16"))
    fails = _num_check(lambda a: torch.softmax(a, dim=-1), x, "RL401", True,
                       "bf16 softmax chain")
    fails += _num_check(lambda a: torch.softmax(a.float(), dim=-1), x,
                        "RL401", False, "f32-upcast softmax chain")
    return fails


def _selftest_rl402() -> List[str]:
    import torch
    ab = _fake(((2048, 2048), "bfloat16"), ((2048, 64), "bfloat16"))
    fails = _num_check(lambda a, b: a @ b, ab, "RL402", True,
                       "bf16 matmul with a bf16 output")
    fails += _num_check(lambda a, b: a.float() @ b.float(), ab, "RL402",
                        True, "explicit whole-store pre-upcast")
    fails += _num_check(
        lambda a, b: torch.mm(a, b, out_dtype=torch.float32), ab, "RL402",
        False, "storage operands with out_dtype=float32")
    return fails


def _selftest_rl403() -> List[str]:
    import torch
    x = _fake(((8, 8), "float32"))
    fails = _num_check(lambda a: a.to(torch.bfloat16).float() + 1.0, x,
                       "RL403", True, "f32->bf16->f32 round trip")
    fails += _num_check(lambda a: a + 1.0, x, "RL403", False,
                        "straight f32 chain")
    return fails


def _selftest_rl404() -> List[str]:
    import torch
    x = _fake(((8, 8), "float32"))
    fails = _num_check(lambda a: a.to(torch.bfloat16) * 2.0, x, "RL404",
                       True, "mid-stage downcast consumed by compute")
    fails += _num_check(lambda a: (a * 2.0).to(torch.bfloat16), x, "RL404",
                        False, "output-only downcast")
    return fails


def _selftest_rl405() -> List[str]:
    import torch
    from repro_torch.analysis.numerics_check import parts_findings
    parts = _fake(((2, 4), "float32"), ((2,), "float32"), ((2,), "float32"))
    fails = []
    fs = parts_findings(lambda n, d, m: (n, d.to(torch.bfloat16), m), parts,
                        "bf16-den", path="selftest")
    if not any(f.rule == "RL405" for f in fs):
        fails.append("RL405: a bf16 LSE-merge partial was not flagged")
    fs = parts_findings(lambda n, d, m: (n, d, m), parts, "f32-parts",
                        path="selftest")
    if fs:
        fails.append(f"RL405: f32 parts falsely flagged: {fs[0].render()}")

    def merge(cast):
        from repro_torch.core import distributed

        def fn(n, d, m):
            x = n.to(torch.bfloat16) if cast else n
            return distributed.all_reduce(x, None)
        return fn
    fails += _num_check(merge(True), parts, "RL405", True,
                        "all_reduce over bf16 partials")
    fails += _num_check(merge(False), parts, "RL405", False,
                        "all_reduce over f32 partials")
    return fails


def _selftest_rl406() -> List[str]:
    import os
    from repro_torch.analysis.kernel_check import inventory_tree
    fails = []
    fs = check_cuda_source(_RL406_CUDA, _CU)
    inv = [f for f in fs if f.rule == "RL406"]
    if not inv:
        fails.append("RL406: a bf16 Vec<KV>::lds call site was not "
                     "inventoried")
    if any(f.severity != "advice" for f in inv) or \
            [f for f in fs if f.severity == "error"]:
        fails.append("RL406: inventory entries must be advice, and the "
                     "fixture must hold no error")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    tree = inventory_tree(root)
    if not tree or any("/csrc/" not in f.path for f in tree):
        fails.append("RL406: the kernels' cast inventory came back empty "
                     "or outside csrc/")
    return fails


def run_selftests(include_traced: bool = True) -> List[str]:
    """Run every fixture; return failure descriptions (empty = all pass)."""
    fails: List[str] = []
    for i, fx in enumerate(FIXTURES):
        bad_hits = [f for f in fx.checker(fx.bad) if f.rule == fx.rule]
        if not bad_hits:
            fails.append(f"{fx.rule} (fixture {i}): bad snippet not flagged")
        good_hits = [f for f in fx.checker(fx.good)
                     if f.severity == "error"]
        if good_hits:
            fails.append(
                f"{fx.rule} (fixture {i}): good snippet flagged: "
                f"{good_hits[0].render()}")
    fails += _selftest_rl301()
    fails += _selftest_rl302()
    fails += _selftest_rl303()
    fails += _selftest_rl304()
    fails += _selftest_rl305()
    fails += _selftest_rl406()
    if include_traced:
        fails += _selftest_rl101()
        fails += _selftest_rl102()
        fails += _selftest_rl103()
        fails += _selftest_rl104()
        fails += _selftest_rl401()
        fails += _selftest_rl402()
        fails += _selftest_rl403()
        fails += _selftest_rl404()
        fails += _selftest_rl405()
    return fails
