"""Finding/rule plumbing shared by every retrolint pass of the port.

Counterpart of ``repro/analysis/findings.py``: the same ``Rule`` and
``Finding`` types, the same fingerprint algorithm, pragma grammar and
baseline format, and the same 22 rule ids, titles and severities. The rule
explanations describe the hazards as they arise in PyTorch and CUDA on an
H100: in-place state updates where JAX donates, captured CUDA graphs where
JAX compiles, mbarrier rings where Pallas double-buffers DMAs, shared memory
where the TPU has VMEM.

A ``Finding`` is one rule violation at one source location. Its
``fingerprint`` excludes the line number (baselines survive unrelated edits
above a suppressed site) and hashes the rule id, repo-relative path,
enclosing qualname and a normalized message instead.

Suppression has three layers, narrowest wins:

* ``# retrolint: sync(<reason>)`` on the flagged line (``//`` in CUDA
  sources) sanctions exactly one host sync (RL001, and the syncs the
  trace pass sees: RL101 and the dynamic half of RL001); the reason is
  mandatory;
* ``# retrolint: ignore(RLxxx: <reason>)`` on the flagged line suppresses
  the named rule at that site;
* the checked-in baseline file (``lint_baseline_torch.txt``): fingerprints
  of known findings; the CLI fails only on findings NOT in the baseline.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# the reference's grammar, with CUDA's line comment beside Python's
PRAGMA_RE = re.compile(
    r"(?:#|//)\s*retrolint:\s*(sync|ignore|hot)\s*(?:\(([^)]*)\))?")


@dataclass(frozen=True)
class Rule:
    rule_id: str
    title: str
    summary: str                # one line, shown in listings
    explain: str                # long form, shown by --explain


@dataclass
class Finding:
    rule: str
    path: str                   # repo-relative, "/" separators
    line: int
    qualname: str               # enclosing def/class chain (or stage name)
    message: str
    severity: str = "error"     # "error" fails the gate; "advice" never does

    @property
    def fingerprint(self) -> str:
        norm = re.sub(r"\d+", "#", self.message)    # shape/count agnostic
        h = hashlib.sha1(
            f"{self.rule}|{self.path}|{self.qualname}|{norm}".encode()
        ).hexdigest()[:12]
        return f"{self.rule}:{self.path}:{self.qualname}:{h}"

    def render(self) -> str:
        sev = "" if self.severity == "error" else f" [{self.severity}]"
        return (f"{self.path}:{self.line}: {self.rule}{sev} "
                f"({self.qualname}) {self.message}")


# --------------------------------------------------------------------- rules
RULES: Dict[str, Rule] = {}


def _rule(rule_id: str, title: str, summary: str, explain: str) -> None:
    RULES[rule_id] = Rule(rule_id, title, summary, explain)


_rule(
    "RL001", "host-sync-in-hot-path",
    "Host-sync call inside a decode hot-path function without a sync pragma.",
    """Functions on the decode hot path (ast_rules.HOT_PATHS, or tagged
`# retrolint: hot` on their def line) may not block the host on the card:
.item(), .tolist(), .cpu(), .numpy(), .to("cpu"), .synchronize(),
torch.cuda.synchronize(), np.asarray / np.array. Each one waits for every
kernel queued on the stream and serializes the decode loop, whose only
planned waits are the lagged id harvest and the offload plane's per-layer id
readback. Torch also syncs implicitly: bool(t), int(t), float(t) and `if t:`
on a tensor call aten._local_scalar_dense. The lexical pass cannot see
those, so the trace pass reports every _local_scalar_dense a serve makes from
a hot-path line that carries no pragma (the dynamic half of this rule).
Each sanctioned sync is annotated in place:

    ids = self.host.numpy()  # retrolint: sync(lagged id harvest)

Fix: keep the value on the card (sample on the card, copy into pinned memory
behind an event), or move the read off the per-step path. If the sync is
load-bearing, annotate it with `# retrolint: sync(<why>)`.""")

_rule(
    "RL002", "traced-python-control-flow",
    "Python if/for/while on a tensor value inside a CUDA-graph-captured "
    "function.",
    """A decode step captured into a CUDA graph (DecodeGraph, OffloadStage)
runs its Python once, during capture; replays repeat the recorded kernels.
A Python `if`, `while` or `for` on a tensor value inside the captured body
either syncs (and the capture fails: a sync is illegal while capturing) or,
on the CPU where the step runs eagerly, silently works, and the graph then
bakes in the branch taken at capture for every later step. Use torch.where
or masked updates for data-dependent choices and fixed trip counts for
loops. Static configuration (None checks, shapes, dtypes, ints) is fine.

The pass is lexical: it inspects the functions ast_rules.CAPTURED lists as
captured, seeded with the names that hold tensors there, and follows the
taint through assignments.""")

_rule(
    "RL003", "jit-inside-loop",
    "A CUDA graph, captured stage or torch.compile built inside a loop body.",
    """Each torch.cuda.CUDAGraph(), torch.cuda.graph(...), DecodeGraph(...),
OffloadStage(...) or torch.compile(...) made inside a `for`/`while` body
captures (or compiles) again every iteration and keeps every graph's memory
pool alive. Build it once per geometry outside the loop (the engine makes one
per `serve` call) and replay it inside.""")

_rule(
    "RL004", "reuse-after-donation",
    "An alias of an in-place stage argument is taken before the call and "
    "read after it.",
    """The port updates serve state in place where the reference donates it
(SERVE_STAGES' `donate` positions). A name bound to such an argument, or to
its attribute or subscript, without .clone(), is a view of the same storage:
read after the in-place call it silently holds the NEW values. In the
reference the dead donated buffer raises; here nothing does, and a
comparison of a state with its later self passes vacuously. Copy the state
(.clone(), interop.*_to_numpy) before the call you compare across.""")

_rule(
    "RL101", "callback-primitive-in-stage",
    "A device serve stage syncs the host or copies to the host.",
    """The decode-loop contract is that every device stage is pure device
work: host work happens only at the annotated control-plane points between
stages. Inside a stage, aten._local_scalar_dense (.item(), bool(t),
int(t)) or a copy from the card to the host is a hidden per-step round trip:
it serializes the stream, and under CUDA-graph capture it is illegal. The
trace pass runs every SERVE_STAGES stage of two tiny serves under a
TorchDispatchMode and reports each such op whose source line carries no sync
pragma. Move the host work to the control plane (_OffloadPlane.decode_step)
or delete it.""")

_rule(
    "RL102", "donation-not-aliased",
    "An in-place stage argument is rebound or never written in place, or a "
    "stage writes an argument its contract does not name.",
    """A captured graph replays at fixed addresses, so a stage that updates
state must write the state's own tensors: the contract (SERVE_STAGES
`donate`, the port's in-place positions) names them. The trace pass checks,
per recorded stage call, that every tensor of a named argument keeps its
data_ptr (graphs.state_addresses) and that some mutating op wrote its
storage, and that no other argument's storage was written. A rebound tensor
silently degrades an in-place update into a copy and breaks replays; an
undeclared write is an in-place update the contract does not show.""")

_rule(
    "RL103", "recompile-budget-exceeded",
    "A serve stage was captured (or built) more or less often than its "
    "budget.",
    """Across a mixed serve run each captured stage is built and captured a
fixed number of times: one DecodeGraph or OffloadStage per serve geometry,
captured once on the card (the CPU runs it eagerly: no capture). Stages the
port runs eagerly (`budget="eager"`: admission, flushes, sampling) must run
and never be captured. More captures means per-step state leaks into the
graph's key; zero calls means the stage was renamed or bypassed and the
contract no longer measures it.""")

_rule(
    "RL104", "missed-donation",
    "A stage allocates a fresh output shaped like a large input it does not "
    "update in place (advice).",
    """Heuristic, advisory only: the stage returns a freshly allocated tensor
with exactly the shape and dtype of a large (>= 64 KiB) input it does not
update in place, which usually means an update that pays a full copy and a
new address every step (and so cannot be replayed). Update the input in
place and add it to the stage's `donate`; list it in `copy_ok` if the
output is genuinely fresh data.""")

_rule(
    "RL201", "dma-wait-before-reuse",
    "Shared-memory ring slot read or refilled without the matching mbarrier "
    "wait.",
    """The k-means assign kernel streams centroid tiles and point rows into a
ring of STAGES shared-memory slots: a producer warpgroup fills slot s (one
bulk copy and cp.async copies, completing on full[s]), the consumers wait on
full[s] with the phase's parity, read it, and arrive on empty[s], which the
producer waits on before refilling. The block gather fills one buffer with a
bulk copy on one barrier and stores it back with a bulk copy that must have
read shared memory before the block exits. The checker extracts that event
sequence from the CUDA source (helper functions classified by the PTX they
issue), unrolls the ring for a few trips and flags a read without its full
wait, a refill before the empty wait, a wait with the wrong parity, a copy
not tracked by its slot's barrier, a slot released before its last read, and
a copy still in flight at exit. A violated order is a silent data race on
the card that no CPU test can see.""")

_rule(
    "RL202", "impure-blockspec-index-map",
    "A launch-geometry planner depends on tensor values.",
    """A captured CUDA graph bakes in the grid, block and shared-memory size
of every launch it records. The planners that size them (wave_attention
ops.split_plan, paged_grid, merge_grid, _workspace; the gather's and the
k-means step's launch arguments) must therefore be pure functions of shapes
and Python ints. A planner that reads a tensor value (.item(), int(t), a
branch on a tensor) syncs the host and, once captured, replays the geometry
of the capture step for every later step.""")

_rule(
    "RL203", "vmem-budget-exceeded",
    "Static plus dynamic shared memory of a kernel exceeds the budget.",
    """Sums each kernel's static __shared__ declarations and the dynamic
bytes its launch site asks for, with every constant parsed from the CUDA
sources (STAGES, the tile sizes, struct layouts) and the remaining symbols
resolved from the geometry env (see --geometry), and holds the total against
--smem-budget (default: the H100's 227 KiB per block, 232448 bytes). A
kernel whose dynamic size can pass 48 KiB must also raise its limit with
cudaFuncSetAttribute(MaxDynamicSharedMemorySize), else the launch fails.
Exceeding the budget means the launch fails at that geometry: cut STAGES or
the tile before it reaches the card.""")

_rule(
    "RL301", "staging-read-before-miss-write",
    "Attend reads the miss staging tail before this step's staging write "
    "landed (or the staging write consumed miss payloads not yet built).",
    """The offload decode step stages this step's cache misses into the tail
slots [C, C+r) of the device block cache, then attends over them. In the
happens-before model of the recorded schedule, every ``attend_fn`` that
reads ``cache_tail[l]`` must be preceded (stream order, same step) by the
``cache_stage``/``cache_upd`` write that staged this step's misses, and that
launch must itself follow the host-side ``translate`` that built the miss
payloads. A schedule that launches the attend first reads stale tail
payloads from the PREVIOUS step: silently wrong attention.""")

_rule(
    "RL302", "stale-mapping-table",
    "Translation consulted after a slot-remapping apply_updates whose "
    "device-cache mirror has not landed (stale ClusterMappingTable).",
    """``apply_updates`` (the deferred-admission drain) remaps mapping-table
entries to device-cache slots and queues the payload mirror; the mirror is
scattered into the device cache by the NEXT step's ``cache_upd``. The attend
consuming the new slot ids must be preceded by a ``cache_upd`` that consumed
the admission queue, otherwise the kernel reads whatever the evicted cluster
left in those slots.""")

_rule(
    "RL303", "mirror-overwrites-inflight-slot",
    "A host-space write lands in a device cache buffer racing an in-flight "
    "attend (no sync or stream edge orders them).",
    """Device-side writes to the block cache are safe because the stream
orders them against the attends that read the same buffers. A write that
does not ride the stream (a host-side copy into the cache, a transfer on a
second stream) races any attend launched but not yet proven complete by a
host sync on a later stream value. Keep mirror updates in the captured
cache update so the stream orders them.""")

_rule(
    "RL304", "pipeline-opportunity",
    "A host sync blocks with an idle host while independent host work "
    "exists that could overlap it (advice).",
    """For every blocking readback the checker looks at the host-order gap
between the producing launch and the sync: if the host did nothing in that
gap, and a host-side op with real effects sits immediately before the
producer with no dependency path into it, that op could run inside the gap.
This is the finding behind the layer-pipelined offload schedule: layer
l+1's rank is launched (and its ids' copy started) before layer l's drain,
so the id wait overlaps the drain and the card's attend.""")

_rule(
    "RL305", "donation-reuse-across-overlap",
    "A donated buffer is read or re-donated by a later op without being "
    "rebound in between.",
    """In the happens-before model every buffer an op donates (updates in
place, with the old contents dead) must be rebound (written, or passed
through) before any later event reads or re-donates it. The AST rule RL004
catches the lexical version of this; RL305 checks the recorded schedule,
where the reuse can span stages that no single function body shows.""")

_rule(
    "RL401", "sub-f32-softmax-chain",
    "A softmax/exp/log/LSE-chain transcendental computes on a sub-f32 "
    "float operand.",
    """The accuracy-bounded estimation math (paper Sec. 4.4) hinges on the
softmax/log-sum-exp chain being computed in f32. The numerics pass records
the aten ops of every curated decode target (fake CUDA tensors: the path the
card runs) and flags exp/exp2/log/log2/log1p/expm1/sigmoid/tanh/softmax/
logsumexp on an operand narrower than the contract's floor. In the CUDA
sources it flags any bf16/half transcendental intrinsic (hexp, h2exp, hlog,
...) in device code. Fix: upcast the operand row, never the store.""")

_rule(
    "RL402", "dot-accumulation-contract",
    "A matmul violates the storage-dtype-operand + f32-output accumulation "
    "contract.",
    """(a) a matmul (mm, bmm, baddbmm, einsum, ...) with sub-f32 operands and
a sub-f32 output rounds its result to bf16; pass out_dtype=torch.float32
(attention._f32_product on the card). (b) the hoisted-cast hazard: an
explicit .float() of >= 4 MiB of stored operand feeding a matmul converts
and writes the WHOLE store at 2x the bytes every decode step; keep operands
in their storage dtype and let the kernel (or out_dtype) widen per tile.""")

_rule(
    "RL403", "double-rounding",
    "A value is round-tripped f32 -> sub-f32 -> f32 before accumulation "
    "(two roundings where the contract allows one).",
    """Narrowing to bf16 and widening back rounds twice: once at the
narrowing and once wherever the widened value is consumed against other
rounded values. The contract allows one narrowing per value (the stage
output, or a store write that a later stage widens on read). The pass
flags a widening whose producer, through views, is a narrowing from an
equal-or-wider dtype.""")

_rule(
    "RL404", "unsanctioned-downcast",
    "A narrowing cast is consumed by general compute — the only sanctioned "
    "narrowings are the stage output and same-dtype storage writes.",
    """The sanctioned narrowings are the final .to(q.dtype) of the output, a
cast feeding a same-dtype store write (copy_, index_put_, scatter into a
bf16 store) and a matmul whose output is f32. Any other consumer of a
narrowed value (adds, muls, reductions, transcendentals) means part of the
fold runs in bf16 mid-stage. Fix: move the narrowing to the stage boundary,
or drop it.""")

_rule(
    "RL405", "lse-merge-dtype-mismatch",
    "The LSE-merge path (return_parts / distributed psum) carries a "
    "sub-f32 partial accumulator or collective.",
    """`wave_attention_decode(..., return_parts=True)` returns the raw
(num, den, m) partials so ranks (`core/distributed.py`) can merge attentions
over disjoint cluster sets: the global max, rescale, sum, divide once. The
merge is only exact if every partial stays f32 until the single final
downcast. The pass checks the parts triple's dtypes and flags every
collective (dist.all_reduce and the c10d ops) over a sub-f32 operand.""")

_rule(
    "RL406", "cast-site-inventory",
    "Certified VMEM-stage cast-site inventory for the paged kernel "
    "(advice).",
    """Not a defect: the certified list of every per-block widening in the
CUDA attention kernels, by file and line: each call site of Vec<T>::lds
where T can be a 16-bit storage type (the K rows of a tile in fold_tile,
the V rows in Acc::add), and every direct conversion intrinsic in a kernel
body, with source and destination types and the block widened. These are
where a quantized payload store would hook per-cluster dequantization: a
site disappearing or a new one appearing shows up as a diff in this advice
list (and in the `--json-out` artifact).""")


def explain_rule(rule_id: str) -> Optional[str]:
    r = RULES.get(rule_id)
    if r is None:
        return None
    return f"{r.rule_id} — {r.title}\n\n{r.summary}\n\n{r.explain}\n"


# ------------------------------------------------------------------ pragmas
@dataclass
class Pragmas:
    """Per-file pragma index: line -> (kind, payload)."""
    by_line: Dict[int, List] = field(default_factory=dict)

    @classmethod
    def scan(cls, source: str) -> "Pragmas":
        p = cls()
        for i, text in enumerate(source.splitlines(), start=1):
            for m in PRAGMA_RE.finditer(text):
                p.by_line.setdefault(i, []).append(
                    (m.group(1), (m.group(2) or "").strip()))
        return p

    def sanctions_sync(self, line: int) -> bool:
        return any(k == "sync" and payload
                   for k, payload in self.by_line.get(line, []))

    def ignores(self, line: int, rule_id: str) -> bool:
        return any(k == "ignore" and rule_id in payload
                   for k, payload in self.by_line.get(line, []))

    def marks_hot(self, line: int) -> bool:
        return any(k == "hot" for k, _ in self.by_line.get(line, []))


# ----------------------------------------------------------------- baseline
BASELINE_NAME = "lint_baseline_torch.txt"


def load_baseline(path: str) -> set:
    try:
        with open(path) as f:
            return {ln.strip() for ln in f
                    if ln.strip() and not ln.lstrip().startswith("#")}
    except FileNotFoundError:
        return set()


def write_baseline(path: str, findings: List[Finding]) -> None:
    with open(path, "w") as f:
        f.write("# retrolint suppression baseline — one fingerprint per "
                "line.\n# Regenerate with: python -m repro_torch.launch.lint "
                "--write-baseline\n")
        for fp in sorted({x.fingerprint for x in findings
                          if x.severity == "error"}):
            f.write(fp + "\n")


def apply_baseline(findings: List[Finding], baseline: set) -> List[Finding]:
    """Errors whose fingerprint is baselined are dropped; advice passes
    through untouched (it never gates)."""
    return [f for f in findings
            if f.severity != "error" or f.fingerprint not in baseline]
