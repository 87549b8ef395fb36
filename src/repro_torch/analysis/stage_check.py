"""Trace-time contract checks (RL101-RL104, and the dynamic half of RL001)
over the port's serve stages.

Counterpart of ``repro/analysis/jaxpr_check.py``. Rather than hardcoding
what the engine runs, the checker *records* it: ``StageRecorder`` wraps the
callable of every ``SERVE_STAGES`` entry (its ``fn``) and counts the
``DecodeGraph`` / ``OffloadStage`` objects built, while a
``TorchDispatchMode`` sees every aten op of a real (tiny-config, or on the
card full-width) serve. Each top-level stage call is then held to its
contract:

* RL101 — no ``aten._local_scalar_dense`` and no copy from the card to the
  host inside a device stage, unless the source line carries a sync pragma;
* RL102 — every tensor of an in-place (``donate``) argument keeps its
  address (``graphs.state_addresses``) and its storage is written by a
  mutating op; no other argument's storage is written;
* RL103 — each captured stage's graph is built once per serve geometry and
  captured once on the card (none on the CPU, which runs it eagerly); an
  eager stage runs when its run plan says it does, and never otherwise;
* RL104 — (advice) a fresh output with the shape and dtype of a large input
  the stage does not update in place;
* RL001 (dynamic) — every ``_local_scalar_dense`` of the serve (``bool(t)``,
  ``int(t)``, ``.item()``) reached from a hot-path function with no sync
  pragma on the way: torch syncs implicitly where JAX's are explicit calls.

One full check is two short serves: chunked admission with the host-offload
plane (greedy), and blocking admission with the direct store (sampled). The
offload serve doubles as the retrosched recording (``ScheduleRecorder``).
Replays of a captured graph dispatch nothing: the recorder sees the warm-up
step and the capture, and counts the captures.
"""
from __future__ import annotations

import ast
import functools
import importlib
import os
import sys
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import ast_rules
from repro_torch.analysis.findings import Finding, Pragmas
from repro_torch.serving.graphs import leaves, state_addresses

ENGINE_PATH = "src/repro_torch/serving/engine.py"
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))                    # .../src
_PKG = os.path.join(_SRC, "repro_torch") + os.sep
_ANALYSIS = os.path.dirname(os.path.abspath(__file__)) + os.sep

# RL104 only looks at inputs at least this large: below it a copy is noise
_RL104_MIN_BYTES = 1 << 16

# the ops that read a tensor's value on the host (under inference mode
# ``bool(t)`` reaches Python dispatch as ``is_nonzero``)
_SYNC_OPS = {"aten._local_scalar_dense", "aten.is_nonzero", "aten.item",
             "aten.equal"}

# the reference's tiny geometry (``jaxpr_check._tiny_setup``) and requests
LENGTHS = (48, 72, 96, 72)          # ragged mix, one duplicate length
MAX_NEW = 40


def _tiny_setup(device="cpu"):
    from repro_torch.configs.base import AttnConfig, ModelConfig, RetroConfig
    from repro_torch.models import model as M
    retro = RetroConfig(avg_cluster=8, cluster_cap=64, prefill_segment=64,
                        update_segment=32, sink=4, local=32,
                        retrieval_frac=1.0, estimation_frac=0.0,
                        kmeans_iters=3)
    cfg = ModelConfig(
        arch_id="retrolint-tiny", family="dense", n_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        dtype="float32", retro=retro)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, M.init_params(cfg, gen, device=device)


def _requests(lengths: Sequence[int], max_new: int, vocab: int = 250):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(0)
    return [Request(prompt=rng.randint(1, vocab, size=(n,)).astype(np.int32),
                    max_new_tokens=max_new) for n in lengths]


# ------------------------------------------------------------ source sites
class _Sites:
    """Pragmas and statement spans of the port's files, by path, for
    telling a sanctioned sync from an unannotated one."""

    def __init__(self) -> None:
        self._cache: Dict[str, Tuple[Pragmas, Dict[int, Tuple[int, int]]]] = {}

    def _load(self, path: str):
        if path not in self._cache:
            with open(os.path.join(os.path.dirname(_SRC), path)) as f:
                src = f.read()
            spans: Dict[int, Tuple[int, int]] = {}
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, ast.stmt) and not isinstance(
                        node, (ast.FunctionDef, ast.ClassDef, ast.If,
                               ast.For, ast.While, ast.With, ast.Try)):
                    for ln in range(node.lineno, (node.end_lineno or
                                                  node.lineno) + 1):
                        prev = spans.get(ln)
                        if prev is None or prev[1] - prev[0] > \
                                (node.end_lineno or ln) - node.lineno:
                            spans[ln] = (node.lineno, node.end_lineno or ln)
            self._cache[path] = (Pragmas.scan(src), spans)
        return self._cache[path]

    def sanctioned(self, path: str, line: int) -> bool:
        """A sync pragma on the statement that holds ``line``."""
        pragmas, spans = self._load(path)
        lo, hi = spans.get(line, (line, line))
        return any(pragmas.sanctions_sync(ln) for ln in range(lo, hi + 1))

    def hot(self, path: str, qualname: str, def_line: int) -> bool:
        pragmas, _ = self._load(path)
        return qualname in ast_rules.HOT_PATHS.get(path, ()) \
            or pragmas.marks_hot(def_line)


def _frames() -> List[Tuple[str, int, str, int]]:
    """(repo path, line, qualname, def line) of the port's frames on the
    stack, innermost first (the analysis package's own frames skipped)."""
    out = []
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)     # "tests/../src/..."
        if fn.startswith(_PKG) and not fn.startswith(_ANALYSIS):
            rel = "src/" + os.path.relpath(fn, _SRC).replace(os.sep, "/")
            qual = f.f_code.co_qualname.replace("<locals>.", "")
            out.append((rel, f.f_lineno, qual, f.f_code.co_firstlineno))
        f = f.f_back
    return out


# --------------------------------------------------------------- recording
@dataclass
class StageCall:
    """What one top-level call of a stage did."""
    name: str
    syncs: List[Tuple[str, Tuple]] = field(default_factory=list)
    written: set = field(default_factory=set)       # storage addresses


@dataclass
class StageRecord:
    name: str
    calls: int = 0
    findings: List[Finding] = field(default_factory=list)
    seen: set = field(default_factory=set)           # dedup keys

    def add(self, f: Finding) -> None:
        key = (f.rule, f.path, f.line, f.message)
        if key not in self.seen:
            self.seen.add(key)
            self.findings.append(f)


def _leaves(tree) -> List[torch.Tensor]:
    return list(leaves(tree))


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in _leaves(tree)
            if t.device.type != "meta"}


def _find_like(out, arg):
    """The object in ``out`` (walked through tuples and lists) of ``arg``'s
    type with as many tensors: the stage's updated version of ``arg``."""
    n = len(_leaves(arg))
    stack = [out]
    while stack:
        o = stack.pop(0)
        if type(o) is type(arg) and len(_leaves(o)) == n:
            return o
        if isinstance(o, (tuple, list)) and not isinstance(o, torch.Tensor):
            stack.extend(o)
    return None


def _resolve(spec: str):
    """"module:Attr.attr" -> (owner object, attribute name)."""
    mod, qual = spec.split(":")
    owner = importlib.import_module(mod)
    parts = qual.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class StageRecorder(TorchDispatchMode):
    """Context manager: record every SERVE_STAGES stage call, the graphs
    built, and the serve's host syncs, leaving behavior untouched."""

    def __init__(self, stage_table: Optional[Dict[str, Dict]] = None):
        super().__init__()
        if stage_table is None:
            from repro_torch.serving.engine import SERVE_STAGES
            stage_table = SERVE_STAGES
        self.table = stage_table
        self.records: Dict[str, StageRecord] = {}
        self.graphs: List[Any] = []
        self.hot_syncs: List[Tuple[str, int, str, str]] = []
        self.active: Optional[StageCall] = None
        self.last_cache_op = "cache_stage"
        self.sites = _Sites()
        self._patches: List[Tuple[Any, str, Any]] = []
        self._writes: Dict[Any, List[Tuple[int, str]]] = {}

    # -- which stage a shared callable ran
    def _route(self, spec: str, names: List[str], args, kwargs) -> str:
        if len(names) == 1:
            return names[0]
        if "argmax_ids" in names:
            return "argmax_ids" if args[0].generator is None \
                else "categorical_ids"
        if "chunk_pe" in names:
            batch = args[2] if len(args) > 2 else kwargs.get("batch", {})
            return "chunk_pe" if "patch_embeds" in batch else "chunk"
        if "cache_upd" in names:       # the op the plane traced for it
            return self.last_cache_op
        return names[0]

    def _wrap(self, spec: str, names: List[str], orig: Callable):
        rec = self

        @functools.wraps(orig)
        def stage(*args, **kwargs):
            if rec.active is not None:         # nested: the outer stage's
                return orig(*args, **kwargs)
            name = rec._route(spec, names, args, kwargs)
            call = StageCall(name)
            before = [_storages(a) for a in args]
            addr = [state_addresses(a) for a in args]
            rec.active = call
            try:
                out = orig(*args, **kwargs)
            finally:
                rec.active = None
            rec._check_call(call, args, before, addr, out)
            return out
        return stage

    def __enter__(self):
        from repro_torch.serving import engine, graphs
        by_fn: Dict[str, List[str]] = {}
        for name, c in self.table.items():
            if c.get("fn"):
                by_fn.setdefault(c["fn"], []).append(name)
        for spec, names in by_fn.items():
            owner, attr = _resolve(spec)
            orig = getattr(owner, attr)
            self._patches.append((owner, attr, orig))
            setattr(owner, attr, self._wrap(spec, names, orig))
        for cls in (graphs.DecodeGraph, graphs.OffloadStage):
            orig = cls.__init__
            self._patches.append((cls, "__init__", orig))

            def init(obj, *a, _orig=orig, **kw):
                _orig(obj, *a, **kw)
                self.graphs.append(obj)
            setattr(cls, "__init__", init)
        plane = engine._OffloadPlane
        orig_trace = plane.trace
        self._patches.append((plane, "trace", orig_trace))

        def trace(p, op, layer, kind, step, _orig=orig_trace, **extras):
            if op in ("cache_upd", "cache_stage"):
                self.last_cache_op = op
            return _orig(p, op, layer, kind, step, **extras)
        plane.trace = trace
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for owner, attr, orig in reversed(self._patches):
                setattr(owner, attr, orig)
            self._patches.clear()

    # -- the ops
    def _write_args(self, func) -> List[Tuple[int, str]]:
        w = self._writes.get(func)
        if w is None:
            w = [(i, a.name) for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write]
            self._writes[func] = w
        return w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        sync = name in _SYNC_OPS or _device_to_host(name, func, args,
                                                     kwargs, out)
        if sync:
            frames = _frames()
            if self.active is not None:
                self.active.syncs.append((name, tuple(frames)))
            elif name in _SYNC_OPS:
                self._hot_sync(name, frames)
        if self.active is not None:
            for i, argname in self._write_args(func):
                t = args[i] if i < len(args) else kwargs.get(argname)
                if isinstance(t, torch.Tensor) and t.device.type != "meta":
                    self.active.written.add(t.untyped_storage().data_ptr())
        return out

    def _hot_sync(self, op: str, frames) -> None:
        """The dynamic half of RL001: an implicit sync reached from a hot
        function, with no sync pragma on the way."""
        for path, line, qual, first in frames:
            if self.sites.sanctioned(path, line):
                return
            if self.sites.hot(path, qual, first):
                inner = frames[0]
                self.hot_syncs.append((inner[0], inner[1], qual, op))
                return

    # -- the per-call contract
    def _check_call(self, call: StageCall, args, before, addr, out) -> None:
        name = call.name
        rec = self.records.setdefault(name, StageRecord(name))
        rec.calls += 1
        contract = self.table[name]
        donate = tuple(contract.get("donate", ()))
        if contract.get("space") == "device":
            for op, frames in call.syncs:
                if any(self.sites.sanctioned(p, ln) for p, ln, _, _ in frames):
                    continue
                p, ln = (frames[0][0], frames[0][1]) if frames \
                    else (ENGINE_PATH, 0)
                rec.add(Finding(
                    "RL101", p, ln, name,
                    f"stage `{name}` syncs the host: `{op}` inside the stage "
                    f"(a hidden per-step round trip; illegal under capture)"))
        for pos, arg in enumerate(args):
            mine = before[pos]
            if not mine:
                continue
            wrote = bool(mine & call.written)
            if pos in donate:
                like = _find_like(out, arg) if out is not None else None
                moved = state_addresses(arg) != addr[pos] or (
                    like is not None and like is not arg
                    and state_addresses(like) != addr[pos])
                if moved:
                    rec.add(Finding(
                        "RL102", ENGINE_PATH, 0, name,
                        f"arg {pos} is updated in place by contract but the "
                        f"stage rebinds its tensors (new addresses): a copy, "
                        f"and a captured graph would replay stale memory"))
                elif not wrote:
                    rec.add(Finding(
                        "RL102", ENGINE_PATH, 0, name,
                        f"arg {pos} is updated in place by contract but no "
                        f"op wrote its storage"))
            elif wrote:
                rec.add(Finding(
                    "RL102", ENGINE_PATH, 0, name,
                    f"stage writes arg {pos} in place but its contract does "
                    f"not name it (donate={donate})"))
        # RL104: fresh outputs shaped like large inputs it does not update
        exempt = set(donate) | set(contract.get("copy_ok", ()))
        ins = set().union(*before) if before else set()
        fresh = {(tuple(t.shape), t.dtype) for t in _leaves(out)
                 if t.device.type != "meta"
                 and t.untyped_storage().data_ptr() not in ins}
        for pos, arg in enumerate(args):
            if pos in exempt:
                continue
            hit = next((t for t in _leaves(arg)
                        if t.numel() * t.element_size() >= _RL104_MIN_BYTES
                        and (tuple(t.shape), t.dtype) in fresh), None)
            if hit is not None:
                rec.add(Finding(
                    "RL104", ENGINE_PATH, 0, name,
                    f"arg {pos} has a {str(hit.dtype).replace('torch.', '')}"
                    f"{tuple(hit.shape)} tensor it does not update in place "
                    f"and the stage returns a fresh one of that shape — "
                    f"likely an update paying a copy", severity="advice"))
                break


def _device_to_host(name, func, args, kwargs, out) -> bool:
    """A copy from the card into host memory (``.cpu()``, ``.to("cpu")``,
    a host tensor's ``copy_`` from a device one)."""
    if name == "aten._to_copy":
        return isinstance(out, torch.Tensor) and out.device.type == "cpu" \
            and isinstance(args[0], torch.Tensor) \
            and args[0].device.type == "cuda"
    if name == "aten.copy_":
        return len(args) > 1 and isinstance(args[0], torch.Tensor) \
            and args[0].device.type == "cpu" \
            and isinstance(args[1], torch.Tensor) \
            and args[1].device.type == "cuda"
    return False


# ----------------------------------------------------------------- serve runs
# the contract stages each serve mode exercises (chunk_pe, the vlm chunk,
# runs in neither: the tiny model has no patches)
_OFFLOAD_STAGES = ("argmax_ids", "merge_tokens", "graft", "chunk", "fin",
                   "embed_tokens", "rank_fn", "attend_fn", "unembed_logits",
                   "cache_upd", "cache_stage", "offload_flush")
_BLOCKING_STAGES = ("graft", "categorical_ids", "merge_tokens", "prefill",
                    "decode", "flush")


@dataclass
class RunReport:
    label: str
    recorder: StageRecorder
    exercised: Tuple[str, ...]
    device: str
    seconds: float = 0.0


def _serve_run(label, cfg, params, *, lengths, max_new, exercised, device,
               batch_size=2, **engine_kw) -> RunReport:
    import time
    from repro_torch.serving.engine import ServeEngine
    t0 = time.perf_counter()
    rec = StageRecorder()
    with rec:
        engine = ServeEngine(cfg, params, gen_headroom=256, device=device,
                             **engine_kw)
        engine.serve(_requests(lengths, max_new, min(cfg.vocab - 1, 250)),
                     batch_size=batch_size, seed=0)
    return RunReport(label, rec, tuple(exercised), str(device),
                     time.perf_counter() - t0)


def budget_findings(run: RunReport,
                    stage_table: Optional[Dict[str, Dict]] = None
                    ) -> List[Finding]:
    """RL103 over one run: graphs built and captured per captured stage,
    calls per eager stage, against the run's plan."""
    if stage_table is None:
        from repro_torch.serving.engine import SERVE_STAGES
        stage_table = SERVE_STAGES
    out: List[Finding] = []
    on_card = torch.device(run.device).type == "cuda"
    for name, c in sorted(stage_table.items()):
        budget = c["budget"]
        if budget == "host":
            continue
        planned = name in run.exercised
        rec = run.recorder.records.get(name)
        calls = rec.calls if rec else 0
        if budget == "per_geometry":
            owners = [g for g in run.recorder.graphs
                      if name in getattr(g, "STAGES", ())]
            built = len(owners)
            captured = sum(g.captures for g in owners)
            want_b = 1 if planned else 0
            want_c = want_b if on_card else 0
            if built != want_b:
                out.append(Finding(
                    "RL103", ENGINE_PATH, 0, name,
                    f"stage's graph built {built}x over the {run.label} run, "
                    f"budget is {want_b}"))
            if captured != want_c:
                out.append(Finding(
                    "RL103", ENGINE_PATH, 0, name,
                    f"stage captured {captured}x over the {run.label} run, "
                    f"budget is {want_c}"))
            if planned and owners and not any(
                    run.recorder.records.get(n) for n in owners[0].STAGES):
                out.append(Finding(
                    "RL103", ENGINE_PATH, 0, name,
                    f"no stage of its graph ran over the {run.label} run"))
        elif planned and calls == 0:
            out.append(Finding(
                "RL103", ENGINE_PATH, 0, name,
                f"stage never ran over the {run.label} run — bypassed, or "
                f"its `fn` names a callable the engine no longer calls"))
        elif not planned and calls:
            out.append(Finding(
                "RL103", ENGINE_PATH, 0, name,
                f"stage ran {calls}x over the {run.label} run, whose plan "
                f"does not exercise it"))
    return out


def captures_per_stage(runs: Sequence[RunReport]) -> Dict[str, int]:
    """stage -> CUDA graph captures over the runs (per_geometry stages)."""
    out: Counter = Counter()
    for run in runs:
        for g in run.recorder.graphs:
            for name in getattr(g, "STAGES", ()):
                out[name] += g.captures
    return dict(out)


def run_contract_checks(verbose=None, *, cfg=None, params=None,
                        device="cpu", lengths: Sequence[int] = LENGTHS,
                        max_new: int = MAX_NEW, attn_impl=None,
                        prefill_chunk: int = 256,
                        unplanned: Sequence[str] = (),
                        reports: Optional[list] = None) -> List[Finding]:
    """The full trace-time gate: a chunked + offload serve and a blocking +
    direct serve (the tiny config on the CPU by default; ``cfg``/``params``
    /``device`` run it at any size), then every SERVE_STAGES contract held
    to what was recorded. The offload run doubles as the retrosched
    (RL301-RL305) schedule recording. ``unplanned``: stages the runs are
    too short to reach (the flushes of a few decode steps at full width).
    ``reports``: a list that receives the two ``RunReport``s."""
    from repro_torch.analysis.schedule_check import schedule_findings
    from repro_torch.analysis.schedule_model import ScheduleRecorder
    log = verbose or (lambda *_: None)
    if cfg is None:
        cfg, params = _tiny_setup(device)
    kw = dict(lengths=lengths, max_new=max_new, device=device,
              attn_impl=attn_impl, prefill_chunk=prefill_chunk)
    log("retrolint: serve run 1/2 (chunked admission, host-offload decode)")
    plan = lambda stages: tuple(s for s in stages if s not in unplanned)
    with ScheduleRecorder() as sched:
        run_a = _serve_run("chunked+offload", cfg, params,
                           exercised=plan(_OFFLOAD_STAGES),
                           admission="chunked", offload=True,
                           temperature=0.0, **kw)
    log("retrolint: serve run 2/2 (blocking admission, direct decode)")
    run_b = _serve_run("blocking+direct", cfg, params,
                       exercised=plan(_BLOCKING_STAGES),
                       admission="blocking", offload=False, temperature=0.7,
                       **kw)
    if reports is not None:
        reports.extend([run_a, run_b])
    findings: List[Finding] = []
    log("retrolint: retrosched happens-before check over the offload "
        "schedule")
    findings += schedule_findings(sched.trace)
    seen = set()
    for run in (run_a, run_b):
        findings += budget_findings(run)
        for rec in run.recorder.records.values():
            for f in rec.findings:
                key = (f.rule, f.path, f.line, f.qualname, f.message)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
        for path, line, qual, op in run.recorder.hot_syncs:
            key = ("RL001", path, line)
            if key not in seen:
                seen.add(key)
                findings.append(Finding(
                    "RL001", path, line, qual,
                    f"implicit host sync `{op}` (bool/int/float of a "
                    f"tensor, or .item()) reached from the hot path "
                    f"`{qual}` with no `# retrolint: sync(<reason>)` pragma "
                    f"on the way"))
    return findings
