"""Kernel analysis (RL201-RL203, and the CUDA halves of RL401 and RL406)
over the port's CUDA sources and their Python launchers.

Counterpart of ``repro/analysis/pallas_check.py``, over
``src/repro_torch/kernels/*/csrc/*.cu{,h}`` and ``kernels/*/ops.py``:

* RL201 — a bounded model check of the shared-memory rings. Device helpers
  are classified by the PTX they issue (mbarrier waits, arrives and
  expect_tx, bulk copies, cp.async and its mbarrier arrive, bulk stores and
  their groups); each kernel's roles (a producer branch that returns, the
  rest the consumer) are read as event sequences over their trip loop, which
  is unrolled for a few trips with the slot and parity expressions
  evaluated. The checker then rejects a read of a slot whose fill was not
  awaited (or awaited with the wrong parity), a refill before the slot's
  empty wait, a copy its slot's barrier does not track, a slot released
  before its last read, and a copy still in flight at exit;
* RL202 — the launch-geometry planners in ``ops.py`` are pure functions of
  shapes and ints: no host sync and no Python value or branch taken from a
  tensor (a captured graph bakes the geometry in);
* RL203 — each kernel's static ``__shared__`` bytes plus the dynamic bytes
  its launch site asks for, every constant parsed from the sources and the
  rest resolved from the geometry, against the per-block budget; a dynamic
  size past 48 KiB must also be opted into with ``cudaFuncSetAttribute``;
* RL401 (CUDA) — no bf16/half transcendental intrinsic in device code;
* RL406 — the cast-site inventory: every call of ``Vec<T>::lds`` where T can
  be a 16-bit storage type (a specialization widens it), and every direct
  conversion intrinsic in a kernel body.
"""
from __future__ import annotations

import ast
import glob
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import csource as C
from repro_torch.analysis.findings import Finding, Pragmas

# geometry symbols the sources leave open (override with --geometry): the
# largest head dim and group size the attention kernels take, their most
# tiles per split, a long context's split count, f32 storage (the wider
# dtype), the k-means step's clusters, and the gather's chunk and block
GEOMETRY_DEFAULTS: Dict[str, int] = {
    "hd": 256, "G": 8, "tps": 8, "splits": 1024, "kv_bytes": 4,
    "k": 1024, "chunk_bytes": 8192, "block_bytes": 16384,
}
DEFAULT_SMEM_BUDGET = 232448            # H100: 227 KiB per block
OPT_IN_BYTES = 48 * 1024                # dynamic size needing the attribute
_MODEL_TRIPS = 6                        # unrolled trips of a ring

_WIDEN = ("__bfloat162float", "__bfloat1622float2", "__half2float",
          "__half22float2", "__low2float", "__high2float")
_NARROW = ("__float2bfloat16", "__floats2bfloat162_rn", "__float2half",
           "__float22bfloat162_rn", "__float2half_rn")
_TRANSCENDENTAL_16 = re.compile(
    r"\b(h2?(?:exp|exp2|exp10|log|log2|log10|tanh|rcp|rsqrt|sqrt))\s*\(")


def kernel_dirs(root: str) -> List[str]:
    return sorted(glob.glob(os.path.join(root, "src", "repro_torch",
                                         "kernels", "*", "csrc")))


# ============================================================== RL201 rings
# PTX -> event kind, first match wins
_PTX_KINDS = (
    ("mbarrier.try_wait", "wait"),
    ("mbarrier.arrive.expect_tx", "expect"),
    ("cp.async.mbarrier.arrive", "cp_arrive"),
    ("mbarrier.init", "init"),
    ("mbarrier.arrive", "arrive"),
    ("cp.async.bulk.shared", "bulk_fill"),
    ("cp.async.bulk.global.shared", "bulk_store"),
    ("cp.async.bulk.commit_group", "store_commit"),
    ("cp.async.bulk.wait_group.read", "store_wait"),
    ("cp.async.bulk.wait_group", "store_wait"),
    ("cp.async.cg.shared.global", "cp_fill"),
    ("cp.async.ca.shared.global", "cp_fill"),
)


def _ptx_kind(text: str) -> Optional[str]:
    for needle, kind in _PTX_KINDS:
        if needle in text:
            return kind
    return None


@dataclass
class _Event:
    kind: str                   # wait/expect/arrive/cp_arrive/bulk_fill/...
    line: int
    bar: Optional[Tuple[str, Optional[List[C.Tok]]]] = None
    parity: Optional[List[C.Tok]] = None


def _split_args(toks: List[C.Tok]) -> List[List[C.Tok]]:
    args, cur, depth = [], [], 0
    for t in toks:
        if t.text in "([{":
            depth += 1
        elif t.text in ")]}":
            depth -= 1
        if t.text == "," and depth == 0:
            args.append(cur)
            cur = []
        else:
            cur.append(t)
    if cur:
        args.append(cur)
    return args


def _calls(toks: List[C.Tok]):
    """(name, [arg tokens], line) of every call in a statement."""
    for k, t in enumerate(toks[:-1]):
        if toks[k + 1].text == "(" and re.match(r"[A-Za-z_]\w*$", t.text):
            j = C._match(toks, k + 1, "(", ")")
            yield t.text, _split_args(toks[k + 2:j]), t.line


def _barrier(arg: List[C.Tok], locals_: Dict[str, List[C.Tok]]):
    """``&full[slot]`` / ``smem_u32(&bar)`` / a local holding one ->
    (base, index tokens or None)."""
    texts = [t.text for t in arg]
    if len(texts) == 1 and texts[0] in locals_:
        return _barrier(locals_[texts[0]], locals_)
    if "&" in texts:
        k = texts.index("&")
        base = texts[k + 1]
        if k + 2 < len(arg) and texts[k + 2] == "[":
            e = C._match(arg, k + 2, "[", "]")
            return base, arg[k + 3:e]
        return base, None
    return None


class _Helpers:
    """Device helpers classified by the PTX in their bodies."""

    def __init__(self, unit: C.Unit):
        self.kind: Dict[str, str] = {}
        for f in unit.funcs:
            if f.kind != "device":
                continue
            kinds = {_ptx_kind(t.text) for t in f.body
                     if t.text.startswith('"')} - {None}
            if len(kinds) == 1:
                self.kind[f.name] = kinds.pop()


def _events(stmt: C.Stmt, helpers: _Helpers,
            locals_: Dict[str, List[C.Tok]]) -> List[_Event]:
    out = []
    toks = stmt.toks
    if toks and toks[0].text == "asm":
        strings = [t.text for t in toks if t.text.startswith('"')]
        kind = _ptx_kind(" ".join(strings))
        if kind is None:
            return out
        ev = _Event(kind, stmt.line)
        # the operands: the group after each constraint string, "r"(...)
        operands = [toks[k + 2:C._match(toks, k + 1, "(", ")")]
                    for k, t in enumerate(toks[:-1])
                    if t.text.startswith('"') and toks[k + 1].text == "("]
        for a in operands:
            b = _barrier(a, locals_)
            if b is not None and kind in ("wait", "expect", "arrive",
                                          "cp_arrive", "bulk_fill", "init"):
                ev.bar = b
        if kind == "wait":
            m = re.search(r"parity[^\]]*\],\s*(\d+)", " ".join(strings))
            if m:
                ev.parity = [C.Tok(m.group(1), stmt.line)]
        out.append(ev)
        return out
    for name, args, line in _calls(toks):
        kind = helpers.kind.get(name)
        if kind is None or not args:
            continue
        ev = _Event(kind, line)
        if kind in ("wait", "expect", "arrive", "cp_arrive", "init"):
            ev.bar = _barrier(args[0], locals_)
        if kind == "wait" and len(args) > 1:
            ev.parity = args[1]
        if kind == "bulk_fill":
            ev.bar = _barrier(args[-1], locals_)
        out.append(ev)
    return out


def _assign(stmt: C.Stmt) -> Optional[Tuple[str, List[C.Tok]]]:
    """``[const] T name = expr`` (first declarator) -> (name, expr)."""
    texts = [t.text for t in stmt.toks]
    if "=" not in texts or texts[0] in ("asm", "return"):
        return None
    k = texts.index("=")
    if k == 0 or not re.match(r"[A-Za-z_]\w*$", texts[k - 1]) \
            or any(x in ("(", "[") for x in texts[:k]):
        return None
    rhs = stmt.toks[k + 1:]
    depth, end = 0, len(rhs)
    for q, t in enumerate(rhs):             # `a = x, b = y`: first only
        depth += (t.text in "([{") - (t.text in ")]}")
        if t.text == "," and depth == 0:
            end = q
            break
    return texts[k - 1], rhs[:end]


def _declared_pairs(stmt: C.Stmt) -> List[Tuple[str, List[C.Tok]]]:
    """Every ``name = expr`` declarator of a statement."""
    first = _assign(stmt)
    if first is None:
        return []
    out, toks = [first], stmt.toks
    texts = [t.text for t in toks]
    depth = 0
    for q, t in enumerate(texts):
        depth += (t in "([{") - (t in ")]}")
        if t == "," and depth == 0 and q + 2 < len(texts) \
                and texts[q + 2] == "=":
            rest = C.Stmt("simple", stmt.line, toks=toks[q + 1:])
            pair = _assign(rest)
            if pair:
                out.append(pair)
    return out


class _Role:
    """One thread role of a kernel: its statements before the trip loop,
    the loop (variable, bound, body) and the statements after it."""

    def __init__(self, stmts: List[C.Stmt]):
        self.pre: List[C.Stmt] = []
        self.post: List[C.Stmt] = []
        self.loop: Optional[C.Stmt] = None
        for st in stmts:
            if self.loop is None and st.kind == "for" and _has_barrier_use(
                    st):
                self.loop = st
            elif self.loop is None:
                self.pre.append(st)
            else:
                self.post.append(st)
        self.var = self.bound = None
        if self.loop is not None:
            head = [t.text for t in self.loop.head]
            semi = [i for i, t in enumerate(head) if t == ";"]
            init = head[:semi[0]]
            self.var = init[init.index("=") - 1] if "=" in init else None
            self.bound = " ".join(head[semi[0] + 1:semi[1]])


def _has_barrier_use(st: C.Stmt) -> bool:
    return any("&" in s.text and "[" in s.text for s in C.walk([st]))


def _roles(kernel: C.Func) -> List[_Role]:
    """A top-level ``if (...) { ...; return; }`` holding copies is the
    producer; the statements after it are the consumer."""
    stmts = kernel.stmts
    for k, st in enumerate(stmts):
        if st.kind == "if" and st.body and any(
                s.toks and s.toks[0].text == "return"
                for s in C.walk(st.body)) and _has_barrier_use(st):
            body = st.body[0].body if st.body[0].kind == "block" \
                else st.body
            return [_Role(stmts[:k] + body), _Role(stmts[:k] + stmts[k + 1:])]
    return [_Role(stmts)]


class _RingModel:
    """Bounded check of one kernel's rings."""

    def __init__(self, kernel: C.Func, helpers: _Helpers,
                 consts: Dict[str, object], pragmas: Pragmas):
        self.k, self.helpers, self.pragmas = kernel, helpers, pragmas
        self.consts = consts
        self.findings: List[Finding] = []
        # the dynamic shared-memory arrays: every ring pointer derives
        # from one
        self.smem: Set[str] = set()
        for st in C.walk(kernel.stmts):
            texts = [t.text for t in st.toks]
            if texts[:2] == ["extern", "__shared__"] and "[" in texts:
                self.smem.add(texts[texts.index("[") - 1])

    def _flag(self, line: int, msg: str) -> None:
        if not self.pragmas.ignores(line, "RL201"):
            self.findings.append(Finding("RL201", self.k.path, line,
                                         self.k.name, msg))

    def _eval(self, toks, env) -> Optional[int]:
        if toks is None:
            return None
        try:
            return int(C.Evaluator(dict(env)).eval(toks))
        except (C.Unresolved, ValueError, ZeroDivisionError, TypeError):
            return None

    def run(self) -> List[Finding]:
        roles = _roles(self.k)
        traces = [self._trace(r) for r in roles]
        if not any(e[1].kind in ("bulk_fill", "cp_fill")
                   for t in traces for e in t["events"]):
            return []
        full = {e[1].bar[0] for t in traces for e in t["events"]
                if e[1].kind in ("bulk_fill", "cp_arrive", "expect")
                and e[1].bar}
        ring = len(roles) > 1
        if ring and len({str(r.bound) for r in roles
                         if r.loop is not None}) > 1:
            self._flag(self.k.line,
                       f"producer and consumer walk different trip counts "
                       f"({' vs '.join(str(r.bound) for r in roles)}): a "
                       f"fill is still in flight at exit or a wait never "
                       f"completes")
        for t in traces:
            self._check_role(t, full, ring)
        return self.findings

    def _trace(self, role: _Role) -> dict:
        """The role's events in order: [(trip, event, env)], trip -1
        before the loop, ``_MODEL_TRIPS`` after it."""
        env0 = dict(self.consts)
        locals_: Dict[str, List[C.Tok]] = {}
        derived: Set[str] = set(self.smem)
        events = []

        def visit(stmts, env, trip):
            for st in C.walk(stmts):
                pairs = _declared_pairs(st)
                for name, rhs in pairs:
                    locals_[name] = rhs
                    v = self._eval(rhs, env)
                    if v is not None:
                        env[name] = v
                    if {t.text for t in rhs} & derived:
                        derived.add(name)
                evs = _events(st, self.helpers, locals_)
                for ev in evs:
                    events.append((trip, ev, env.copy()))
                if st.toks and st.toks[0].text == "extern":
                    continue
                used = {t.text for t in st.toks} & derived
                if used and not evs and not (
                        pairs and not _subscripts(st, derived)):
                    events.append((trip, _Event("read", st.line), env.copy()))

        env = dict(env0)
        visit(role.pre, env, -1)
        if role.loop is not None:
            for trip in range(_MODEL_TRIPS):
                env_t = dict(env)
                env_t[role.var] = trip
                visit(role.loop.body, env_t, trip)
        visit(role.post, dict(env), _MODEL_TRIPS)
        return dict(role=role, events=events)

    def _slot(self, ev: _Event, env) -> int:
        if ev.bar is not None and ev.bar[1] is not None:
            v = self._eval(ev.bar[1], env)
            return -1 if v is None else v
        return 0

    def _check_role(self, t: dict, full: Set[str], ring: bool) -> None:
        role: _Role = t["role"]
        uses: Dict[Tuple[str, int], int] = {}
        by_trip: Dict[int, List[Tuple[_Event, dict]]] = {}
        for trip, ev, env in t["events"]:
            by_trip.setdefault(trip, []).append((ev, env))
        slot_var = None
        for trip, ev, _ in t["events"]:
            if trip >= 0 and ev.kind != "init" and ev.bar is not None \
                    and ev.bar[1] is not None:
                slot_var = ev.bar[1]
                break
        inflight_store = None
        for trip in sorted(by_trip):
            evs = by_trip[trip]
            env = evs[0][1]
            slot = self._eval(slot_var, env) if slot_var else 0
            slot = 0 if slot is None else slot
            full_waited = empty_waited = released = False
            reads_after_release = None
            cp_pending = None
            expected = False
            for ev, env in evs:
                kind = ev.kind
                base = ev.bar[0] if ev.bar else None
                if kind == "wait":
                    s = self._slot(ev, env)
                    key = (base, s)
                    u = uses.get(key, 0)
                    par = self._eval(ev.parity, env)
                    if base in full:
                        want = u & 1
                        full_waited = full_waited or s == slot
                    else:
                        want = (u - 1) & 1
                        empty_waited = empty_waited or s == slot
                    if par is not None and par != want:
                        self._flag(ev.line,
                                   f"wait on `{base}[{s}]` with parity {par} "
                                   f"at trip {trip}, use {u} of the slot: "
                                   f"the phase it must see has parity {want} "
                                   f"(the wait passes on a stale phase)")
                    uses[key] = u + 1
                elif kind == "expect":
                    expected = True
                elif kind in ("bulk_fill", "cp_fill"):
                    if ring and not empty_waited and trip >= 0:
                        self._flag(ev.line,
                                   f"slot {slot} refilled at trip {trip} "
                                   f"before the wait on its empty barrier: "
                                   f"the consumers may still be reading it")
                    if kind == "bulk_fill":
                        s = self._slot(ev, env)
                        if base not in full or s != slot:
                            self._flag(ev.line,
                                       f"bulk copy into slot {slot} completes "
                                       f"on `{base}[{s}]`: the wait on "
                                       f"slot {slot} does not cover it")
                        if not expected:
                            self._flag(ev.line,
                                       "bulk copy issued before its "
                                       "barrier's expect_tx: the phase can "
                                       "complete before the bytes land")
                    else:
                        cp_pending = ev
                elif kind == "cp_arrive":
                    if cp_pending is not None and self._slot(ev, env) == slot:
                        cp_pending = None
                elif kind == "arrive":
                    released = True
                elif kind == "read":
                    if not full_waited:
                        self._flag(ev.line,
                                   f"slot {slot} read at trip {trip} before "
                                   f"its fill was awaited — wait-before-reuse "
                                   f"violated")
                    if released and reads_after_release is None:
                        reads_after_release = ev
                elif kind == "bulk_store":
                    if not full_waited:
                        self._flag(ev.line,
                                   "bulk store reads shared memory before "
                                   "the fill's barrier was awaited")
                    inflight_store = ev
                elif kind == "store_wait":
                    inflight_store = None
            if cp_pending is not None:
                self._flag(cp_pending.line,
                           f"cp.async copies into slot {slot} at trip {trip} "
                           f"are not tracked by its full barrier (no "
                           f"cp.async.mbarrier.arrive on it): the consumers' "
                           f"wait does not cover them")
            if reads_after_release is not None:
                self._flag(reads_after_release.line,
                           f"slot {slot} read at trip {trip} after its empty "
                           f"barrier was arrived on: the producer may "
                           f"already be refilling it")
            if ring and role.loop is not None and 0 <= trip < _MODEL_TRIPS \
                    and full_waited and not released:
                self._flag(role.loop.line,
                           f"slot {slot} is never released (no arrive on its "
                           f"empty barrier at trip {trip}): the producer's "
                           f"next wait on it never completes")
        if inflight_store is not None:
            self._flag(inflight_store.line,
                       "bulk store still in flight at exit: no "
                       "cp.async.bulk.wait_group.read before the block "
                       "leaves, so shared memory may be reused while the "
                       "copy reads it")


def _subscripts(st: C.Stmt, names: Set[str]) -> bool:
    toks = st.toks
    return any(t.text in names and k + 1 < len(toks)
               and toks[k + 1].text == "[" for k, t in enumerate(toks))


def check_rings(unit: C.Unit, consts: Dict[str, object]) -> List[Finding]:
    helpers = _Helpers(unit)
    findings: List[Finding] = []
    seen = set()
    for f in unit.funcs:
        if f.kind != "global":
            continue
        pragmas = Pragmas.scan(unit.sources[f.path])
        for x in _RingModel(f, helpers, consts, pragmas).run():
            # the unrolled model revisits a site once per trip
            key = (x.line, re.sub(r"\d+", "#", x.message))
            if key not in seen:
                seen.add(key)
                findings.append(x)
    return findings


# =================================================== RL202 geometry purity
# Launch-geometry planners and launchers, per ops.py, with the parameters
# that hold tensors (RL202's taint seeds)
_WAVE_ARGS = ("qg", "sink_k", "sink_v", "local_k", "local_v", "local_pos",
              "k_store", "v_store", "pos_store", "idx_r", "live", "rowb",
              "est_logit", "cs_e", "vs_e")
_MERGE_ARGS = ("qg", "k_exec", "v_exec", "valid", "est_logit", "cs_e", "vs_e")
PLANNERS: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "src/repro_torch/kernels/wave_attention/ops.py": {
        "split_plan": (), "_grid": (), "_workspace": (),
        "paged_grid": ("args",), "merge_grid": _MERGE_ARGS,
        "paged_wave_attention": _WAVE_ARGS,
        "wave_attention_merge": _MERGE_ARGS,
    },
    "src/repro_torch/kernels/gather/ops.py": {
        "block_gather_op": ("idx", "k_store", "v_store"),
    },
    "src/repro_torch/kernels/kmeans/ops.py": {
        "_round_up": (), "kmeans_step": ("x", "cent"),
    },
}
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "type",
                 "cuda_stream"}
_STATIC_METHODS = {"dim", "size", "numel", "element_size", "data_ptr",
                   "is_contiguous", "stride"}


def _chain(node: ast.AST) -> Tuple[str, ...]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


class _Purity:
    def __init__(self, seeds: Sequence[str]):
        self.tainted: Set[str] = set(seeds)

    def tainted_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            return node.attr not in _STATIC_ATTRS \
                and self.tainted_expr(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.tainted_expr(node.value)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _STATIC_METHODS:
                return False
            if _chain(node.func)[-1:] in (("len",), ("isinstance",)):
                return False
            if isinstance(node.func, ast.Attribute):
                return self.tainted_expr(node.func.value) or any(
                    self.tainted_expr(a) for a in node.args)
            return False            # a launcher's or helper's return value
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare,
                             ast.UnaryOp, ast.IfExp, ast.Tuple, ast.List)):
            return any(self.tainted_expr(c) for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr))
        if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
            return self.tainted_expr(node.elt)
        return False


def check_planners(tree: ast.Module, path: str, pragmas: Pragmas,
                   planners: Dict[str, Tuple[str, ...]]) -> List[Finding]:
    findings: List[Finding] = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in planners:
            continue
        p = _Purity(planners[fn.name])
        for node in ast.walk(fn):           # taint through assignments
            if isinstance(node, (ast.Assign, ast.For)):
                value = node.value if isinstance(node, ast.Assign) \
                    else node.iter
                if p.tainted_expr(value):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                p.tainted.add(n.id)

        def flag(node, why):
            if not pragmas.ignores(node.lineno, "RL202"):
                findings.append(Finding(
                    "RL202", path, node.lineno, fn.name,
                    f"launch geometry reads a tensor value: {why} — a "
                    f"captured graph would replay the capture step's "
                    f"geometry"))

        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                ch = _chain(node.func)
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _SYNC_METHODS:
                    flag(node, f"`.{node.func.attr}()`")
                elif ch in (("int",), ("float",), ("bool",)) and node.args \
                        and p.tainted_expr(node.args[0]):
                    flag(node, f"`{ch[0]}()` of a tensor")
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and p.tainted_expr(node.test):
                flag(node, "a branch on a tensor")
    return findings


# ====================================================== RL203 shared memory
def _align(size: int) -> int:
    return min(size, 16) if size & (size - 1) == 0 else 4


class _Layout:
    """Sizes of types and structs, template parameters from the env."""

    def __init__(self, unit: C.Unit, env: Dict[str, object]):
        self.unit, self.env = unit, env

    def type_size(self, typ: str) -> Tuple[int, int]:
        """(bytes, alignment) of a type name as the sources spell it."""
        base = typ.split("<", 1)[0].strip()
        if typ.endswith("*"):
            return 8, 8
        if base in C.TYPE_SIZES:
            s = C.TYPE_SIZES[base]
            return s, _align(s)
        if base in self.env:                    # a template type parameter
            s = int(C.Evaluator(self.env).value(base))
            return s, _align(s)
        st = self.unit.structs.get(typ.replace(" ", "")) \
            or self.unit.structs.get(base)
        if st is None:
            raise C.Unresolved(typ)
        off, align = 0, 1
        for ftyp, decls in st.fields:
            s, a = self.type_size(ftyp)
            for dims in decls:
                n = 1
                for d in dims:
                    n *= int(C.Evaluator(dict(self.env)).eval(d))
                off = -(-off // a) * a + s * n
                align = max(align, a)
        return -(-off // align) * align, align


def _static_smem(kernel: C.Func, layout: _Layout) -> int:
    total = 0
    for st in C.walk(kernel.stmts):
        texts = [t.text for t in st.toks]
        if "__shared__" not in texts or "extern" in texts:
            continue
        toks = [t for t in st.toks if t.text not in (
            "__shared__", "static", "const", "volatile")]
        while toks and toks[0].text == "__align__":
            toks = toks[C._match(toks, 1, "(", ")") + 1:]
        decl = C.Stmt("simple", st.line, toks=toks)
        for typ, dims_list in C._fields(decl.toks + [C.Tok(";", 0)]):
            size, _ = layout.type_size(typ)
            for dims in dims_list:
                n = 1
                for d in dims:
                    n *= int(C.Evaluator(dict(layout.env)).eval(d))
                total += size * n
    return total


def _launch_sites(unit: C.Unit):
    """(host function, kernel name, smem arg tokens, line) per launch."""
    for f in unit.funcs:
        if f.kind == "global":
            continue
        toks = f.body
        for k, t in enumerate(toks):
            if t.text != "<<<":
                continue
            j = k - 1
            if toks[j].text == ">":
                depth = 0
                while j >= 0:
                    depth += (toks[j].text == ">") - (toks[j].text == "<")
                    if depth == 0:
                        break
                    j -= 1
                j -= 1
            end = next(q for q in range(k, len(toks))
                       if toks[q].text == ">>>")
            args = _split_args(toks[k + 1:end])
            smem = args[2] if len(args) > 2 else [C.Tok("0", t.line)]
            yield f, toks[j].text, smem, t.line


def _locals(f: C.Func) -> Dict[str, List[C.Tok]]:
    out: Dict[str, List[C.Tok]] = {}
    for st in C.walk(f.stmts):
        for name, rhs in _declared_pairs(st):
            out.setdefault(name, rhs)
    return out


def _opts_in(f: C.Func, kernel: str, unit: C.Unit) -> bool:
    """The host function raises ``kernel``'s dynamic limit: it calls
    cudaFuncSetAttribute on it, or a helper that does."""
    setters = {"cudaFuncSetAttribute"} | {
        g.name for g in unit.funcs
        if "cudaFuncAttributeMaxDynamicSharedMemorySize" in g.text}
    for name, args, _ in _calls(f.body):
        if name in setters and args and args[0] and \
                args[0][0].text == kernel:
            return True
    return False


def check_smem(unit: C.Unit, consts: Dict[str, object],
               geometry: Dict[str, int], budget: int) -> List[Finding]:
    findings: List[Finding] = []
    env = dict(GEOMETRY_DEFAULTS)
    env.update(geometry)
    env.update(consts)
    env["KV"] = env["kv_bytes"]
    env["T"] = env["kv_bytes"]
    layout = _Layout(unit, env)
    dynamic: Dict[str, Tuple[int, C.Func, bool]] = {}
    for host, kname, smem, _line in _launch_sites(unit):
        ev = C.Evaluator({**env, **_locals(host)})
        try:
            dyn = int(ev.eval(smem))
        except (C.Unresolved, ZeroDivisionError, TypeError) as e:
            findings.append(Finding(
                "RL203", host.path, _line, kname,
                f"dynamic shared memory of the launch could not be "
                f"evaluated ({e}): add the symbol to --geometry"))
            continue
        prev = dynamic.get(kname)
        if prev is None or dyn > prev[0]:
            dynamic[kname] = (dyn, host, _opts_in(host, kname, unit))
    for f in unit.funcs:
        if f.kind != "global":
            continue
        pragmas = Pragmas.scan(unit.sources[f.path])
        if pragmas.ignores(f.line, "RL203"):
            continue
        static = _static_smem(f, layout)
        dyn, host, opted = dynamic.get(f.name, (0, None, False))
        total = static + dyn
        if total > budget:
            findings.append(Finding(
                "RL203", f.path, f.line, f.name,
                f"shared memory {total} bytes ({static} static + {dyn} "
                f"dynamic) exceeds the {budget}-byte budget at the checked "
                f"geometry"))
        if dyn > OPT_IN_BYTES and not opted:
            findings.append(Finding(
                "RL203", f.path, f.line, f.name,
                f"{dyn} bytes of dynamic shared memory without raising the "
                f"kernel's limit (cudaFuncSetAttribute "
                f"MaxDynamicSharedMemorySize): the launch fails past "
                f"{OPT_IN_BYTES}"))
    return findings


# ================================================= RL401 (CUDA) and RL406
def check_intrinsics(unit: C.Unit) -> List[Finding]:
    findings: List[Finding] = []
    for f in unit.funcs:
        if f.kind == "host":
            continue
        pragmas = Pragmas.scan(unit.sources[f.path])
        for k, t in enumerate(f.body):
            if k + 1 < len(f.body) and f.body[k + 1].text == "(" \
                    and _TRANSCENDENTAL_16.match(t.text + "(") \
                    and not pragmas.ignores(t.line, "RL401"):
                findings.append(Finding(
                    "RL401", f.path, t.line, f.qualname,
                    f"`{t.text}` computes a transcendental in 16 bits — the "
                    f"softmax/LSE chain must run in float32"))
    return findings


def cast_inventory(unit: C.Unit) -> List[Finding]:
    """RL406 advice: the per-block widenings of the kernels."""
    widening: Dict[str, Tuple[str, str, int]] = {}     # Vec<X> -> intrinsic
    for f in unit.funcs:
        m = re.match(r"(\w+)<(\w+)>::(\w+)$", f.qualname)
        if m and m.group(2) in C.SIXTEEN_BIT:
            hit = next((t for t in f.body if t.text in _WIDEN), None)
            if hit is not None:
                widening[f"{m.group(1)}::{m.group(3)}"] = (
                    m.group(2), hit.text, hit.line)
    out: List[Finding] = []
    for f in unit.funcs:
        if f.kind == "host":
            continue
        toks = f.body
        for k, t in enumerate(toks):
            # Vec < T > :: lds (
            if k + 5 < len(toks) and toks[k + 1].text == "<" \
                    and toks[k + 3].text == ">" and toks[k + 4].text == "::":
                key = f"{t.text}::{toks[k + 5].text}"
                param = toks[k + 2].text
                if key in widening and (param in f.template or param in
                                        C.SIXTEEN_BIT or param in
                                        _struct_params(unit, f)):
                    src, intr, at = widening[key]
                    j = C._match(toks, k + 6, "(", ")")
                    arg = C.join(_split_args(toks[k + 7:j])[0])
                    arg = re.sub(r"([.(])\s+", r"\1",
                                 re.sub(r"\s+([.,()])", r"\1", arg))
                    out.append(Finding(
                        "RL406", f.path, t.line, f.qualname,
                        f"cast site: {src} -> float32 — widen-to-accum "
                        f"(dequant hook): {t.text}<{param}>::"
                        f"{toks[k + 5].text} ({intr}, {f.path}:{at}) "
                        f"widens one 16-byte chunk of the row at `{arg}` of "
                        f"a TILE x hd shared-memory tile",
                        severity="advice"))
            if f.kind == "global" and t.text in _WIDEN + _NARROW:
                out.append(Finding(
                    "RL406", f.path, t.line, f.qualname,
                    f"cast site: `{t.text}` in the kernel body — "
                    f"{'widen-to-accum' if t.text in _WIDEN else 'output downcast'}",
                    severity="advice"))
    return out


def _struct_params(unit: C.Unit, f: C.Func) -> List[str]:
    owner = f.qualname.split("::")[0] if "::" in f.qualname else None
    st = unit.structs.get(owner) if owner else None
    return st.template if st else []


# ------------------------------------------------------------ entry points
def _consts(unit: C.Unit) -> Dict[str, object]:
    env: Dict[str, object] = dict(unit.consts)
    ev = C.Evaluator(env)
    for name in list(unit.consts):
        try:
            env[name] = ev.value(name)
        except (C.Unresolved, ZeroDivisionError, TypeError):
            env.pop(name, None)
    return env


def check_unit(unit: C.Unit, geometry: Optional[Dict[str, int]] = None,
               smem_budget: int = DEFAULT_SMEM_BUDGET) -> List[Finding]:
    consts = _consts(unit)
    return (check_rings(unit, consts)
            + check_smem(unit, consts, geometry or {}, smem_budget)
            + check_intrinsics(unit))


def check_cuda_source(source: str, path: str = "selftest.cu",
                      geometry: Optional[Dict[str, int]] = None,
                      smem_budget: int = DEFAULT_SMEM_BUDGET
                      ) -> List[Finding]:
    """Every CUDA rule over one source text (the selftest fixtures)."""
    unit = C.parse_text(source, path)
    return check_unit(unit, geometry, smem_budget) + cast_inventory(unit)


def check_python_source(source: str, path: str) -> List[Finding]:
    """RL202 over one launcher module's source."""
    tree = ast.parse(source, filename=path)
    return check_planners(tree, path, Pragmas.scan(source),
                          PLANNERS.get(path, {}))


def load_units(root: str) -> List[C.Unit]:
    units = []
    for d in kernel_dirs(root):
        paths = sorted(glob.glob(os.path.join(d, "*.cuh"))) + \
            sorted(glob.glob(os.path.join(d, "*.cu")))
        if paths:
            units.append(C.parse_unit(paths, root))
    return units


def check_tree(root: str, geometry: Optional[Dict[str, int]] = None,
               smem_budget: int = DEFAULT_SMEM_BUDGET) -> List[Finding]:
    """RL201-RL203 and the CUDA RL401 over every kernel directory, and RL202
    over every ``kernels/*/ops.py``."""
    findings: List[Finding] = []
    for unit in load_units(root):
        findings += check_unit(unit, geometry, smem_budget)
    for path, planners in PLANNERS.items():
        full = os.path.join(root, path)
        if os.path.exists(full):
            with open(full) as f:
                src = f.read()
            findings += check_planners(ast.parse(src), path,
                                       Pragmas.scan(src), planners)
    return findings


def inventory_tree(root: str) -> List[Finding]:
    """The RL406 inventory over every kernel directory."""
    out: List[Finding] = []
    for unit in load_units(root):
        out += cast_inventory(unit)
    seen, uniq = set(), []
    for f in out:
        if (f.path, f.line, f.message) not in seen:
            seen.add((f.path, f.line, f.message))
            uniq.append(f)
    return uniq
