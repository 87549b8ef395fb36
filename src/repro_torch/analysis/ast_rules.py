"""Source-level lint rules (RL001-RL004) over the port's tree.

Counterpart of ``repro/analysis/ast_rules.py``, translated to PyTorch and
CUDA graphs: host syncs are torch's (``.item()``, ``.cpu()``, ...), the
bodies whose Python runs once are the ones a CUDA graph captures, the
objects built per geometry are graphs and captured stages, and the hazard
of an in-place update is an alias that silently changes under it.

The pass is purely lexical: no module of the checked tree is imported. The
design goal is zero false positives on the shipped tree with pragmas only at
the sanctioned sync sites, not completeness against adversarial code.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, Pragmas

ENGINE_PATH = "src/repro_torch/serving/engine.py"
GRAPHS_PATH = "src/repro_torch/serving/graphs.py"

# Functions on the decode hot path by qualname, per repo-relative path. A
# def tagged `# retrolint: hot` on its def line is hot anywhere.
HOT_PATHS: Dict[str, Tuple[str, ...]] = {
    ENGINE_PATH: (
        "ServeEngine.serve",
        "ServeEngine._admit_blocking",
        "ServeEngine._admit_chunked",
        "ServeEngine._admitted",
        "Sampler.__call__",
        "_Readback.get",
        "_DirectStore.decode_step",
        "_DirectStore.flush",
        "_OffloadPlane.decode_step",
        "_OffloadPlane.step",
        "_OffloadPlane.flush",
        "_OffloadPlane.admit_slot",
        "_OffloadPlane._translate",
        "_OffloadPlane._drain_admissions",
    ),
    GRAPHS_PATH: ("OffloadStage.wait_ids",),
}

# Functions whose body a CUDA graph captures (DecodeGraph, OffloadStage),
# per path, each with the names (or ``self.`` attribute chains) that hold
# tensors there: the seeds of RL002's taint walk.
_DECODE = ("state", "token", "active")
CAPTURED: Dict[str, Dict[str, Tuple[str, ...]]] = {
    GRAPHS_PATH: {
        "DecodeGraph._run": ("self.state", "self.tokens", "self.active"),
        "OffloadStage._piece": ("self.x", "self.tokens", "self.ctx",
                                "self.ints", "self.rows", "self.lives",
                                "self.active", "self.logits", "self.ids"),
        "OffloadStage._rank_half": ("self.x", "self.lives", "self.active",
                                    "self.ctx", "self.h_ids"),
        "OffloadStage.cache_update": ("self.ints", "self.rows"),
        "offload_cache_update": ("ck", "cv", "cp", "adm_ids", "adm_rows",
                                 "miss_ids", "miss_rows"),
        "_scatter_rows": ("ck", "cv", "cp", "ids", "rows"),
    },
    ENGINE_PATH: {
        "_DirectStore.__init__.fn": ("st", "tokens", "active"),
        "Sampler.__call__": ("logits",),
    },
    "src/repro_torch/models/model.py": {"apply_decode": _DECODE},
    "src/repro_torch/models/transformer.py": {
        "decode_step": _DECODE,
        "decode_embed": ("token",),
        "decode_unembed": ("x",),
        "offload_decode_rank": ("live", "x", "active"),
        "offload_decode_attend": ("live", "x", "ctx", "cache_k", "cache_v",
                                  "cache_pos", "idx_slots", "valid"),
    },
    "src/repro_torch/core/wave_index.py": {
        "append_token": ("state", "k_new", "v_new", "active"),
    },
    "src/repro_torch/core/attention.py": {
        "wave_attention_decode": ("q", "state"),
        "wave_decode_rank": ("qg", "state"),
        "wave_attention_attend": ("q", "state", "idx_r", "est_logit", "cs_e",
                                  "vs_e", "kv_src", "valid", "cover"),
        "rank_clusters": ("q_group", "state"),
        "full_attention_decode": ("q", "cache"),
        "dense_cache_append": ("cache", "k_new", "v_new", "active"),
    },
}

# host syncs: module functions and tensor methods that block on the card
_SYNC_FUNCS = {("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
               ("numpy", "array"), ("torch", "cuda", "synchronize"),
               ("cuda", "synchronize")}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}

# attribute/metadata accesses that yield STATIC (untraced) values
_UNTAINT_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout"}
_UNTAINT_METHODS = {"dim", "size", "numel", "element_size", "data_ptr",
                    "is_contiguous", "stride"}
_UNTAINT_CALLS = {"len", "range", "enumerate", "zip", "isinstance", "type",
                  "getattr", "hasattr"}

# calls that build (and so capture or compile) a graph: RL003
_GRAPH_MAKERS = {("cuda", "CUDAGraph"), ("cuda", "graph"),
                   ("torch", "compile"), ("DecodeGraph",), ("OffloadStage",)}

# methods whose result shares its receiver's storage (RL004 aliases)
_VIEW_METHODS = {"view", "view_as", "reshape", "detach", "numpy", "flatten",
                 "squeeze", "unsqueeze", "t", "transpose", "permute",
                 "expand", "expand_as", "narrow", "select", "unbind",
                 "split", "chunk", "as_strided", "_replace"}


def _attr_chain(node: ast.AST) -> Tuple[str, ...]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


class _QualnameVisitor(ast.NodeVisitor):
    """Base visitor tracking the enclosing def/class qualname."""

    def __init__(self) -> None:
        self.stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_fn(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn


def _is_display(node: ast.AST) -> bool:
    """A literal list/tuple/number: host data, never a device tensor."""
    return isinstance(node, (ast.List, ast.Tuple, ast.Constant,
                             ast.ListComp))


def sync_call(node: ast.Call) -> Optional[str]:
    """The host sync a call makes, as text, or None."""
    chain = _attr_chain(node.func)
    if chain[-2:] in _SYNC_FUNCS or chain[-3:] in _SYNC_FUNCS:
        if chain[-1] in ("asarray", "array") and node.args \
                and _is_display(node.args[0]):
            return None
        return ".".join(chain)
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _SYNC_METHODS:
            return f".{attr}()"
        if attr == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in list(node.args) + [k.value for k in node.keywords]):
            return '.to("cpu")'
    return None


# ------------------------------------------------------------------- RL001
def _check_hot_syncs(tree: ast.Module, path: str, pragmas: Pragmas,
                     hot_qualnames: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []

    class V(_QualnameVisitor):
        def __init__(self) -> None:
            super().__init__()
            self.hot_depth = 0

        def _visit_fn(self, node):
            self.stack.append(node.name)
            is_hot = self.qualname in hot_qualnames \
                or pragmas.marks_hot(node.lineno)
            self.hot_depth += is_hot
            self.generic_visit(node)
            self.hot_depth -= is_hot
            self.stack.pop()

        visit_FunctionDef = _visit_fn
        visit_AsyncFunctionDef = _visit_fn

        def visit_Call(self, node: ast.Call) -> None:
            if self.hot_depth:
                hit = sync_call(node)
                if hit and not (pragmas.sanctions_sync(node.lineno)
                                or pragmas.ignores(node.lineno, "RL001")):
                    findings.append(Finding(
                        "RL001", path, node.lineno, self.qualname,
                        f"host sync `{hit}` on the decode hot path without "
                        f"a `# retrolint: sync(<reason>)` pragma"))
            self.generic_visit(node)

    V().visit(tree)
    return findings


# ------------------------------------------------------------------- RL002
class _TaintChecker:
    """Per-function taint walk from the captured function's tensor seeds;
    flags Python control flow on tensor values."""

    def __init__(self, fn: ast.FunctionDef, seeds: Iterable[str]) -> None:
        self.fn = fn
        self.tainted: Set[str] = set(seeds)

    def expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _UNTAINT_ATTRS:
                return False
            if ".".join(_attr_chain(node)) in self.tainted:
                return True
            return self.expr_tainted(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.expr_tainted(node.left) or \
                self.expr_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `is (not) None` and friends are static identity checks
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return self.expr_tainted(node.left) or \
                any(self.expr_tainted(c) for c in node.comparators)
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if len(chain) == 1 and chain[0] in _UNTAINT_CALLS:
                return False
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _UNTAINT_METHODS:
                return False
            if isinstance(node.func, ast.Attribute) \
                    and self.expr_tainted(node.func.value):
                return True             # a tensor method: a tensor result
            return any(self.expr_tainted(a) for a in node.args) or \
                any(self.expr_tainted(k.value) for k in node.keywords)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return any(self.expr_tainted(e)
                       for e in (node.test, node.body, node.orelse))
        return False

    def run(self, path: str, qualname: str,
            pragmas: Pragmas) -> List[Finding]:
        findings: List[Finding] = []

        def flag(node, what):
            if not pragmas.ignores(node.lineno, "RL002"):
                findings.append(Finding(
                    "RL002", path, node.lineno, qualname,
                    f"Python `{what}` on a tensor value inside a function a "
                    f"CUDA graph captures (use torch.where / masked updates)"))

        def bind(target):
            if isinstance(target, ast.Attribute):
                self.tainted.add(".".join(_attr_chain(target)))
            elif isinstance(target, ast.Name):
                self.tainted.add(target.id)
            elif isinstance(target, (ast.Tuple, ast.List)):
                for e in target.elts:
                    bind(e)
            elif isinstance(target, ast.Starred):
                bind(target.value)

        for node in ast.walk(self.fn):
            if isinstance(node, ast.Assign) and self.expr_tainted(node.value):
                for t in node.targets:
                    bind(t)
        for node in ast.walk(self.fn):
            if isinstance(node, ast.If) and self.expr_tainted(node.test):
                flag(node, "if")
            elif isinstance(node, ast.While) \
                    and self.expr_tainted(node.test):
                flag(node, "while")
            # a loop over a tuple display walks a fixed set of tensors
            elif isinstance(node, ast.For) \
                    and not isinstance(node.iter, (ast.Tuple, ast.List)) \
                    and self.expr_tainted(node.iter):
                flag(node, "for")
        return findings


def _check_captured_branches(tree: ast.Module, path: str, pragmas: Pragmas,
                             captured: Dict[str, Tuple[str, ...]]
                             ) -> List[Finding]:
    findings: List[Finding] = []

    class V(_QualnameVisitor):
        def _visit_fn(self, node):
            self.stack.append(node.name)
            seeds = captured.get(self.qualname)
            if seeds is not None:
                findings.extend(_TaintChecker(node, seeds).run(
                    path, self.qualname, pragmas))
            self.generic_visit(node)
            self.stack.pop()

        visit_FunctionDef = _visit_fn
        visit_AsyncFunctionDef = _visit_fn

    V().visit(tree)
    return findings


# ------------------------------------------------------------------- RL003
def _check_graph_in_loop(tree: ast.Module, path: str,
                         pragmas: Pragmas) -> List[Finding]:
    findings: List[Finding] = []

    class V(_QualnameVisitor):
        def __init__(self) -> None:
            super().__init__()
            self.loop_depth = 0

        def _visit_loop(self, node):
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        visit_For = _visit_loop
        visit_While = _visit_loop
        visit_AsyncFor = _visit_loop

        def _visit_fn(self, node):
            # a def inside a loop resets the loop context: a factory that
            # happens to sit in a loop is the factory's problem
            saved, self.loop_depth = self.loop_depth, 0
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()
            self.loop_depth = saved

        visit_FunctionDef = _visit_fn
        visit_AsyncFunctionDef = _visit_fn

        def visit_Call(self, node: ast.Call) -> None:
            chain = _attr_chain(node.func)
            if self.loop_depth and (chain[-2:] in _GRAPH_MAKERS
                                    or chain[-1:] in _GRAPH_MAKERS) \
                    and not pragmas.ignores(node.lineno, "RL003"):
                findings.append(Finding(
                    "RL003", path, node.lineno, self.qualname,
                    f"`{'.'.join(chain)}` built inside a loop body (a fresh "
                    f"capture or compile every iteration) — hoist it out"))
            self.generic_visit(node)

    V().visit(tree)
    return findings


# ------------------------------------------------------------------- RL004
def _fn_name(node: ast.AST) -> Optional[str]:
    """The qualname a stage's ``fn`` names: "module:qual" as a string or
    an f-string whose last literal piece holds ":qual"."""
    text = None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        text = node.value
    elif isinstance(node, ast.JoinedStr) and node.values \
            and isinstance(node.values[-1], ast.Constant):
        text = str(node.values[-1].value)
    if not text or ":" not in text:
        return None
    return text.rsplit(":", 1)[1]


def inplace_bindings(tree: ast.Module) -> Dict[str, Tuple[int, ...]]:
    """Callee short name -> in-place argument positions, from a module-level
    ``SERVE_STAGES`` dict literal (each entry ``dict(donate=..., fn=...)``)."""
    out: Dict[str, Tuple[int, ...]] = {}
    for node in tree.body:
        target = value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        if not (isinstance(target, ast.Name) and target.id == "SERVE_STAGES"
                and isinstance(value, ast.Dict)):
            continue
        for entry in value.values:
            if not (isinstance(entry, ast.Call) and entry.keywords):
                continue
            kw = {k.arg: k.value for k in entry.keywords}
            qual = _fn_name(kw.get("fn"))
            try:
                don = ast.literal_eval(kw["donate"]) if "donate" in kw else ()
            except ValueError:
                continue
            if qual and don:
                out[qual.rsplit(".", 1)[-1]] = tuple(don)
    return out


def _alias_root(node: ast.AST, views: bool = True) -> Optional[str]:
    """The root a Name/Attribute/Subscript chain (through view-like method
    calls when ``views``) shares storage with: its root name, or the text
    ``self.<attr>`` for an attribute of ``self``; None for anything else
    (a call result is fresh memory)."""
    while True:
        if views and isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _VIEW_METHODS:
            node = node.func.value
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return f"self.{node.attr}"
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def _check_alias_reuse(tree: ast.Module, path: str, pragmas: Pragmas,
                       donors: Dict[str, Tuple[int, ...]]) -> List[Finding]:
    if not donors:
        return []
    findings: List[Finding] = []

    class V(_QualnameVisitor):
        def _visit_fn(self, fn):
            self.stack.append(fn.name)
            self._scan_fn(fn, self.qualname)
            self.generic_visit(fn)
            self.stack.pop()

        visit_FunctionDef = _visit_fn
        visit_AsyncFunctionDef = _visit_fn

        def _scan_fn(self, fn, qualname: str) -> None:
            loads: Dict[str, List[int]] = {}
            stores: Dict[str, List[int]] = {}
            aliases: List[Tuple[str, str, int]] = []   # (name, root, line)
            for node in ast.walk(fn):
                if isinstance(node, ast.Name):
                    side = loads if isinstance(node.ctx, ast.Load) else stores
                    side.setdefault(node.id, []).append(node.lineno)
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    root = _alias_root(node.value)
                    if root is not None:
                        aliases.append((node.targets[0].id, root,
                                        node.lineno))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = _attr_chain(node.func)
                short = callee[-1] if callee else None
                if short not in donors:
                    continue
                line = node.lineno
                if pragmas.ignores(line, "RL004"):
                    continue
                for pos in donors[short]:
                    if pos >= len(node.args):
                        continue
                    arg = _alias_root(node.args[pos], views=False)
                    if arg is None:
                        continue
                    for name, root, at in aliases:
                        if root != arg or at >= line or name == arg:
                            continue
                        # the alias must still be the live binding at the call
                        if any(at < s < line for s in stores.get(name, [])):
                            continue
                        later = [ln for ln in loads.get(name, [])
                                 if ln > line and not any(
                                     line <= s < ln
                                     for s in stores.get(name, []))]
                        if later:
                            findings.append(Finding(
                                "RL004", path, later[0], qualname,
                                f"`{name}` aliases `{arg}` (no .clone()) "
                                f"and is read after `{short}` updated "
                                f"`{arg}` in place (arg {pos}): it holds "
                                f"the new values, not the old"))

    V().visit(tree)
    return findings


# ------------------------------------------------------------ entry points
def lint_source(source: str, path: str, hot_qualnames: Sequence[str] = (),
                donors: Optional[Dict[str, Tuple[int, ...]]] = None
                ) -> List[Finding]:
    """All AST rules over one file's source. ``path`` is repo-relative;
    ``donors``: in-place stage bindings from elsewhere in the tree (the
    engine's ``SERVE_STAGES``), joined with the file's own."""
    tree = ast.parse(source, filename=path)
    pragmas = Pragmas.scan(source)
    hot = tuple(hot_qualnames) + HOT_PATHS.get(path, ())
    don = dict(donors or {})
    don.update(inplace_bindings(tree))
    findings = []
    findings += _check_hot_syncs(tree, path, pragmas, hot)
    findings += _check_captured_branches(tree, path, pragmas,
                                         CAPTURED.get(path, {}))
    findings += _check_graph_in_loop(tree, path, pragmas)
    findings += _check_alias_reuse(tree, path, pragmas, don)
    return findings


def lint_tree(root: str, subdirs: Iterable[str] = ("src/repro_torch",)
              ) -> List[Finding]:
    donors: Dict[str, Tuple[int, ...]] = {}
    engine = os.path.join(root, ENGINE_PATH)
    if os.path.exists(engine):
        with open(engine) as f:
            donors = inplace_bindings(ast.parse(f.read()))
    findings: List[Finding] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirs, files in os.walk(base):
            dirs.sort()
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                with open(full) as f:
                    findings += lint_source(f.read(), rel, donors=donors)
    return findings
