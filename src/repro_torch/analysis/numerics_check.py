"""retronum — the precision-flow checker of the port's decode numerics
contract (rules RL401-RL406).

Counterpart of ``repro/analysis/numerics_check.py``. The reference walks
jaxprs; here a recording ``TorchDispatchMode`` traces the curated decode
targets op by op, under ``FakeTensorMode`` with ``device="cuda"`` (shapes
and dtypes, no data, and the code paths the card runs: ``_f32_product``'s
``torch.bmm(..., out_dtype=float32)``, the kernel wrappers' CUDA branch),
or on real CUDA tensors with the kernels launched (``fake=False``, on the
card). Each ctypes kernel wrapper stands in as one opaque recorded op from
its tensor inputs to its output (under fake tensors it cannot run: it needs
``data_ptr`` and a built library). Ops are linked producer to consumer by
tensor identity, and the contract (``SERVE_STAGES``' ``numerics=``) is
checked over that graph:

* RL401 — exp/log/softmax-family ops on a float operand below the softmax
  floor; (CUDA sources) 16-bit transcendental intrinsics, in
  ``kernel_check``;
* RL402 — (a) a matmul with sub-f32 operands and a sub-f32 output; (b) a
  widening of >= 4 MiB of stored operand feeding a matmul (the hoisted
  whole-store upcast);
* RL403 — a widening whose producer, through views, is a narrowing from an
  equal-or-wider dtype (two roundings);
* RL404 — a narrowing consumed by anything but the target's output, another
  cast, a same-dtype store write or a matmul with an f32 output;
* RL405 — the ``(num, den, m)`` parts of ``return_parts`` below f32, and a
  collective (``core/distributed.all_reduce``) over a sub-f32 operand;
* RL406 — (advice) the cast-site inventory of the CUDA kernels the targets
  launch (``kernel_check.cast_inventory``).

The curated targets (``run_numerics_checks``) are the reference's: the
dense fallback and its append (bf16 cache, B 2, Hkv 4, S 8192, hd 128), the
wave decode at "jnp" and "fused" over a bf16 store, the ``return_parts``
triple, and the distributed LSE merge.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log1p", "expm1", "sigmoid",
                   "tanh", "_softmax", "_log_softmax", "softmax",
                   "log_softmax", "logsumexp", "special_expit"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv", "addmv",
           "_scaled_mm", "einsum"}
# ops a value flows through unchanged (provenance walks)
_PASSTHROUGH = {"view", "_unsafe_view", "reshape", "expand", "permute",
                "transpose", "t", "unsqueeze", "squeeze", "slice", "select",
                "index", "gather", "index_select", "alias", "clone",
                "contiguous", "detach", "lift_fresh", "as_strided", "unbind",
                "split", "split_with_sizes", "cat", "stack", "where",
                "narrow", "flatten", "unfold", "repeat", "expand_copy",
                "slice_copy", "view_copy", "masked_fill", "roll"}
# storage writes: a narrowing feeding one of these at matching dtype is the
# sanctioned store-write path
_STORE_WRITE = {"copy_", "index_put_", "index_put", "_index_put_impl_",
                "scatter", "scatter_", "slice_scatter", "select_scatter",
                "index_copy_", "index_copy", "masked_scatter_"}
_CONVERT = "_to_copy"

# RL402(b): a widening at least this large feeding a matmul is the
# hoisted-cast hazard; per-tile / query-sized casts stay far below it
RL402_MIN_BYTES = 4 << 20

_ATTN_PATH = "src/repro_torch/core/attention.py"
_DIST_PATH = "src/repro_torch/core/distributed.py"
# the kernel wrappers the decode targets launch, as opaque ops: name ->
# (module, kernel dir); both return (B, H, G, hd) f32 like their qg
KERNEL_WRAPPERS = {
    "paged_wave_attention": ("repro_torch.kernels.wave_attention.ops",
                             "wave_attention"),
    "wave_attention_merge": ("repro_torch.kernels.wave_attention.ops",
                             "wave_attention"),
}


@dataclass(frozen=True)
class NumericsContract:
    """Per-stage numerics contract (the ``numerics=`` SERVE_STAGES field).

    softmax: dtype floor for exp/log/LSE chains            (RL401)
    accum:   dtype floor for matmul outputs                (RL402)
    narrow:  "output-only" — only the output and same-dtype storage writes
             may consume a narrowed value (RL403/RL404); "free" disables the
             narrowing rules."""
    softmax: str = "float32"
    accum: str = "float32"
    narrow: str = "output-only"

    @classmethod
    def from_spec(cls, spec: Optional[Dict[str, str]]) -> "NumericsContract":
        return cls() if spec is None else cls(**spec)


def _bytes_of(name: str) -> int:
    return getattr(torch, name).itemsize


# ---------------------------------------------------------------- recording
@dataclass
class _Op:
    name: str                       # overload packet short name
    ins: List[int]                  # tensor ids
    outs: List[int]
    store_dtype: Optional[torch.dtype] = None
    site: Optional[Tuple[str, int]] = None      # casts: the source line


@dataclass
class OpGraph:
    ops: List[_Op] = field(default_factory=list)
    meta: Dict[int, Tuple[Tuple[int, ...], torch.dtype]] = \
        field(default_factory=dict)
    producer: Dict[int, _Op] = field(default_factory=dict)
    consumers: Dict[int, List[_Op]] = field(default_factory=dict)
    keep: List[torch.Tensor] = field(default_factory=list)
    outputs: set = field(default_factory=set)
    kernels: List[str] = field(default_factory=list)

    def note(self, t: torch.Tensor) -> int:
        k = id(t)
        if k not in self.meta:
            self.keep.append(t)               # ids stay unique while traced
            self.meta[k] = (tuple(t.shape), t.dtype)
        return k

    def add(self, name: str, ins: Sequence[torch.Tensor],
            outs: Sequence[torch.Tensor], store_dtype=None,
            site=None) -> _Op:
        op = _Op(name, [self.note(t) for t in ins],
                 [self.note(t) for t in outs], store_dtype, site)
        self.ops.append(op)
        for k in op.ins:
            self.consumers.setdefault(k, []).append(op)
        for k in op.outs:
            self.producer[k] = op
        return op


_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_HERE = os.path.dirname(os.path.abspath(__file__)) + os.sep
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE.rstrip(os.sep)))) + os.sep


def _site() -> Optional[Tuple[str, int]]:
    """(path, line) of the innermost frame outside torch and this
    package: the source line that made the op."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not (fn.startswith(_TORCH_DIR) or fn.startswith(_HERE)
                or fn.startswith("<")):
            if fn.startswith(_REPO):
                fn = os.path.relpath(fn, _REPO).replace(os.sep, "/")
            return fn, f.f_lineno
        f = f.f_back
    return None


# metadata queries: no value flows through them
_METADATA = {"device", "dim", "sym_size", "sym_numel", "sym_stride",
             "sym_storage_offset", "is_contiguous", "layout", "size",
             "stride", "numel"}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class _Recorder(TorchDispatchMode):
    def __init__(self, graph: OpGraph):
        super().__init__()
        self.g = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _METADATA:
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        store = None
        if name in _STORE_WRITE and ins:
            store = ins[0].dtype
        self.g.add(name, ins, outs, store,
                   _site() if name == _CONVERT else None)
        return out


def _stand_in(name: str, orig: Callable, graph: OpGraph):
    """A kernel wrapper as one recorded op: it runs on real tensors, and
    under fake ones returns an empty output of the kernel's shape."""
    from torch._subclasses.fake_tensor import FakeTensor

    @functools.wraps(orig)
    def kernel(*args, **kwargs):
        ins = _tensors(list(args) + list(kwargs.values()))
        if any(isinstance(t, FakeTensor) for t in ins):
            qg = args[0]                    # (B, H, G, hd) for both kernels
            out = torch.empty(qg.shape, dtype=torch.float32,
                              device=qg.device)
        else:
            out = orig(*args, **kwargs)
        graph.add(f"kernel:{name}", ins, _tensors(out))
        graph.kernels.append(name)
        return out
    return kernel


def _collective(graph: OpGraph):
    """``core/distributed.all_reduce`` as one recorded op over a group of
    one: the merge's numerics without a process group."""
    def all_reduce(t, op, group=None):
        graph.add("collective:all_reduce", [t], [t])
        return t
    return all_reduce


@contextlib.contextmanager
def _patched(graph: OpGraph):
    import importlib
    from repro_torch.core import distributed
    saved = []
    try:
        for name, (mod, _) in KERNEL_WRAPPERS.items():
            m = importlib.import_module(mod)
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, _stand_in(name, getattr(m, name), graph))
        saved.append((distributed, "all_reduce", distributed.all_reduce))
        distributed.all_reduce = _collective(graph)
        yield
    finally:
        for m, name, orig in reversed(saved):
            setattr(m, name, orig)


class _AtenIndexing(TorchFunctionMode):
    """``t[idx]``, ``t[idx] = v`` and ``t.contiguous()`` as explicit aten
    ops (slice, select, unsqueeze, index, copy_, index_put_, clone). These
    Python bindings take a device guard that a CPU-only torch build cannot
    make for a fake CUDA tensor; the aten ops themselves trace fine."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            return _getitem(*args)
        if func is torch.Tensor.__setitem__:
            return _setitem(*args)
        if func is torch.Tensor.contiguous and not args[0].is_contiguous():
            return torch.ops.aten.clone.default(
                args[0], memory_format=torch.contiguous_format)
        return func(*args, **kwargs)


def _basic(t: torch.Tensor, idx):
    """Apply the basic part of an index; return (view, advanced indices
    aligned to the view's dims, or None if there are none)."""
    aten = torch.ops.aten
    idx = idx if isinstance(idx, tuple) else (idx,)
    n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
    if any(i is Ellipsis for i in idx):
        k = next(j for j, i in enumerate(idx) if i is Ellipsis)
        idx = idx[:k] + (slice(None),) * (t.dim() - n_real) + idx[k + 1:]
    adv: List[Optional[torch.Tensor]] = []
    dim = 0
    for i in idx:
        if i is None:
            t = aten.unsqueeze.default(t, dim)
            adv.append(None)
            dim += 1
        elif isinstance(i, bool):
            raise TypeError("boolean scalar index")
        elif isinstance(i, int):
            t = aten.select.int(t, dim, i)
        elif isinstance(i, slice):
            start = 0 if i.start is None else i.start
            stop = (2 ** 62) if i.stop is None else i.stop
            t = aten.slice.Tensor(t, dim, start, stop, i.step or 1)
            adv.append(None)
            dim += 1
        else:
            if not isinstance(i, torch.Tensor):
                i = torch.as_tensor(i, device=t.device)
            adv.append(i)
            dim += 1
    has_adv = any(a is not None for a in adv)
    return t, (adv if has_adv else None)


def _getitem(t, idx):
    view, adv = _basic(t, idx)
    return view if adv is None else torch.ops.aten.index.Tensor(view, adv)


def _setitem(t, idx, value):
    view, adv = _basic(t, idx)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=t.dtype, device=t.device)
    if adv is None:
        view.copy_(value)
    else:
        torch.ops.aten.index_put_.default(view, adv, value.to(t.dtype))


def trace(fn: Callable, make_args: Callable[[], tuple], *, fake: bool = True
          ) -> Tuple[OpGraph, Any]:
    """Record ``fn(*make_args())``; the args are made inside the trace
    (fake ones under ``fake``)."""
    graph = OpGraph()
    with contextlib.ExitStack() as stack:
        if fake:
            from torch._subclasses.fake_tensor import FakeTensorMode
            stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
            stack.enter_context(_AtenIndexing())
        args = make_args()
        stack.enter_context(_patched(graph))
        with torch.no_grad(), _Recorder(graph):
            out = fn(*args)
    graph.outputs = {id(t) for t in _tensors(out)}
    return graph, out


# ------------------------------------------------------------ rule machinery
def _walk_forward(g: OpGraph, key: int):
    """Terminal consumers of ``key`` through passthroughs, and whether it
    reaches the target's output."""
    seen, stack, terms, hits_out = set(), [key], [], False
    while stack:
        k = stack.pop()
        if k in seen:
            continue
        seen.add(k)
        if k in g.outputs:
            hits_out = True
        for op in g.consumers.get(k, ()):
            if op.name in _PASSTHROUGH:
                stack.extend(op.outs)
            else:
                terms.append(op)
    return terms, hits_out


def _walk_back(g: OpGraph, key: int) -> Optional[_Op]:
    seen = set()
    while key not in seen:
        seen.add(key)
        op = g.producer.get(key)
        if op is None or op.name not in _PASSTHROUGH or not op.ins:
            return op
        key = op.ins[0]
    return None


def _is_float(dtype) -> bool:
    return dtype is not None and dtype.is_floating_point


def _nbytes(meta) -> int:
    shape, dtype = meta
    n = 1
    for d in shape:
        n *= d
    return n * dtype.itemsize


def check_graph(g: OpGraph, *, name: str, path: str,
                contract: Optional[NumericsContract] = None
                ) -> List[Finding]:
    """RL401-RL405 over one recorded target."""
    contract = contract or NumericsContract()
    soft_floor = _bytes_of(contract.softmax)
    accum_floor = _bytes_of(contract.accum)
    narrow_rules = contract.narrow == "output-only"
    out: List[Finding] = []

    def add(rule, msg, op=None):
        p, ln = op.site if op is not None and op.site else (path, 0)
        f = Finding(rule, p, ln, name, msg)
        if all((x.rule, x.path, x.line, x.message)
               != (rule, p, ln, msg) for x in out):
            out.append(f)

    for op in g.ops:
        in_meta = [g.meta[k] for k in op.ins]
        if op.name in _TRANSCENDENTAL:
            for shape, dt in in_meta[:1]:
                if _is_float(dt) and dt.itemsize < soft_floor:
                    add("RL401", f"`{op.name}` computes on {dt} — the "
                        f"softmax/LSE chain must run in {contract.softmax} "
                        f"(upcast the operand row, not the store)")
        elif op.name in _MATMUL:
            fl = [dt for _, dt in in_meta if _is_float(dt)]
            o = g.meta.get(op.outs[0]) if op.outs else None
            if fl and o is not None and _is_float(o[1]) \
                    and any(d.itemsize < accum_floor for d in fl) \
                    and o[1].itemsize < accum_floor:
                add("RL402", f"matmul `{op.name}` with "
                    f"{'/'.join(str(d) for d in fl)} operands rounds its "
                    f"output to {o[1]} — pass out_dtype=torch.float32")
        elif op.name == "collective:all_reduce":
            for _, dt in in_meta:
                if _is_float(dt) and dt.itemsize < 4:
                    add("RL405", f"collective `all_reduce` over {dt} "
                        f"partials — the LSE merge rounds once per shard; "
                        f"keep (num, den, m) f32 until the final downcast")
        if op.name != _CONVERT or not op.ins or not op.outs:
            continue
        src, dst = g.meta[op.ins[0]], g.meta[op.outs[0]]
        sdt, ddt = src[1], dst[1]
        if not (_is_float(sdt) and _is_float(ddt)) or sdt == ddt:
            continue
        if ddt.itemsize > sdt.itemsize:
            back = _walk_back(g, op.ins[0])
            if back is not None and back.name == _CONVERT and back.ins \
                    and narrow_rules:
                bdt = g.meta[back.ins[0]][1]
                if _is_float(bdt) and bdt.itemsize >= ddt.itemsize:
                    add("RL403", f"double rounding: value round-tripped "
                        f"{bdt} -> {sdt} -> {ddt} before accumulation", op)
            if _nbytes(src) >= RL402_MIN_BYTES:
                terms, _ = _walk_forward(g, op.outs[0])
                if any(t.name in _MATMUL for t in terms):
                    add("RL402", f"explicit .to({ddt}) of a "
                        f"{_nbytes(src) >> 20} MiB {sdt}{list(src[0])} "
                        f"operand feeding a matmul — the whole store is "
                        f"converted and written at 2x the bytes every step; "
                        f"keep the storage dtype and widen per tile "
                        f"(out_dtype / the kernel)", op)
        elif narrow_rules:
            terms, _ = _walk_forward(g, op.outs[0])
            bad = []
            for t in terms:
                if t.name == _CONVERT:
                    continue
                if t.name in _STORE_WRITE and t.store_dtype == ddt:
                    continue
                if t.name in _MATMUL and t.outs and \
                        g.meta[t.outs[0]][1].itemsize >= accum_floor:
                    continue
                bad.append(t.name)
            if bad:
                add("RL404", f"unsanctioned downcast {sdt} -> {ddt} consumed "
                    f"by `{'`/`'.join(sorted(set(bad)))}` — only the output, "
                    f"same-dtype store writes and f32-output matmuls may "
                    f"consume a narrowed value", op)
    return out


def numerics_findings(fn, make_args, name: str, *, path: str,
                      contract: Optional[Dict[str, str]] = None,
                      fake: bool = True) -> Tuple[List[Finding], OpGraph]:
    """Trace ``fn`` and check the numerics contract; a target that stops
    tracing is a finding of its own."""
    try:
        g, _ = trace(fn, make_args, fake=fake)
    except Exception as e:      # noqa: BLE001 — surface, don't crash the CLI
        return [Finding("RL401", path, 0, name,
                        f"target could not be traced for the numerics pass: "
                        f"{e!r}")], OpGraph()
    return check_graph(g, name=name, path=path,
                       contract=NumericsContract.from_spec(contract)), g


def parts_findings(fn, make_args, name: str, *, path: str,
                   fake: bool = True) -> List[Finding]:
    """RL405 at the boundary: the ``(num, den, m)`` a ``return_parts``
    target yields must all be f32."""
    try:
        _, out = trace(fn, make_args, fake=fake)
    except Exception as e:      # noqa: BLE001
        return [Finding("RL405", path, 0, name,
                        f"parts target could not be traced: {e!r}")]
    found = []
    for label, t in zip(("num", "den", "m"), out):
        if _is_float(t.dtype) and t.dtype.itemsize < 4:
            found.append(Finding(
                "RL405", path, 0, name,
                f"LSE-merge partial `{label}` leaves the stage as {t.dtype} "
                f"— partial accumulators must stay f32 until the merge's "
                f"single downcast"))
    return found


# --------------------------------------------------- the curated repo gate
def _wave_setup(device: str):
    """The reference's bf16 wave-decode geometry: B 2, Hkv 2, G 2, hd 64,
    a 2048-token context; the payload stores in bf16."""
    from repro_torch.configs.base import RetroConfig
    from repro_torch.core.wave_index import init_wave_state, max_clusters
    from repro_torch.core.zones import plan_zones
    retro = RetroConfig(avg_cluster=64, cluster_cap=256,
                        prefill_segment=1024, update_segment=256,
                        sink=16, local=256, retrieval_frac=0.1,
                        estimation_frac=0.3, kmeans_iters=1)
    B, Hkv, hd, n = 2, 2, 64, 2048
    plan = plan_zones(n, retro)

    def make(q_dtype=torch.bfloat16):
        st = init_wave_state(B, Hkv, hd, max_clusters(n, retro), retro,
                             torch.bfloat16, device)
        st = st._replace(n_clusters=torch.full_like(st.n_clusters, 8),
                         length=torch.full_like(st.length, n))
        q = torch.zeros((B, 2 * Hkv, hd), dtype=q_dtype, device=device)
        return q, st
    return retro, plan, make


def run_numerics_checks(verbose=None, *, device: str = "cuda",
                        fake: bool = True) -> List[Finding]:
    """The retronum gate: every curated decode target traced at bf16
    payload dtypes and held to the decode stage's contract. Returns errors
    plus the RL406 inventory of the kernels the targets launch."""
    from repro_torch.analysis import kernel_check
    from repro_torch.core import attention as attn
    from repro_torch.core.distributed import merge_parts, shard_wave_attention
    from repro_torch.serving.engine import SERVE_STAGES
    log = verbose or (lambda *_: None)
    spec = SERVE_STAGES["decode"]["numerics"]
    findings: List[Finding] = []
    kernels: List[str] = []

    def run(fn, make, name, path):
        fs, g = numerics_findings(fn, make, name, path=path, contract=spec,
                                  fake=fake)
        findings.extend(fs)
        kernels.extend(g.kernels)

    # 1. the dense fallback and its append, bf16 cache (full attention: a
    # whole-cache upcast here is the RL402(b) catch)
    log("retronum: tracing the dense-cache fallback (bf16 cache)")
    B, Hkv, S, hd = 2, 4, 8192, 128

    def dense(q_dtype=torch.bfloat16, new_dtype=torch.float32):
        def make():
            cache = attn.init_dense_cache(B, Hkv, S, hd, torch.bfloat16,
                                          device)
            cache.length.fill_(S // 2)
            return (torch.zeros((B, 2 * Hkv, hd), dtype=q_dtype,
                                device=device), cache,
                    torch.zeros((B, Hkv, hd), dtype=new_dtype, device=device))
        return make
    run(lambda q, c, _: attn.full_attention_decode(q, c), dense(),
        "full_attention_decode", _ATTN_PATH)
    run(lambda _, c, kv: attn.dense_cache_append(c, kv, kv).k, dense(),
        "dense_cache_append", _ATTN_PATH)

    # 2-4. the wave decode over a bf16 store: the reference path ("jnp"),
    # the paged kernel ("fused"), and the return_parts boundary
    log("retronum: tracing the wave decode (jnp + fused, bf16 store)")
    retro, plan, make = _wave_setup(device)
    for impl in ("jnp", "fused"):
        run(functools.partial(
                lambda q, st, impl: attn.wave_attention_decode(
                    q, st, retro, plan, impl=impl).out, impl=impl),
            make, f"wave_attention_decode[{impl}]", _ATTN_PATH)
    findings.extend(parts_findings(
        lambda q, st: attn.wave_attention_decode(
            q, st, retro, plan, impl="jnp", return_parts=True)[:3],
        make, "wave_attention_decode[parts]", path=_ATTN_PATH, fake=fake))

    # 5. the LSE merge of sharded retrieval (its collectives recorded)
    log("retronum: tracing the distributed LSE merge")
    run(lambda q, st: merge_parts(*shard_wave_attention(
            q, st, retro, plan, rank=0, n_shards=1)),
        functools.partial(make, torch.float32), "merge_parts", _DIST_PATH)

    # RL406: the cast sites of the kernels those targets launched
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    dirs = {KERNEL_WRAPPERS[k][1] for k in kernels}
    inventory = [f for f in kernel_check.inventory_tree(root)
                 if any(f"/kernels/{d}/csrc/" in f.path for d in dirs)]
    log(f"retronum: {len(inventory)} certified cast sites, "
        f"{len(findings)} findings")
    return findings + inventory
