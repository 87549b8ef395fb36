"""Dry-run: trace every (arch x input shape) step at full size on the CPU,
with no card and no memory, and derive its roofline terms on H100 meshes.
Port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_2b \\
        --shape decode_32k --mesh h100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh node \\
        --out dryrun.jsonl

The reference lowers and compiles with XLA on placeholder devices and reads
its cost analysis. Here the step from ``serving/steps.py::make_step`` runs
eagerly on fake tensors (``FakeTensorMode``: shapes and dtypes, no data):
``FlopCounterMode`` counts the FLOPs, a dispatch mode adds up every op's
tensor operands and results (an unfused byte count: eager PyTorch writes
every intermediate, views move nothing, an indexed read or write counts
the part it touches), and ``core/distributed.py``'s
tally gives the collective bytes. A recurrence's time loop is traced for
one step and charged for all of them (``ScanSampler``). Peak live memory
is not tracked; the per-device argument bytes come from the sharding
rules.

Per device:
  * ``--mesh h100`` (one card): the trace is the device's program;
  * ``--distributed`` (decode shapes, attention families): the split decode
    step runs rank 0's program over a fake process group the size of the
    'model' axis (the cold cluster axis sharded, ``shard_state``): its
    FLOPs, bytes and collective bytes are one device's, exactly;
  * otherwise the trace's totals divided by the chips, marked
    ``"per_device": "ideal split"`` (eager PyTorch has no SPMD partitioner).

The reference's ``--unroll-layers`` and ``--per-layer-state`` are gone: the
port's layer loop is always a Python loop, and its state is per layer.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from typing import Dict, Optional
from unittest import mock

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, input_specs
from repro_torch.core.distributed import (collective_tally, shard_state,
                                          state_specs_cluster_sharded)
from repro_torch.launch import roofline as R
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_single_mesh)
from repro_torch.models import model as M
from repro_torch.models.transformer import split_state
from repro_torch.serving.steps import make_serve_step_split, make_step
from repro_torch.training.optimizer import init_adamw
from repro_torch.training.train_loop import TrainState, trainable

MESHES = {"h100": lambda: make_single_mesh(),
          "node": lambda: make_production_mesh(),
          "nodes": lambda: make_production_mesh(multi_node=True)}


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

_ALIASES = {"_unsafe_view", "alias", "detach", "lift_fresh"}


def _moves_data(func, out) -> bool:
    """Whether an op reads or writes data: not a view or alias, not a
    metadata query (``prim`` ops, ops returning no tensor)."""
    if func.is_view or func.namespace == "prim" \
            or func._schema.name.split("::")[-1] in _ALIASES:
        return False
    return any(isinstance(t, torch.Tensor) for t in tree_flatten(out)[0])


# indexed reads and writes touch part of their first operand: as much as
# they read (the result) or write (the values)
_PART_READS = {"gather", "index", "index_select", "embedding"}
_PART_WRITES = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
                "scatter_reduce_"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every op's tensor operands and results (views,
    aliases and metadata queries excepted; an indexed read or write counts
    the part of its first operand it touches): the traffic of an unfused,
    eager execution."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _moves_data(func, out):
            name = func._schema.name.split("::")[-1]
            rest = _nbytes((args[1:], kwargs))
            if name in _PART_READS:
                self.bytes += rest + 2 * _nbytes(out)
            elif name in _PART_WRITES:
                # the written values (the last tensor operand) land in self
                vals = [t for t in tree_flatten((args[1:], kwargs))[0]
                        if isinstance(t, torch.Tensor)]
                self.bytes += rest + (_nbytes(vals[-1]) if vals else 0)
            else:
                self.bytes += _nbytes((args, kwargs, out))
            self.ops += 1
        return out


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def materialize(tree):
    """Meta tensors of a spec tree -> empty tensors on the CPU (fake ones
    inside ``fake_mode``), contiguous; other leaves kept."""
    def one(_, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.empty(leaf.shape, dtype=leaf.dtype)
        return leaf
    return S.map_with_path(one, tree)


class ScanSampler:
    """Stands in for a recurrence's time loop (``scan_utils._loop``) while
    tracing: runs its first step and charges the counters for all T, since
    every step has the same shapes. Under autograd, a probe (the step again
    on detached inputs, then its grads: carry, inputs and the tensors the
    body captures) measures one step's backward, and T - 1 of them are
    charged: the real backward pass runs the sampled step's once. A
    checkpoint's recompute (inside the backward pass) is charged its T
    forward steps. The outputs repeat the first step's T times (one copy
    of the real loop's stack's bytes); its backward is one sum over the T
    copies where the real loop's is free (views)."""

    def __init__(self, fc: FlopCounterMode, bc: ByteCounter):
        self.fc, self.bc = fc, bc
        self.flops = self.bytes = self.ops = 0

    def _now(self):
        return self.fc.get_total_flops(), self.bc.bytes, self.bc.ops

    def _charge(self, before, times: int, after=None):
        after = after or self._now()
        self.flops += times * (after[0] - before[0])
        self.bytes += times * (after[1] - before[1])
        self.ops += times * (after[2] - before[2])

    def __call__(self, body, carry, xs):
        from repro_torch.models.scan_utils import records
        T = xs[0].shape[0]
        x0 = tuple(x[0] for x in xs)
        t0 = self._now()
        carry1, y = body(carry, x0)
        self._charge(t0, T - 1)
        if records(carry1, y) and torch._C._current_autograd_node() is None:
            self._probe_backward(body, carry, x0, T)
        # the real loop's stack of T outputs, in one op of its bytes
        return carry1, y.unsqueeze(0).expand((T,) + tuple(y.shape)).clone()

    def _probe_backward(self, body, carry, x0, T):
        captured = [c.cell_contents for c in body.__closure__ or ()
                    if isinstance(c.cell_contents, torch.Tensor)
                    and c.cell_contents.requires_grad]
        t0 = self._now()
        # saved tensors kept as they are: a checkpoint's hooks would
        # recompute its whole region for this grad
        with torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                      lambda t: t):
            ins = [t.detach().requires_grad_(t.requires_grad)
                   for t in (carry, *x0)]
            c1, y = body(ins[0], tuple(ins[1:]))
            t1 = self._now()
            torch.autograd.grad(
                (c1, y), [t for t in ins if t.requires_grad] + captured,
                (torch.ones_like(c1), torch.ones_like(y)), allow_unused=True)
        t2 = self._now()
        self._charge(t1, T - 1, t2)                 # the backward, T - 1 more
        self._charge(t0, -1, t2)                    # the probe itself: undone


def sampled_loops(sampler: ScanSampler):
    """While open, the recurrences' time loop (``scan_utils._loop``) is
    ``sampler``."""
    from repro_torch.models import scan_utils
    return mock.patch.object(scan_utils, "_loop", sampler)


def trace_cost(fn, *args) -> Dict:
    """Run ``fn(*args)`` (inside ``fake_mode``) under the counters, the
    recurrences' time loops sampled (``ScanSampler``):
    -> {"flops", "bytes accessed", "ops", "coll"}."""
    # a checkpoint's recompute runs its whole region (the sampler charges a
    # scan's steps after its sampled one, where an early stop would cut it)
    with set_checkpoint_early_stop(False), collective_tally() as tally, \
            ByteCounter() as bc, FlopCounterMode(display=False) as fc:
        sampler = ScanSampler(fc, bc)
        with sampled_loops(sampler):
            fn(*args)
    return {"flops": float(fc.get_total_flops() + sampler.flops),
            "bytes accessed": float(bc.bytes + sampler.bytes),
            "ops": bc.ops + sampler.ops, "coll": R.collective_bytes(tally)}


@contextlib.contextmanager
def fake_group(n: int):
    """A default process group of ``n`` ranks, this process rank 0, that
    moves no data (torch's "fake" backend): rank 0's program of a sharded
    step, in one process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one record
# ---------------------------------------------------------------------------

def lower_one(arch: str, shape_name: str, *, mesh: str = "node",
              runtime: str = "retro", gen_headroom: int = 1024,
              verbose: bool = True, moe_groups: int = 0,
              serial_segments: bool = False, distributed: bool = False,
              cluster_cap: int = 0, cfg: Optional[ModelConfig] = None,
              shape: Optional[InputShape] = None) -> Dict:
    """Trace one (arch, shape) step and derive its roofline on ``mesh``.
    ``cfg`` / ``shape`` override the registry's (reduced configs, custom
    shapes). ``runtime``: "retro", "full" or "retro_split" (the hot/cold
    split decode; the attention families only, the others run "retro")."""
    cfg = cfg or get_config(arch)
    if moe_groups and cfg.moe is not None:
        cfg = cfg.replace(moe_dispatch_groups=moe_groups)
    if serial_segments:
        cfg = cfg.replace(retro=dataclasses.replace(
            cfg.retro, serial_prefill_segments=True))
    if cluster_cap:
        cfg = cfg.replace(retro=dataclasses.replace(
            cfg.retro, cluster_cap=cluster_cap))
    shape = shape or INPUT_SHAPES[shape_name]
    msh = MESHES[mesh]()
    chips = msh.size
    split = (runtime == "retro_split" or distributed) \
        and shape.kind == "decode" and cfg.family in M.ATTN_FAMILIES
    sharded = distributed and split
    n_model = msh.shape["model"]
    ran = "retro_split" if split else \
        ("retro" if runtime == "retro_split" else runtime)
    t0 = time.perf_counter()
    batch = input_specs(cfg, shape)
    params = M.param_specs(cfg)
    p_spec = S.param_pspecs(cfg, params, msh)
    if shape.kind == "train":
        ts = trainable(dict(params), grad=False)
        ts = TrainState(params=ts, opt=init_adamw(ts))
        arg_bytes = S.per_device_bytes(ts, S.train_state_pspecs(cfg, ts, msh),
                                       msh)
    else:
        arg_bytes = S.per_device_bytes(params, p_spec, msh)
    arg_bytes += S.per_device_bytes(batch, S.batch_pspecs(cfg, batch, msh),
                                    msh)
    if shape.kind == "decode":
        state = M.serve_state_specs(cfg, shape.global_batch, shape.seq_len,
                                    runtime="retro" if split else ran,
                                    gen_headroom=gen_headroom)
        s_spec = S.serve_state_pspecs(cfg, state, msh, shape.global_batch)
        if sharded:
            s_spec = state._replace(kv=[state_specs_cluster_sharded(st)
                                        for st in state.kv])
        arg_bytes += S.per_device_bytes(state, s_spec, msh)

    def program():
        b = materialize(batch)
        p = materialize(params)
        if shape.kind == "train":
            p = trainable(p)
            step = make_step(cfg, shape, runtime=ran,
                             gen_headroom=gen_headroom)
            return trace_cost(step, TrainState(params=p, opt=init_adamw(p)),
                              b)
        if shape.kind == "prefill":
            step = make_step(cfg, shape, runtime=ran,
                             gen_headroom=gen_headroom)
            return trace_cost(step, p, b)
        if split:
            kv = state.kv
            if sharded:
                kv = [shard_state(st, 0, n_model) for st in kv]
            cold, hot = split_state(materialize(kv))
            step = make_serve_step_split(cfg, shape.seq_len,
                                         gen_headroom=gen_headroom,
                                         group=dist.group.WORLD if sharded
                                         else None)
            return trace_cost(step, p, cold, hot, b["token"])
        step = make_step(cfg, shape, runtime=ran, gen_headroom=gen_headroom)
        return trace_cost(step, p, materialize(state), b["token"])

    with contextlib.ExitStack() as stack:
        if sharded:
            stack.enter_context(fake_group(n_model))
        stack.enter_context(fake_mode())
        cost = program()
    trace_s = time.perf_counter() - t0
    if sharded:
        per_device = f"rank 0 of {n_model} (exact)"
    elif chips == 1:
        per_device = "one device (exact)"
    else:
        per_device = "ideal split"
        cost = {**cost, "flops": cost["flops"] / chips,
                "bytes accessed": cost["bytes accessed"] / chips}
    coll = cost["coll"]
    note = (f"runtime={ran}" + (f";moe_groups={moe_groups}" if moe_groups
                                 else "")
            + (";serial_segments" if serial_segments else "")
            + (";distributed" if sharded else "")
            + (f";cap={cluster_cap}" if cluster_cap else ""))
    rec = R.derive(cfg, shape, mesh_name(msh), chips, cost, coll,
                   note=note).as_dict()
    rec.update({
        "trace_s": round(trace_s, 2), "arg_bytes": arg_bytes,
        "ops": cost["ops"], "per_device": per_device,
        "bytes_kind": "unfused: every op's operands and results",
        "coll_breakdown": {k: v for k, v in coll.items() if v},
        "runtime": ran,
    })
    if verbose:
        print(f"[dryrun] {cfg.arch_id} x {shape.name} x {mesh} ({ran}): OK "
              f"trace={trace_s:.1f}s flops/chip={rec['flops_per_chip']:.3e} "
              f"bytes/chip={rec['bytes_per_chip']:.3e} "
              f"coll/chip={rec['coll_bytes_per_chip']:.3e} "
              f"dominant={rec['dominant']} args/chip="
              f"{arg_bytes / 2**30:.2f}GiB ({per_device})", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="node", choices=list(MESHES),
                    help="h100: one card; node: 8 H100s (data 1 x model 8); "
                         "nodes: two nodes (pod 2 x data 1 x model 8)")
    ap.add_argument("--runtime", default="retro",
                    choices=["retro", "full", "retro_split"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append records to jsonl")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="grouped MoE dispatch (0 = the config's)")
    ap.add_argument("--serial-segments", action="store_true",
                    help="cluster prefill segments one at a time")
    ap.add_argument("--distributed", action="store_true",
                    help="sharded retrieval: decode shapes run the split "
                         "step as rank 0 of the 'model' axis")
    ap.add_argument("--cluster-cap", type=int, default=0,
                    help="override the retro cluster capacity")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    failures = []
    for arch in archs:
        for shape in shapes:
            try:
                rec = lower_one(arch, shape, mesh=args.mesh,
                                runtime=args.runtime,
                                moe_groups=args.moe_groups,
                                serial_segments=args.serial_segments,
                                distributed=args.distributed,
                                cluster_cap=args.cluster_cap)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            except Exception as e:  # noqa: BLE001 — reported, then exit 1
                traceback.print_exc()
                failures.append((arch, shape, args.mesh, str(e)[:200]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
