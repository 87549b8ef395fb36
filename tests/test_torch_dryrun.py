"""The dry-run tools on the CPU (``repro_torch/launch/{roofline,dryrun,
perfcmp}.py``): ``model_flops`` equals the reference's for every arch x
shape, and ``derive``'s arithmetic; ``lower_one`` traces every shape kind of
reduced configs, the split step and the distributed step; the tallied
collective bytes of a distributed decode are exactly 4 * B * Hq * (hd + 2)
a layer (f32 parts: one MAX of m, one SUM of [num | den]); the time-loop
sampler against the real loop (equal FLOPs, bytes within 10% under
autograd on a toy scan; equal bytes without); the CLI writes its records and reports failures;
importing the tools leaves JAX unloaded and XLA_FLAGS unset."""
import contextlib
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import registry as RR
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import roofline as RRoof
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import dryrun, perfcmp
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models import scan_utils

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parents[1] / "src"
SHAPES = {"train": InputShape("t", 256, 2, "train"),
          "prefill": InputShape("p", 320, 2, "prefill"),
          "decode": InputShape("d", 320, 2, "decode")}


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_model_flops_match_reference(shape):
    for arch in ARCH_IDS:
        assert R.model_flops(get_config(arch), INPUT_SHAPES[shape]) == \
            RRoof.model_flops(RR.get_config(arch), REF_SHAPES[shape])


def test_derive_arithmetic():
    cfg, shape = get_config("gemma2_2b"), INPUT_SHAPES["decode_32k"]
    rf = R.derive(cfg, shape, "1x8", 8, {"flops": 2e12,
                                         "bytes accessed": 4e10},
                  R.collective_bytes([("all-reduce", 9e8),
                                      ("all-reduce", 1e8)]))
    assert rf.compute_s == 2e12 / PEAK_FLOPS_BF16
    assert rf.memory_s == 4e10 / HBM_BW
    assert rf.collective_s == 1e9 / NVLINK_BW
    assert rf.dominant == "memory" and rf.coll_bytes_per_chip == 1e9
    assert rf.useful_ratio == R.model_flops(cfg, shape) / (2e12 * 8)
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)


@functools.lru_cache(maxsize=None)
def _lower(arch, kind, mesh="node", **kw):
    """``lower_one`` of reduced ``arch`` at ``SHAPES[kind]`` (each trace
    once in the module)."""
    return dryrun.lower_one(arch, None, cfg=reduced_config(arch),
                            shape=SHAPES[kind], mesh=mesh, verbose=False,
                            **kw)


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ["gemma2_2b", "rwkv6_3b", "whisper_tiny"])
def test_lower_one_reduced(arch, kind):
    rec = _lower(arch, kind)
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert rec["per_device"] == "ideal split" and rec["chips"] == 8
    assert rec["coll_bytes_per_chip"] == 0 and rec["arg_bytes"] > 0


@pytest.mark.parametrize("kind", list(SHAPES))
def test_one_h100_is_the_node_unsplit(kind):
    """The same trace on one H100: the node's ideal split times 8."""
    one, rec = _lower("gemma2_2b", kind, "h100"), _lower("gemma2_2b", kind)
    assert one["flops_per_chip"] == 8 * rec["flops_per_chip"]
    assert one["per_device"] == "one device (exact)"


def test_distributed_collective_bytes():
    """Rank 0 of the node's 'model' axis: per layer one MAX over (B, Hq)
    f32 and one SUM over (B, Hq, hd + 1) f32."""
    cfg = reduced_config("gemma2_2b")
    a, shape = cfg.attn, SHAPES["decode"]
    split = _lower("gemma2_2b", "decode", runtime="retro_split")
    assert split["flops_per_chip"] == _lower("gemma2_2b",
                                             "decode")["flops_per_chip"]
    dist_ = _lower("gemma2_2b", "decode", distributed=True)
    per_layer = 4 * shape.global_batch * a.n_heads * (a.head_dim + 2)
    assert dist_["coll_bytes_per_chip"] == cfg.n_layers * per_layer
    assert dist_["coll_breakdown"] == {"all-reduce": cfg.n_layers * per_layer,
                                       "total": cfg.n_layers * per_layer}
    assert dist_["per_device"] == "rank 0 of 8 (exact)"
    assert dist_["runtime"] == "retro_split"
    assert not torch.distributed.is_initialized()


def test_perfcmp_modes():
    recs = {m: perfcmp.lower_mode("gemma2_2b", "decode_32k", m,
                                  verbose=False) for m in perfcmp.MODES}
    cfg, B = get_config("gemma2_2b"), INPUT_SHAPES["decode_32k"].global_batch
    assert recs["dist"]["coll_bytes_per_chip"] == \
        4 * B * cfg.attn.n_heads * (cfg.attn.head_dim + 2)
    assert recs["full"]["coll_bytes_per_chip"] == 0
    assert recs["baseline"]["bytes_per_chip"] < recs["full"]["bytes_per_chip"]
    assert recs["dist"]["bytes_per_chip"] < recs["baseline"]["bytes_per_chip"]


def _toy_scan(chunk):
    """A recurrence through ``remat_chunked_scan`` (T 32), its grads."""
    S0 = torch.zeros((2, 3, 8, 8))
    d = torch.rand((32, 2, 3, 1, 1), requires_grad=True)
    x = torch.rand((32, 2, 3, 8, 1), requires_grad=True)
    b = torch.rand((32, 2, 3, 1, 8), requires_grad=True)
    c = torch.rand((32, 2, 3, 8, 1), requires_grad=True)
    u = torch.rand((3, 8, 1), requires_grad=True) * 2

    def step(S, inp):
        d_t, x_t, b_t, c_t = inp
        S = torch.addcmul(S * d_t, x_t, b_t)
        return S, torch.matmul(S + u, c_t)

    S, ys = scan_utils.remat_chunked_scan(step, S0, (d, x, b, c),
                                          chunk=chunk)
    torch.autograd.grad(S.sum() + ys.sum(), (d, x, b, c))


@pytest.mark.parametrize("chunk", [8, 256])
def test_scan_sampler_against_the_loop(chunk, monkeypatch):
    """The sampled trace of a chunk-checkpointed (chunk 8) or plain scan
    under autograd against the real loop's."""
    with dryrun.fake_mode():
        sampled = dryrun.trace_cost(_toy_scan, chunk)
        monkeypatch.setattr(dryrun, "sampled_loops", _real_loops)
        exact = dryrun.trace_cost(_toy_scan, chunk)
    assert sampled["flops"] == exact["flops"]
    # the stand-in for the stack of each chunk's outputs is summed in the
    # backward pass (a view in the real loop): 5.5% of this toy's bytes at
    # chunks of 8 steps, under 2% on the reduced recurrent models
    assert abs(sampled["bytes accessed"] / exact["bytes accessed"] - 1) \
        < 0.10


def _real_loops(sampler):
    """Stands in for ``dryrun.sampled_loops``: the real time loop."""
    return contextlib.nullcontext()


def test_scan_sampler_exact_when_serving(monkeypatch):
    cfg = reduced_config("rwkv6_3b")
    shape = InputShape("p", 128, 2, "prefill")
    sampled = dryrun.lower_one("rwkv6_3b", None, cfg=cfg, shape=shape,
                               mesh="h100", verbose=False)
    monkeypatch.setattr(dryrun, "sampled_loops", _real_loops)
    exact = dryrun.lower_one("rwkv6_3b", None, cfg=cfg, shape=shape,
                             mesh="h100", verbose=False)
    for k in ("flops_per_chip", "bytes_per_chip"):
        assert sampled[k] == exact[k], k


def test_cli_records_and_failures(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "whisper_tiny", "--shape", "decode_32k",
                 "--mesh", "nodes", "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["mesh"] == "2x1x8" and rec["chips"] == 16
    assert rec["bytes_kind"].startswith("unfused")
    assert "ALL DRY-RUNS PASSED" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no_such_arch", "--shape", "decode_32k"])
    assert e.value.code == 1 and "1 FAILURES" in capsys.readouterr().out


def test_tools_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(SRC)
    code = ("import os, sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.perfcmp\n"
            "import repro_torch.serving.steps, repro_torch.core.distributed\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "assert 'XLA_FLAGS' not in os.environ\n"
            "print('NO_JAX')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert "NO_JAX" in out.stdout, out.stderr[-2000:]
