"""The port's sharding rules (``repro_torch/launch/sharding.py``) against the
reference's on the CPU: every parameter spec of every arch and the serve
state specs of the reference's sharding-test archs equal the reference's
with the leading (layer) entry dropped, on the reference's meshes (16 x 16
and 2 x 16 x 16, shape-only) and on the port's H100 meshes (1 x 8 and
2 x 1 x 8); every split divides its dim; ``batch_axes``; experts on
'model' or the d_ff fallback; moments following their parameter; a
device's share of the bytes; DTensor placements."""
import functools

import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as RR
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import sharding as RS
from repro.models import model as RM
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import mesh as PM
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models import model as M
from repro_torch.training.optimizer import init_adamw
from repro_torch.training.train_loop import TrainState, trainable


class FakeMesh:
    """Shape-only stand-in for the reference's rules (tests/test_sharding.py)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x8": PM.make_production_mesh().shape,
          "2x1x8": PM.make_production_mesh(multi_node=True).shape}
STATE_ARCHS = ("gemma2_2b", "kimi_k2_1t_a32b", "rwkv6_3b", "zamba2_1p2b",
               "whisper_tiny")


def _norm(spec):
    """jax's PartitionSpec writes a one-axis tuple as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def assert_specs(port, ref, leaves, mesh, stacked=False, path=""):
    """A port spec tree against the reference's (a port list stands for
    a stacked reference node: its specs lose their leading entry), and
    every split of the port's divides its dim of ``leaves``."""
    if isinstance(port, list):
        for i, (item, leaf) in enumerate(zip(port, leaves)):
            assert_specs(item, ref, leaf, mesh, True, f"{path}[{i}]")
        return
    if hasattr(port, "_fields") and not isinstance(port, P):
        for f in port._fields:
            assert_specs(getattr(port, f), getattr(ref, f),
                         getattr(leaves, f), mesh, stacked, f"{path}.{f}")
        return
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            assert_specs(port[k], ref[k], leaves[k], mesh, stacked,
                         f"{path}.{k}")
        return
    want = tuple(ref)[1:] if stacked else tuple(ref)
    if isinstance(leaves, float):                 # a layer's window: ()
        want = ()
    assert isinstance(port, P), path
    assert _norm(port) == _norm(want), (path, port, want)
    for dim, ax in enumerate(port):
        n = 1
        for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
            n *= mesh.shape[a]
        assert leaves.shape[dim] % n == 0, (path, port, leaves.shape)


@functools.lru_cache(maxsize=None)
def _param_specs(arch):
    """Both packages' config and parameter specs of ``arch`` (each tree
    built once for the module's meshes)."""
    cfg, ref_cfg = get_config(arch), RR.get_config(arch)
    return cfg, M.param_specs(cfg), ref_cfg, RM.param_specs(ref_cfg)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    shape = MESHES[mesh]
    cfg, params, ref_cfg, ref_params = _param_specs(arch)
    got = S.param_pspecs(cfg, params, PM.Mesh(shape))
    want = RS.param_pspecs(ref_cfg, ref_params, FakeMesh(shape))
    assert_specs(got, want, params, PM.Mesh(shape))


@pytest.mark.parametrize("mesh", ["16x16", "1x8"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_serve_state_specs_match_reference(arch, shape_name, mesh):
    shape, sh = MESHES[mesh], INPUT_SHAPES[shape_name]
    state = M.serve_state_specs(get_config(arch), sh.global_batch,
                                sh.seq_len, runtime="retro",
                                gen_headroom=1024)
    got = S.serve_state_pspecs(get_config(arch), state, PM.Mesh(shape),
                               sh.global_batch)
    ref_cfg = RR.get_config(arch)
    rs = REF_SHAPES[shape_name]
    want = RS.serve_state_pspecs(
        ref_cfg, RM.serve_state_specs(ref_cfg, rs.global_batch, rs.seq_len,
                                      runtime="retro", gen_headroom=1024),
        FakeMesh(shape), rs.global_batch)
    assert_specs(got, want, state, PM.Mesh(shape))


def test_batch_axes_fallback():
    for shape in MESHES.values():
        for B in (256, 16, 3, 1, 2):
            assert S.batch_axes(PM.Mesh(shape), B) \
                == RS.batch_axes(FakeMesh(shape), B), (shape, B)
    node, nodes = PM.make_production_mesh(), \
        PM.make_production_mesh(multi_node=True)
    assert S.batch_axes(node, 1) == ("data",)
    assert S.batch_axes(nodes, 2) == ("pod", "data")
    assert S.batch_axes(nodes, 1) == ("data",)


def test_moe_expert_vs_ff_sharding():
    kimi, mix = get_config("kimi_k2_1t_a32b"), get_config("mixtral_8x22b")
    wide = PM.Mesh(MESHES["16x16"])
    pk = S.param_pspecs(kimi, M.param_specs(kimi), wide)
    pm = S.param_pspecs(mix, M.param_specs(mix), wide)
    assert pk["layers"][0]["moe"]["w_gate"] == P("model", None, None)
    assert pm["layers"][0]["moe"]["w_gate"] == P(None, None, "model")
    assert pm["layers"][0]["moe"]["w_down"] == P(None, "model", None)
    # one node: mixtral's 8 experts divide the 8-way model axis
    pn = S.param_pspecs(mix, M.param_specs(mix), PM.make_production_mesh())
    assert pn["layers"][0]["moe"]["w_gate"] == P("model", None, None)


def test_moments_follow_params_and_bytes_split():
    cfg = get_config("gemma2_2b")
    mesh = PM.make_production_mesh()
    params = trainable(M.param_specs(cfg), grad=False)
    ts = TrainState(params=params, opt=init_adamw(params))
    spec = S.train_state_pspecs(cfg, ts, mesh)
    assert spec.opt.mu == spec.params and spec.opt.nu == spec.params
    assert spec.params["window"] == P()
    full = sum(t.numel() * t.element_size()
               for t in [params["embed"], params["final_norm"]])
    one = S.per_device_bytes({"embed": params["embed"],
                              "final_norm": params["final_norm"]},
                             {"embed": spec.params["embed"],
                              "final_norm": spec.params["final_norm"]}, mesh)
    e = params["embed"]
    assert one == e.numel() * e.element_size() / 8 \
        + params["final_norm"].numel() * 2
    assert one < full


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh2:
        mesh_dim_names = ("pod", "data", "model")

    assert S.to_placements(P(("pod", "data"), None, "model"), Mesh2()) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.to_placements(P(), Mesh2()) == (Replicate(),) * 3
    assert S.to_placements(P(None, "model"), Mesh2()) == \
        (Replicate(), Replicate(), Shard(1))


def test_device_mesh_of_one_rank(tmp_path):
    """``make_device_mesh`` over a world-1 gloo group, and a spec's
    placements on it."""
    from torch.distributed.tensor import Replicate, Shard
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
        world_size=1)
    try:
        dm = PM.make_device_mesh(PM.Mesh({"data": 1, "model": 1}), "cpu")
        assert dm.mesh_dim_names == ("data", "model")
        assert S.to_placements(P(None, "model"), dm) == (Replicate(),
                                                         Shard(1))
    finally:
        torch.distributed.destroy_process_group()


def test_production_meshes():
    assert PM.make_production_mesh().shape == {"data": 1, "model": 8}
    assert PM.make_production_mesh(multi_node=True).shape == \
        {"pod": 2, "data": 1, "model": 8}
    assert PM.make_production_mesh(multi_node=True).size == 16
    assert jnp.dtype("bfloat16")                   # both packages load
