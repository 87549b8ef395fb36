"""``serving/steps.py`` and its helpers against the JAX package, on the CPU:
the configs' parameter counts and the input specs (shapes and dtypes) for
every arch x shape; ``param_specs`` leaf for leaf for every arch and
``serve_state_specs`` for the reference's sharding-test archs (the
reference's stacked ``(L, ...)`` leaves against the port's per-layer
lists); ``materialize_batch``'s shapes, dtypes and ranges; the prefill,
serve (with a slot mask) and train steps of ``make_step`` on reduced
gemma2-2b and rwkv6 from the same numpy parameters; and the hot/cold split
decode against the port's monolithic step and the reference's split step,
under "jnp" and "fused" (its plain twin on the CPU), with the cold tensors
left bit-identical.

Tolerances (f32, reduced configs): logits within 1e-4 (atol and rtol, the
reference's own bound for the split step, ``tests/test_system.py:519-533``);
the train step's loss and grad norm within 1e-5 (1 + |ref|); the split
step against the port's monolithic step: equal bits (the same ops in the
same order).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as RB
from repro.configs import registry as RR
from repro.models import model as RM
from repro.models import transformer as RT
from repro.serving import steps as RS
from repro.training.optimizer import init_adamw
from repro.training.train_loop import TrainState as RefTrainState
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import (ARCH_IDS, all_configs, get_config,
                                          input_specs, materialize_batch,
                                          reduced_config)
from repro_torch.core.zones import plan_zones
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import model as M
from repro_torch.models import transformer as PT
from repro_torch.serving import steps as S

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_ARCHS = ("gemma2_2b", "kimi_k2_1t_a32b", "rwkv6_3b", "zamba2_1p2b",
               "whisper_tiny")                 # tests/test_sharding.py:54-56


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def assert_same_tree(port, ref, stacked=False, path=""):
    """Shapes and dtypes of a port tree against the reference's: a port
    list stands for a reference node whose leaves stack it on a leading
    dim (layers, sites), which is dropped for the comparison."""
    if isinstance(port, list):
        for i, item in enumerate(port):
            assert_same_tree(item, ref, True, f"{path}[{i}]")
        return
    if hasattr(port, "_fields"):
        assert port._fields == ref._fields, path
        for f in port._fields:
            assert_same_tree(getattr(port, f), getattr(ref, f), stacked,
                             f"{path}.{f}")
        return
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            assert_same_tree(port[k], ref[k], stacked, f"{path}.{k}")
        return
    want = tuple(ref.shape[1:] if stacked else ref.shape)
    if isinstance(port, float):                  # per-layer window
        assert want == () and ref.dtype == jnp.float32, path
        return
    assert tuple(port.shape) == want, (path, port.shape, want)
    assert _dtype_name(port.dtype) == str(ref.dtype), (path, port.dtype,
                                                       ref.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    cfg, ref = get_config(arch), RR.get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert set(all_configs()) == set(RR.ARCH_IDS) == set(ARCH_IDS)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_input_specs_match_reference(shape):
    assert INPUT_SHAPES[shape] == InputShape(
        **vars(RB.INPUT_SHAPES[shape]))
    for arch in ARCH_IDS:
        got = input_specs(get_config(arch), INPUT_SHAPES[shape])
        want = RR.input_specs(RR.get_config(arch), RB.INPUT_SHAPES[shape])
        assert sorted(got) == sorted(want), arch
        for k, t in got.items():
            assert t.is_meta, (arch, k)
            assert tuple(t.shape) == want[k].shape, (arch, k)
            assert _dtype_name(t.dtype) == str(want[k].dtype), (arch, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    got = M.param_specs(get_config(arch))
    assert all(t.is_meta for t in _tensors(got))
    assert_same_tree(got, RM.param_specs(RR.get_config(arch)))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_serve_state_specs_match_reference(arch, shape):
    sh = INPUT_SHAPES[shape]
    got = M.serve_state_specs(get_config(arch), sh.global_batch, sh.seq_len,
                              runtime="retro", gen_headroom=1024)
    want = RM.serve_state_specs(RR.get_config(arch), sh.global_batch,
                                sh.seq_len, runtime="retro",
                                gen_headroom=1024)
    assert_same_tree(got, want)


def test_materialize_batch_shapes_and_ranges():
    for arch in ("gemma2_2b", "llava_next_34b", "whisper_tiny"):
        cfg = reduced_config(arch)
        for shape in (InputShape("t", 64, 2, "train"),
                      InputShape("d", 64, 3, "decode")):
            gen = torch.Generator().manual_seed(1)
            batch = materialize_batch(cfg, shape, gen, device="cpu")
            specs = input_specs(cfg, shape)
            assert sorted(batch) == sorted(specs)
            for k, t in batch.items():
                assert t.shape == specs[k].shape and t.dtype == \
                    specs[k].dtype and t.device.type == "cpu"
                if not t.dtype.is_floating_point:
                    assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab
                else:
                    assert torch.isfinite(t).all() and t.std() > 0.5
            again = materialize_batch(cfg, shape,
                                      torch.Generator().manual_seed(1),
                                      device="cpu")
            assert all(torch.equal(batch[k], again[k]) for k in batch)


# ---------------------------------------------------------------------------
# the step functions against the reference's, reduced configs
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Reduced ``arch`` in both packages, the same weights (the reference's
    initializer, compiled once for the module). The reference's steps are
    compiled (``jax.jit``) wherever they are called here, as its launcher
    does."""
    ref_cfg, cfg = RR.reduced_config(arch), reduced_config(arch)
    ref_params = jax.jit(lambda k: RM.init_params(ref_cfg, k))(
        jax.random.PRNGKey(0))
    return arch, ref_cfg, ref_params, cfg, \
        params_from_numpy(_np_tree(ref_params), cfg, "cpu")


@pytest.fixture(scope="module", params=["gemma2_2b", "rwkv6_3b"])
def models(request):
    return _model(request.param)


def test_prefill_and_serve_steps_match_reference(models):
    """``make_step``'s prefill step, then three serve steps (the second
    with slot 1 free) from its state."""
    arch, ref_cfg, ref_params, cfg, params = models
    T = 320
    shape = InputShape("p", T, 2, "prefill")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, T)) \
        .astype(np.int32)
    ref_lg, ref_st = jax.jit(RS.make_step(
        ref_cfg, RB.InputShape(**vars(shape)), gen_headroom=256))(
        ref_params, {"tokens": jnp.asarray(toks)})
    lg, st = S.make_step(cfg, shape, gen_headroom=256)(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)
    ref_step = jax.jit(RS.make_serve_step(ref_cfg, T, gen_headroom=256))
    step = S.make_serve_step(cfg, T, gen_headroom=256)
    tok = np.argmax(np.asarray(ref_lg), -1).astype(np.int32)
    for i in range(3):
        active = np.array([True, i != 1])
        ref_lg, ref_st = ref_step(ref_params, ref_st, jnp.asarray(tok),
                                  jnp.asarray(active))
        lg, st = step(params, st, torch.from_numpy(tok),
                      torch.from_numpy(active))
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL,
                                   err_msg=f"{arch} step {i}")
        tok = np.argmax(np.asarray(ref_lg), -1).astype(np.int32)


def test_train_step_matches_reference(models):
    arch, ref_cfg, ref_params, cfg, _ = models
    shape = InputShape("t", 64, 2, "train")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
             for k in ("tokens", "targets")}
    ref_ts = RefTrainState(params=ref_params, opt=init_adamw(ref_params))
    ts = train_state_from_numpy(_np_tree(ref_ts), cfg, "cpu")
    _, ref_m = jax.jit(RS.make_step(ref_cfg, RB.InputShape(**vars(shape))))(
        ref_ts, {k: jnp.asarray(v) for k, v in batch.items()})
    _, m = S.make_step(cfg, shape)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        ref = float(ref_m[k])
        assert abs(float(m[k]) - ref) <= 1e-5 * (1 + abs(ref)), (arch, k)


def test_split_step_refuses_other_families():
    with pytest.raises(ValueError, match="attention family"):
        S.make_serve_step_split(reduced_config("rwkv6_3b"), 320)


@pytest.fixture(scope="module")
def gemma():
    return _model("gemma2_2b")[1:]


def _with_impl(cfg, impl):
    return cfg.replace(retro=cfg.retro.__class__(
        **{**vars(cfg.retro), "attn_impl": impl}))


SPLIT_T = 320


def _split_tokens(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab, (2, SPLIT_T)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def gemma_prefill(gemma):
    """The reference's prefilled state of ``_split_tokens`` (shared by the
    split cases)."""
    ref_cfg, ref_params, cfg, _ = gemma
    return jax.jit(RS.make_prefill_step(ref_cfg, SPLIT_T, gen_headroom=256))(
        ref_params, {"tokens": jnp.asarray(_split_tokens(cfg))})[1]


@pytest.mark.parametrize("impl", ["jnp", "fused"])
def test_split_decode_matches_monolithic_and_reference(gemma, gemma_prefill,
                                                       impl):
    """Three steps of ``make_serve_step_split`` from a prefilled state:
    equal to the port's monolithic step, within 1e-4 of the reference's
    ``decode_step_split``; the cold tensors are never written."""
    ref_cfg, ref_params, cfg, params = gemma
    cfg = _with_impl(cfg, impl)
    T, toks = SPLIT_T, _split_tokens(cfg)
    pre = S.make_prefill_step(cfg, T, gen_headroom=256)
    _, st_split = pre(params, {"tokens": torch.from_numpy(toks)})
    _, st_mono = pre(params, {"tokens": torch.from_numpy(toks)})
    ref_plan = RS.plan_zones(T, ref_cfg.retro, 256)
    ref_cold, ref_hot = RT.split_state(gemma_prefill.kv)
    ref_split = jax.jit(lambda p, c, h, t: RT.decode_step_split(
        p, ref_cfg, c, h, t, plan=ref_plan, attn_impl=impl))
    cold, hot = PT.split_state(st_split.kv)
    before = [{k: v.clone() for k, v in c.items()} for c in cold]
    split = S.make_serve_step_split(cfg, T, gen_headroom=256)
    mono = S.make_serve_step(cfg, T, gen_headroom=256)
    tok = np.zeros((2,), np.int32)
    for i in range(3):
        lg_s, hot = split(params, cold, hot, torch.from_numpy(tok))
        lg_m, st_mono = mono(params, st_mono, torch.from_numpy(tok))
        ref_lg, ref_hot = ref_split(ref_params, ref_cold, ref_hot,
                                    jnp.asarray(tok))
        assert torch.equal(lg_s, lg_m), f"step {i}"
        np.testing.assert_allclose(lg_s.numpy(), np.asarray(ref_lg), **TOL,
                                   err_msg=f"step {i}")
        tok = np.argmax(np.asarray(ref_lg), -1).astype(np.int32)
    for c, b in zip(cold, before):
        for k in c:
            assert torch.equal(c[k], b[k]), k
    for h, st in zip(hot, st_mono.kv):
        for k in PT.HOT_FIELDS:
            assert torch.equal(h[k], getattr(st, k)), k
    assert PT.join_state(cold[0], hot[0]).length.tolist() == [T + 3] * 2



def test_split_step_over_a_world_1_group(gemma, tmp_path):
    """``make_serve_step_split(group=...)`` over a world-1 gloo group (the
    sharded retrieval path, every cluster on rank 0): three steps within
    1e-4 of the monolithic step, the cold tensors never written; a kernel
    impl beside a group raises, at build time and in the step."""
    _, _, cfg, params = gemma
    cfg = _with_impl(cfg, "jnp")
    T = 320
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, T)) \
        .astype(np.int32)
    pre = S.make_prefill_step(cfg, T, gen_headroom=256)
    _, st_split = pre(params, {"tokens": torch.from_numpy(toks)})
    _, st_mono = pre(params, {"tokens": torch.from_numpy(toks)})
    cold, hot = PT.split_state(st_split.kv)
    before = [{k: v.clone() for k, v in c.items()} for c in cold]
    mono = S.make_serve_step(cfg, T, gen_headroom=256)
    dist.init_process_group("gloo", init_method="file://"
                            + os.path.join(tmp_path, "rdv"), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        split = S.make_serve_step_split(cfg, T, gen_headroom=256, group=group)
        tok = np.zeros((2,), np.int32)
        for i in range(3):
            lg_s, hot = split(params, cold, hot, torch.from_numpy(tok))
            lg_m, st_mono = mono(params, st_mono, torch.from_numpy(tok))
            np.testing.assert_allclose(lg_s.numpy(), lg_m.numpy(), **TOL,
                                       err_msg=f"step {i}")
            tok = lg_m.argmax(-1).to(torch.int32).numpy()
        with pytest.raises(ValueError, match="'jnp'"):
            S.make_serve_step_split(_with_impl(cfg, "fused"), T,
                                    gen_headroom=256, group=group)
        with pytest.raises(ValueError, match="'jnp'"):
            PT.decode_step_split(params, cfg, cold, hot,
                                 torch.from_numpy(tok), plan=plan_zones(T, cfg.retro, 256),
                                 group=group, attn_impl="fused")
    finally:
        dist.destroy_process_group()
    for c, b in zip(cold, before):
        for k in c:
            assert torch.equal(c[k], b[k]), k
