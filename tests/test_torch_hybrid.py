"""The hybrid family (zamba2: mamba2 blocks and one shared attention block)
against the JAX package, f32, both on the CPU from the same numpy
parameters. The config is reduced zamba2-1.2b with 5 layers and the shared
block after every second (sites 1 and 3, then a one-block mamba tail), and
a 32-token update segment so a short decode crosses a flush.

Held: ``mamba2.layer_apply_seq(return_state=True)`` and
``layer_decode_step``; the prefill under both runtimes (logits, every
mamba state, every site's WaveState or DenseCache); decode steps under
``jnp``, the ``fused`` / ``pallas`` twins and the full runtime, each against
the reference's ``jnp`` / full step; a run across the update segment, where
``flush_state`` flushes every site's index; and the ``fused`` twin against
the reference's interpreted paged kernel (the file's one interpret-mode
case).

Tolerance: logits, stores and the conv history within 1e-5 (1 + |ref|);
integer leaves equal; the recurrent ``ssm`` state within 1e-6 (1 + max
|ref|) of its layer (its rounding noise is absolute, as in
``test_torch_rwkv6.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zamba2_1p2b as ref_zamba
from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import hybrid as RH
from repro.models import mamba2 as RMB
from repro.models import model as RM
from repro_torch.configs import zamba2_1p2b
from repro_torch.core.zones import plan_zones
from repro_torch.interop import (params_from_numpy, serve_state_from_numpy,
                                 serve_state_to_numpy)
from repro_torch.models import hybrid, mamba2
from repro_torch.models import model as M

torch.set_num_threads(2)
RTOL, STATE_TOL = 1e-5, 1e-6
T, HEADROOM = 96, 64
RECURRENT = ("ssm",)


def _cfg(c):
    return c.replace(n_layers=5, shared_attn_every=2, retro=dataclasses.replace(
        c.retro, update_segment=32, local=16))


def ref_tree(x):
    """A reference state as nested dicts of numpy arrays by field."""
    if hasattr(x, "_fields"):
        return {f: ref_tree(getattr(x, f)) for f in x._fields}
    return np.asarray(x)


def assert_close(got, want, what, recurrent=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    if recurrent:
        d = np.abs(got - want).reshape(len(want), -1).max(-1)
        err = (d / (1 + np.abs(want).reshape(len(want), -1).max(-1))).max()
        assert err <= STATE_TOL, f"{what}: {err:.3e}"
    else:
        err = (np.abs(got - want) / (1 + np.abs(want))).max()
        assert err <= RTOL, f"{what}: {err:.3e}"


def assert_tree(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree(got[k], want[k], f"{what}.{k}")
        return
    assert_close(got, want, what, recurrent=what.endswith(RECURRENT))


@pytest.fixture(scope="module")
def models():
    ref_cfg, cfg = _cfg(ref_zamba.reduced()), _cfg(zamba2_1p2b.reduced())
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(5))
    return ref_cfg, ref_params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")


def _tokens(vocab, seed, shape=(2, T)):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def test_sites_and_layout(models):
    _, _, cfg, params = models
    assert hybrid.attn_sites(cfg) == RH.attn_sites(models[0]) == [1, 3]
    assert hybrid.attn_sites(zamba2_1p2b.CONFIG) == \
        RH.attn_sites(ref_zamba.CONFIG) == [5, 11, 17, 23, 29, 35]
    assert len(params["layers"]) == 5 and "shared" in params
    st = M.make_serve_state(cfg, 2, T, gen_headroom=HEADROOM, zero_fill=True,
                            device="cpu")
    ref_st = RM.make_serve_state(models[0], 2, T, gen_headroom=HEADROOM,
                                 zero_fill=True)
    assert jax.tree.map(np.shape, serve_state_to_numpy(st)) == \
        jax.tree.map(np.shape, ref_tree(ref_st))


def test_mamba2_layer_matches_reference(models):
    """A whole sequence with its final state, then four decode steps from
    that state."""
    ref_cfg, ref_params, cfg, params = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    ref_lp = jax.tree.map(lambda a: a[2], ref_params["layers"])
    lp = params["layers"][2]
    ref_out, ref_st = RMB.layer_apply_seq(ref_lp, ref_cfg, jnp.asarray(x),
                                          return_state=True)
    out, st = mamba2.layer_apply_seq(lp, cfg, torch.from_numpy(x),
                                     return_state=True)
    assert_close(out.numpy(), ref_out, "sequence output")
    assert_tree(serve_state_to_numpy([st]),
                ref_tree(jax.tree.map(lambda a: a[None], ref_st)), "state")
    for t in range(4):
        xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        ref_out, ref_st = RMB.layer_decode_step(ref_lp, ref_cfg, ref_st,
                                                jnp.asarray(xt))
        out, st2 = mamba2.layer_decode_step(lp, cfg, st, torch.from_numpy(xt))
        assert st2 is st
        assert_close(out.numpy(), ref_out, f"step {t}")
        assert_tree(serve_state_to_numpy([st]),
                    ref_tree(jax.tree.map(lambda a: a[None], ref_st)),
                    f"step {t} state")


def test_short_prompt_conv_history_is_zero_padded(models):
    """Fewer tokens than the conv's history: the history is the tokens'
    inputs after zeros (``conv_kernel - 1`` rows)."""
    _, _, cfg, params = models
    x = torch.randn((1, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    _, st = mamba2.layer_apply_seq(params["layers"][0], cfg, x,
                                   return_state=True)
    assert st.conv.shape == (1, 3, st.conv.shape[-1])
    assert not st.conv[:, :2].any() and st.conv[:, 2].any()


@functools.lru_cache(maxsize=None)
def _ref_prefill(runtime):
    ref_cfg = _cfg(ref_zamba.reduced())
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(5))
    plan = ref_plan_zones(T, ref_cfg.retro, HEADROOM)
    return jax.jit(functools.partial(
        RH.prefill, cfg=ref_cfg, runtime=runtime, plan=plan,
        gen_headroom=HEADROOM))(ref_params, tokens=jnp.asarray(
            _tokens(ref_cfg.vocab, 1)))


@pytest.mark.parametrize("runtime", ["retro", "full"])
def test_prefill_matches_reference(models, runtime):
    _, _, cfg, params = models
    ref_lg, ref_st = _ref_prefill(runtime)
    lg, st = M.apply_prefill(
        params, cfg, {"tokens": torch.from_numpy(_tokens(cfg.vocab, 1))},
        runtime=runtime, plan=plan_zones(T, cfg.retro, HEADROOM),
        gen_headroom=HEADROOM)
    assert_close(lg.numpy(), ref_lg, "logits")
    assert len(st.mamba) == 5 and len(st.attn_kv) == 2
    assert_tree(serve_state_to_numpy(st), ref_tree(ref_st), "state")


def _decode(models, runtime, impl, ref_impl, steps, flush_at=None):
    """The port and the reference decode ``steps`` tokens, each from its
    own prefill state; at step ``flush_at`` both flush every site."""
    ref_cfg, ref_params, cfg, params = models
    _, ref_st = _ref_prefill(runtime)
    _, st = M.apply_prefill(
        params, cfg, {"tokens": torch.from_numpy(_tokens(cfg.vocab, 1))},
        runtime=runtime, plan=plan_zones(T, cfg.retro, HEADROOM),
        gen_headroom=HEADROOM)
    dec = jax.jit(functools.partial(
        RH.decode_step, cfg=ref_cfg, runtime=runtime,
        plan=ref_plan_zones(T, ref_cfg.retro, HEADROOM), attn_impl=ref_impl))
    plan = plan_zones(T, cfg.retro, HEADROOM)
    ptrs = [t.data_ptr() for t in jax.tree.leaves(
        st, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    rng = np.random.default_rng(3)
    for t in range(steps):
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        ref_lg, ref_st = dec(ref_params, state=ref_st, token=jnp.asarray(tok))
        lg, st = M.apply_decode(params, cfg, st, torch.from_numpy(tok),
                                runtime=runtime, plan=plan, attn_impl=impl)
        assert_close(lg.numpy(), ref_lg, f"step {t} logits")
        if t == flush_at:
            ref_st = RM.flush_state(ref_cfg, ref_st, runtime=runtime)
            st = M.flush_state(cfg, st, runtime=runtime)
    assert [t.data_ptr() for t in jax.tree.leaves(
        st, is_leaf=lambda x: isinstance(x, torch.Tensor))] == ptrs
    assert_tree(serve_state_to_numpy(st), ref_tree(ref_st), "state")
    return st


DECODE_CASES = {"jnp": ("retro", "jnp"), "fused": ("retro", "fused"),
                "pallas": ("retro", "pallas"), "full": ("full", "jnp")}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_reference(models, case):
    """Four steps; the twins against the reference's plain step."""
    runtime, impl = DECODE_CASES[case]
    _decode(models, runtime, impl, "jnp", 4)


def test_decode_across_a_flush(models):
    """Prefill leaves 16 tokens in each site's staging buffer; the 32nd
    step fills it (48 = local + update segment), and ``flush_state``
    clusters the oldest 32 of every site: the clusters, the slid buffer and
    the counters equal the reference's, and decoding goes on equal."""
    st = _decode(models, "retro", "jnp", "jnp", 36, flush_at=31)
    for kst in st.attn_kv:
        assert kst.local_len.tolist() == [20, 20]
        assert kst.length.tolist() == [T + 36] * 2


def test_fused_twin_matches_interpreted_kernel(models):
    """The paged kernel's twin at G 1 against the reference's interpreted
    Pallas kernel, two steps."""
    _decode(models, "retro", "fused", "fused", 2)


def test_state_carried_from_numpy(models):
    """The reference's prefill state through ``serve_state_from_numpy``
    decodes as the reference's does."""
    ref_cfg, ref_params, cfg, params = models
    ref_lg, ref_st = _ref_prefill("retro")
    st = serve_state_from_numpy(jax.tree.map(
        np.asarray, ref_tree(ref_st)), "cpu")
    tok = np.array([3, 4], np.int32)
    ref_lg, ref_st = RH.decode_step(ref_params, ref_cfg, ref_st,
                                    jnp.asarray(tok),
                                    plan=ref_plan_zones(T, ref_cfg.retro,
                                                        HEADROOM))
    lg, st = hybrid.decode_step(params, cfg, st, torch.from_numpy(tok),
                                plan=plan_zones(T, cfg.retro, HEADROOM))
    assert_close(lg.numpy(), ref_lg, "logits")
    assert_tree(serve_state_to_numpy(st), ref_tree(ref_st), "state")
