"""The audio family (whisper: an encoder over stub frame embeddings and a
decoder with self- and cross-attention) against the JAX package, f32,
both on the CPU from the same numpy parameters, on reduced whisper-tiny
(64 frames) with a 32-token update segment.

Held: ``encode`` (sinusoidal positions and RoPE, non-causal), ``_cross_kv``,
``sinusoidal_positions``, the prefill under both runtimes (logits, every
decoder layer's WaveState or DenseCache, the cross K/V), decode steps under
``jnp``, the ``fused`` / ``pallas`` twins and the full runtime against the
reference's plain step, a run across the update segment, where
``flush_state`` flushes ``self_kv``, and the ``pallas`` twin against the
reference's interpreted gathered-buffer kernel (the file's one
interpret-mode case).

Tolerance: f32 within 1e-5 (1 + |ref|); integer leaves equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_tiny as ref_whisper
from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import whisper_tiny
from repro_torch.core.zones import plan_zones
from repro_torch.interop import (params_from_numpy, serve_state_from_numpy,
                                 serve_state_to_numpy)
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import model as M

torch.set_num_threads(2)
RTOL = 1e-5
T, HEADROOM = 96, 64


def _cfg(c):
    return c.replace(retro=dataclasses.replace(c.retro, update_segment=32,
                                               local=16))


def ref_tree(x):
    """A reference state as nested dicts of numpy arrays by field."""
    if hasattr(x, "_fields"):
        return {f: ref_tree(getattr(x, f)) for f in x._fields}
    return np.asarray(x)


def assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    err = (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err <= RTOL, f"{what}: {err:.3e}"


def assert_tree(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree(got[k], want[k], f"{what}.{k}")
        return
    assert_close(got, want, what)


@pytest.fixture(scope="module")
def models():
    ref_cfg, cfg = _cfg(ref_whisper.reduced()), _cfg(whisper_tiny.reduced())
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(6))
    return ref_cfg, ref_params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, T)).astype(np.int32)
    frames = rng.standard_normal((2, cfg.encoder_frames, cfg.d_model)) \
        .astype(np.float32)
    return toks, frames


@pytest.mark.parametrize("n", [64, 1500])
def test_sinusoidal_positions_match(n):
    """Both packages compute the table in f32 with the same ops, and their
    f32 ``exp`` and ``sin`` differ in the last place, which an argument of
    size up to n - 1 turns into an absolute error of about its f32 ulp:
    entries agree within two ulps of n - 1 (7.6e-6 at the reduced
    config's 64 frames, 2.4e-4 at whisper's 1500)."""
    atol = 2 * float(np.spacing(np.float32(n - 1)))
    np.testing.assert_allclose(L.sinusoidal_positions(n, 384).numpy(),
                               np.asarray(RL.sinusoidal_positions(n, 384)),
                               rtol=0, atol=atol)


def test_layer_norm_matches():
    x = np.random.default_rng(0).standard_normal((3, 48)).astype(np.float32)
    g, b = np.linspace(0.5, 1.5, 48, dtype=np.float32), \
        np.linspace(-1, 1, 48, dtype=np.float32)
    assert_close(L.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
                 .numpy(), RL.layer_norm(x, g, b), "layer_norm")


def test_encode_and_cross_kv_match(models):
    ref_cfg, ref_params, cfg, params = models
    _, frames = _inputs(cfg)
    ref_enc = RE.encode(ref_params, ref_cfg, jnp.asarray(frames))
    enc = encdec.encode(params, cfg, torch.from_numpy(frames))
    assert_close(enc.numpy(), ref_enc, "encoder output")
    ref_k, ref_v = RE._cross_kv(ref_params, ref_cfg, ref_enc)
    k, v = encdec._cross_kv(params, cfg, enc)
    assert_close(np.stack([t.numpy() for t in k]), ref_k, "cross k")
    assert_close(np.stack([t.numpy() for t in v]), ref_v, "cross v")


@functools.lru_cache(maxsize=None)
def _ref_prefill(runtime):
    ref_cfg = _cfg(ref_whisper.reduced())
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(6))
    toks, frames = _inputs(ref_cfg)
    return jax.jit(functools.partial(
        RE.prefill, cfg=ref_cfg, runtime=runtime,
        plan=ref_plan_zones(T, ref_cfg.retro, HEADROOM),
        gen_headroom=HEADROOM))(ref_params, tokens=jnp.asarray(toks),
                                frames=jnp.asarray(frames))


def _prefill(models, runtime):
    _, _, cfg, params = models
    toks, frames = _inputs(cfg)
    return M.apply_prefill(params, cfg, {"tokens": torch.from_numpy(toks),
                                         "frames": torch.from_numpy(frames)},
                           runtime=runtime,
                           plan=plan_zones(T, cfg.retro, HEADROOM),
                           gen_headroom=HEADROOM)


@pytest.mark.parametrize("runtime", ["retro", "full"])
def test_prefill_matches_reference(models, runtime):
    ref_lg, ref_st = _ref_prefill(runtime)
    lg, st = _prefill(models, runtime)
    assert_close(lg.numpy(), ref_lg, "logits")
    assert_tree(serve_state_to_numpy(st), ref_tree(ref_st), "state")


def _decode(models, runtime, impl, ref_impl, steps, flush_at=None):
    ref_cfg, ref_params, cfg, params = models
    _, ref_st = _ref_prefill(runtime)
    _, st = _prefill(models, runtime)
    dec = jax.jit(functools.partial(
        RE.decode_step, cfg=ref_cfg, runtime=runtime,
        plan=ref_plan_zones(T, ref_cfg.retro, HEADROOM), attn_impl=ref_impl))
    plan = plan_zones(T, cfg.retro, HEADROOM)
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
    assert_tree(serve_state_to_numpy(st), ref_tree(ref_st), "state")
    return st


DECODE_CASES = {"jnp": ("retro", "jnp"), "fused": ("retro", "fused"),
                "pallas": ("retro", "pallas"), "full": ("full", "jnp")}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_reference(models, case):
    runtime, impl = DECODE_CASES[case]
    _decode(models, runtime, impl, "jnp", 4)


def test_decode_across_a_flush(models):
    """The 32nd step fills every decoder layer's staging buffer (16 + 32);
    ``flush_state`` clusters its oldest 32 tokens, as the reference's
    does."""
    st = _decode(models, "retro", "jnp", "jnp", 36, flush_at=31)
    for kst in st.self_kv:
        assert kst.local_len.tolist() == [20, 20]
        assert int(kst.n_clusters[0]) > int(
            _ref_prefill("retro")[1].self_kv.n_clusters[0, 0])


def test_pallas_twin_matches_interpreted_kernel(models):
    """The gathered-buffer kernel's twin at G 1 against the reference's
    interpreted Pallas kernel, two steps."""
    _decode(models, "retro", "pallas", "pallas", 2)


def test_state_carried_from_numpy(models):
    ref_cfg, ref_params, cfg, params = models
    _, ref_st = _ref_prefill("full")
    st = serve_state_from_numpy(ref_tree(ref_st), "cpu")
    assert st.cross_k[0].shape == (2, cfg.encoder_frames, 4, 32)
    tok = np.array([3, 4], np.int32)
    ref_lg, ref_st = RE.decode_step(ref_params, ref_cfg, ref_st,
                                    jnp.asarray(tok), runtime="full",
                                    plan=ref_plan_zones(T, ref_cfg.retro,
                                                        HEADROOM))
    lg, st = encdec.decode_step(params, cfg, st, torch.from_numpy(tok),
                                runtime="full",
                                plan=plan_zones(T, cfg.retro, HEADROOM))
    assert_close(lg.numpy(), ref_lg, "logits")
    assert_tree(serve_state_to_numpy(st), ref_tree(ref_st), "state")
