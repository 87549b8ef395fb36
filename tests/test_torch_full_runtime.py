"""The dense-cache runtime (``runtime="full"``, the paper's full-attention
comparator) on the port against the JAX package: ``dense_cache_append``,
``full_attention_decode``, decode steps from a carried-across dense cache,
and the reference's own check that the wave index at full retrieval budget
reproduces full attention, rerun on the port. f32 throughout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as ref_gemma
from repro.core import attention as RA
from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch.configs import gemma2_2b
from repro_torch.configs.base import AttnConfig, ModelConfig, RetroConfig
from repro_torch.core import attention as PA
from repro_torch.core.zones import plan_zones
from repro_torch.interop import params_from_numpy, serve_state_from_numpy
from repro_torch.models import model as M

torch.set_num_threads(2)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cache(rng, B=3, H=2, S=40, hd=16, lengths=(40, 17, 0)):
    k, v = _randn(rng, B, H, S, hd), _randn(rng, B, H, S, hd)
    return k, v, np.asarray(lengths, np.int32)


def test_dense_cache_append_matches_reference():
    """Row 0 is at capacity (drops the append, keeps its cursor), row 1
    appends, row 2 is inactive on every other step."""
    rng = np.random.default_rng(0)
    k, v, lens = _cache(rng, lengths=(40, 17, 3))
    ref = RA.DenseCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    port = PA.DenseCache(torch.from_numpy(k.copy()),
                         torch.from_numpy(v.copy()), torch.from_numpy(lens))
    append = jax.jit(RA.dense_cache_append)
    for t in range(4):
        kn, vn = _randn(rng, 3, 2, 16), _randn(rng, 3, 2, 16)
        act = np.array([True, True, t % 2 == 0])
        ref = append(ref, jnp.asarray(kn), jnp.asarray(vn),
                     active=jnp.asarray(act))
        port = PA.dense_cache_append(port, torch.from_numpy(kn),
                                     torch.from_numpy(vn),
                                     active=torch.from_numpy(act))
    for f in PA.DenseCache._fields:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(port.length.numpy(), [40, 21, 5])


@pytest.mark.parametrize("case", [dict(), dict(window=9.0),
                                  dict(softcap=20.0, window=30.0)])
def test_full_attention_decode_matches_reference(case):
    """Ragged rows (one empty); reading only the first ``span`` slots gives
    the whole cache's result."""
    rng = np.random.default_rng(len(case))
    k, v, lens = _cache(rng, lengths=(40, 17, 1))
    q = _randn(rng, 3, 4, 16)
    ref = RA.full_attention_decode(
        jnp.asarray(q), RA.DenseCache(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(lens)), **case)
    cache = PA.DenseCache(torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(lens))
    for span in (None, 41, 40):
        out = PA.full_attention_decode(torch.from_numpy(q), cache, span=span,
                                       **case)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5, err_msg=str(span))


@pytest.fixture(scope="module")
def models():
    ref_cfg, cfg = ref_gemma.reduced(), gemma2_2b.reduced()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_params, cfg, params


def test_full_decode_steps_match_reference(models):
    """The reference's blocking prefill of two ragged prompts (its dense
    cache carried across), then eight decode steps on each side with the
    same tokens, one row inactive on some steps: logits within 1e-4 and
    the same cache."""
    ref_cfg, ref_params, cfg, params = models
    rng = np.random.default_rng(1)
    S, lens = 160, np.array([160, 90], np.int32)
    toks = rng.integers(0, 512, (2, S)).astype(np.int32)
    _, ref_st = RM.apply_prefill(ref_params, ref_cfg,
                                 {"tokens": jnp.asarray(toks)},
                                 runtime="full", gen_headroom=16,
                                 lengths=jnp.asarray(lens))
    state = serve_state_from_numpy(
        {f: np.asarray(a) for f, a in ref_st.kv._asdict().items()}, "cpu")
    plan = ref_plan_zones(S, ref_cfg.retro, 16)
    dec = jax.jit(functools.partial(RT.decode_step, cfg=ref_cfg,
                                    runtime="full", plan=plan))
    for t in range(8):
        tok = rng.integers(0, 512, (2,)).astype(np.int32)
        act = np.array([True, t % 3 != 1])
        ref_lg, ref_st = dec(ref_params, state=ref_st, token=jnp.asarray(tok),
                             active=jnp.asarray(act))
        lg, state = M.apply_decode(params, cfg, state, torch.from_numpy(tok),
                                   runtime="full",
                                   plan=plan_zones(S, cfg.retro, 16),
                                   active=torch.from_numpy(act))
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    for i, c in enumerate(state.kv):
        np.testing.assert_array_equal(c.length.numpy(),
                                      np.asarray(ref_st.kv.length)[i])
        np.testing.assert_allclose(c.k.numpy(), np.asarray(ref_st.kv.k)[i],
                                   atol=1e-4, rtol=1e-4)


# capacity = prefill segment => provably overflow-free exact coverage
RETRO_X = RetroConfig(avg_cluster=8, cluster_cap=64, prefill_segment=64,
                      update_segment=32, sink=4, local=32,
                      retrieval_frac=1.0, estimation_frac=0.0, kmeans_iters=3)
CFG_X = ModelConfig(
    arch_id="sys-tiny", family="dense", n_layers=2, d_model=64, d_ff=128,
    vocab=256, attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    dtype="float32", retro=RETRO_X)


def test_retro_full_budget_matches_full_attention():
    """The reference's ``test_retro_full_budget_matches_full_attention``
    (tests/test_system.py:47) on the port: with retrieval covering every
    cluster, the wave-index runtime reproduces the dense-cache runtime's
    logits end to end, and the greedy tokens agree."""
    params = M.init_params(CFG_X, torch.Generator().manual_seed(0), "cpu")
    S, B = 384, 2
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG_X.vocab, (B, S)).astype(np.int32))
    plan = plan_zones(S, RETRO_X, 256)
    lg_r, st_r = M.apply_prefill(params, CFG_X, {"tokens": toks},
                                 runtime="retro", plan=plan, gen_headroom=256)
    lg_f, st_f = M.apply_prefill(params, CFG_X, {"tokens": toks},
                                 runtime="full", gen_headroom=256)
    np.testing.assert_allclose(lg_r.numpy(), lg_f.numpy(), atol=1e-3,
                               rtol=1e-3)
    tok = lg_r.argmax(-1).to(torch.int32)
    for _ in range(5):
        lg_r, st_r = M.apply_decode(params, CFG_X, st_r, tok, runtime="retro",
                                    plan=plan)
        lg_f, st_f = M.apply_decode(params, CFG_X, st_f, tok, runtime="full",
                                    plan=plan)
        np.testing.assert_allclose(lg_r.numpy(), lg_f.numpy(), atol=2e-3,
                                   rtol=2e-3)
        assert torch.equal(lg_r.argmax(-1), lg_f.argmax(-1))
        tok = lg_r.argmax(-1).to(torch.int32)


def test_inline_flush_matches_engine_flush():
    """``decode_step(inline_flush=True)`` equals decoding and flushing
    between steps (``flush_state`` after ``update_segment`` appends), as in
    the reference's ``test_engine_flush_matches_inline_flush``."""
    params = M.init_params(CFG_X, torch.Generator().manual_seed(1), "cpu")
    S = 256
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG_X.vocab, (2, S)).astype(np.int32))
    plan = plan_zones(S, RETRO_X, 256)
    _, st_a = M.apply_prefill(params, CFG_X, {"tokens": toks}, plan=plan,
                              gen_headroom=256)
    _, st_b = M.apply_prefill(params, CFG_X, {"tokens": toks}, plan=plan,
                              gen_headroom=256)
    n0 = int(st_a.kv[0].n_clusters[0])
    tok_a = tok_b = torch.zeros((2,), dtype=torch.int32)
    appended = 0
    for _ in range(RETRO_X.update_segment + 4):
        lg_a, st_a = M.apply_decode(params, CFG_X, st_a, tok_a, plan=plan,
                                    inline_flush=True)
        lg_b, st_b = M.apply_decode(params, CFG_X, st_b, tok_b, plan=plan)
        appended += 1
        if M.needs_flush(CFG_X, appended):
            st_b = M.flush_state(CFG_X, st_b)
            appended = 0
        np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), atol=1e-4,
                                   rtol=1e-4)
        tok_a, tok_b = (lg.argmax(-1).to(torch.int32) for lg in (lg_a, lg_b))
    assert int(st_a.kv[0].n_clusters[0]) == int(st_b.kv[0].n_clusters[0]) \
        > n0
    assert M.flush_state(CFG_X, st_b, runtime="full") is st_b
