"""Blocking admission on the port against the JAX package: the monolithic
prefill's pieces (``flash_attention_jnp`` and the dispatch of its calls to
the prefill attention kernel, ``segmented_cluster``,
``prefill_build``, ``block_sparse_attention``) and ``apply_prefill`` on
gemma2-2b ``reduced()`` under both runtimes, on the same numpy inputs.

Generic-position fixtures (independent Gaussian keys): cluster assignments,
stores and counters must be identical and the meta index within 1e-5;
attention outputs within 1e-5, logits within 1e-4 (f32 everywhere).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as ref_gemma
from repro.configs.base import RetroConfig as RefRetro
from repro.core import clustering as RC
from repro.core import wave_index as RW
from repro.core.sparse_prefill import block_sparse_attention as ref_sparse
from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import gemma2_2b
from repro_torch.configs.base import RetroConfig
from repro_torch.core import clustering as PC
from repro_torch.core import wave_index as PW
from repro_torch.core.sparse_prefill import block_sparse_attention
from repro_torch.core.zones import plan_zones
from repro_torch.interop import params_from_numpy, wave_state_to_numpy
from repro_torch.kernels.prefill_attention import ops as PA
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref
from repro_torch.models import layers as PL
from repro_torch.models import model as M
from repro_torch.models.transformer import GLOBAL_WINDOW

torch.set_num_threads(2)
KW = dict(avg_cluster=8, cluster_cap=16, prefill_segment=64,
          update_segment=32, sink=4, local=16, kmeans_iters=3)
REF_RETRO, RETRO = RefRetro(**KW), RetroConfig(**KW)
EXACT = ("k_store", "v_store", "pos_store", "size", "stored", "max_pos",
         "n_clusters", "sink_k", "sink_v", "local_k", "local_v", "local_len",
         "length")
INTS = ("pos_store", "size", "stored", "max_pos", "n_clusters", "local_len",
        "length")


def _assert_states(port, ref, exact=EXACT, tol=1e-5):
    for f in exact:
        np.testing.assert_array_equal(port[f], ref[f], err_msg=f)
    for f in set(port) - set(exact):
        np.testing.assert_allclose(port[f], ref[f], atol=tol, rtol=tol,
                                   err_msg=f)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash_attention_jnp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(),
    dict(window=24.0),
    dict(softcap=30.0, window=40.0),
    dict(q_offset=30, tq=20),            # decode-style queries past the keys
    dict(q_offset=-5, window=8.0),       # leading rows see no key at all
    dict(causal=False, tk=45),           # a ragged last key block
])
def test_flash_attention_matches_reference(case):
    case = dict(case)
    tq, tk = case.pop("tq", 50), case.pop("tk", 50)
    rng = np.random.default_rng(len(str(case)))
    q = _randn(rng, 2, tq, 4, 16)
    k, v = _randn(rng, 2, tk, 2, 16), _randn(rng, 2, tk, 2, 16)
    ref = RL.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), block=16, **case)
    out = PL.flash_attention_jnp(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), block=16, **case)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    if case.get("q_offset", 0) < 0:       # fully masked rows give 0, not NaN
        assert float(out[:, :5].abs().max()) == 0.0


def test_repeat_kv_matches_reference():
    k = _randn(np.random.default_rng(0), 2, 5, 3, 4)
    np.testing.assert_array_equal(
        PL._repeat_kv(torch.from_numpy(k), 4).numpy(),
        np.asarray(RL._repeat_kv(jnp.asarray(k), 4)))


# (kwargs of flash_attention_jnp, input changes) -> whether the CUDA kernel
# takes the call: causal, no soft cap, no window or a whole number of
# positions, bf16 at an instantiated head dim, no gradient
ROUTES = {
    "global_sentinel": (dict(window=GLOBAL_WINDOW), {}, True),
    "no_window": (dict(), {}, True),
    # 40 queries from position 1: the farthest query-key distance is 40
    "window_past_every_distance": (dict(window=41.0, q_offset=1), {}, True),
    # a window that masks: the kernel's windowed instantiation
    "window_at_the_farthest_distance": (dict(window=40.0, q_offset=1), {},
                                        True),
    "q_offset": (dict(q_offset=7, window=GLOBAL_WINDOW), {}, True),
    "negative_q_offset": (dict(q_offset=-5), {}, False),
    "tensor_q_offset": (dict(q_offset=torch.tensor(3)), {}, False),
    "tensor_window": (dict(window=torch.tensor(GLOBAL_WINDOW)), {}, False),
    "softcap": (dict(softcap=50.0, window=GLOBAL_WINDOW), {}, False),
    "not_causal": (dict(causal=False), {}, False),
    "sliding_window": (dict(window=16.0), {}, True),
    "fractional_window": (dict(window=16.5), {}, False),
    "hd64": (dict(), dict(hd=64), False),
    "hd256": (dict(), dict(hd=256), False),
    "f32": (dict(), dict(dtype=torch.float32), False),
    "grad": (dict(), dict(grad=True), False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_prefill_kernel_route(name):
    """The dispatch predicate of ``flash_attention_jnp``'s kernel route, on
    CPU tensors (device aside, the same decision as on the card); the CPU
    call itself always runs the plain body and launches nothing."""
    kw, change, want = ROUTES[name]
    hd, dtype = change.get("hd", 128), change.get("dtype", torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 40, 4, hd), generator=g).to(dtype)
    k = torch.randn((1, 40, 2, hd), generator=g).to(dtype)
    v = torch.randn((1, 40, 2, hd), generator=g).to(dtype)
    if change.get("grad"):
        q.requires_grad_()
    route = {**dict(causal=True, window=None, softcap=None, q_offset=0),
             **kw}
    assert PA.covers(q, k, v, **route) is want
    with torch.no_grad():
        assert PA.covers(q, k, v, **route) is (want or name == "grad")
    if not isinstance(kw.get("q_offset", 0), int) or name == "hd256":
        return
    before = PA.prefill_attention.launches
    out = PL.flash_attention_jnp(q, k, v, **kw)
    assert PA.prefill_attention.launches == before
    plain = prefill_attention_ref(q, k, v, **kw)
    assert torch.equal(out, plain)


def test_prefill_wrapper_checks_and_cpu_twin():
    """The wrapper's argument checks, and on the CPU its plain twin: the
    plain body at causal, in f32 or rounded once to bf16."""
    g = torch.Generator().manual_seed(1)

    def bf(*shape):
        return torch.randn(shape, generator=g).bfloat16()
    q, k, v = bf(2, 30, 6, 128), bf(2, 33, 2, 128), bf(2, 33, 2, 128)
    out = PA.prefill_attention(q, k, v, q_offset=3, out_dtype=torch.float32)
    ref = prefill_attention_ref(q, k, v, causal=True, q_offset=3,
                                out_dtype=torch.float32)
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    assert torch.equal(PA.prefill_attention(q, k, v, q_offset=3),
                       ref.bfloat16())
    bad = {
        "k_v_shapes": ((q, k, v[:, :5]), ValueError),
        "batch": ((q, k[:1], v[:1]), ValueError),
        "hkv_divides_hq": ((bf(2, 30, 5, 128), k, v), ValueError),
        "head_dim": ((q[..., :64], k[..., :64], v[..., :64]), ValueError),
        "hd_mismatch": ((q, k[..., :64], v[..., :64]), ValueError),
        "rank": ((q[0], k, v), ValueError),
        "dtype": ((q.float(), k, v), TypeError),
    }
    for name, (args, exc) in bad.items():
        with pytest.raises(exc):
            PA.prefill_attention(*args)
        with pytest.raises(exc):
            PA.prefill_attention_plain(*args)


# ---------------------------------------------------------------------------
# segmented_cluster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_segmented_cluster_matches_reference(ragged):
    """Both variants (batched segments; one segment at a time) give the same
    stores, and both match the reference's ``vmap`` and ``lax.map``."""
    rng = np.random.default_rng(4)
    S, n, hd, seg = 3, 192, 16, 64
    k, v = _randn(rng, S, n, hd), _randn(rng, S, n, hd)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (S, n)).copy()
    valid = np.arange(n)[None, :] < np.array([[192], [150], [70]]) \
        if ragged else None
    args = (8, 16, 3, True)
    outs = {}
    for serial in (False, True):
        outs[serial] = PC.segmented_cluster(
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
            seg, *args, serial=serial,
            valid=None if valid is None else torch.from_numpy(valid))
        ref = jax.jit(jax.vmap(lambda a, b, c, d: RC.segmented_cluster(
            a, b, c, seg, *args, serial=serial, valid=d),
            in_axes=(0, 0, 0, None if valid is None else 0)))(
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            None if valid is None else jnp.asarray(valid))
        port = {f: t.numpy() for f, t in zip(outs[serial]._fields,
                                             outs[serial])}
        _assert_states(port, {f: np.asarray(r) for f, r in
                              zip(ref._fields, ref)},
                       exact=("k_store", "v_store", "pos_store", "size",
                              "stored", "max_pos"))
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)
    if ragged:                            # padding enters no store
        assert int(outs[False].size[2].sum()) == 70


# ---------------------------------------------------------------------------
# prefill_build
# ---------------------------------------------------------------------------

def _kv(seed, B=2, S=300, H=2, hd=16):
    rng = np.random.default_rng(seed)
    return _randn(rng, B, S, H, hd), _randn(rng, B, S, H, hd)


@pytest.mark.parametrize("lengths", [None, (300, 231)])
def test_prefill_build_matches_reference(lengths):
    """Four full 64-token segments and a tail; with ``lengths`` row 1's
    right padding enters no store and its local window ends at its own
    length."""
    k, v = _kv(1)
    M_ = RW.max_clusters(300, REF_RETRO, 64)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    build = jax.jit(functools.partial(RW.prefill_build, retro=REF_RETRO,
                                      M=M_))
    ref = build(jnp.asarray(k), jnp.asarray(v),
                lengths=None if lens is None else jnp.asarray(lens))
    out = PW.prefill_build(torch.from_numpy(k), torch.from_numpy(v), RETRO,
                           M_, lengths=None if lens is None
                           else torch.from_numpy(lens))
    _assert_states(wave_state_to_numpy(out),
                   {f: np.asarray(getattr(ref, f)) for f in ref._fields})


@pytest.mark.parametrize("serial", [False, True])
def test_prefill_build_equals_chunked_build(serial):
    """The monolithic build and the port's chunked builder give the same
    state bit for bit on the same K/V (as the reference's two builds do)."""
    retro = RetroConfig(**KW, serial_prefill_segments=serial)
    k, v = _kv(2)
    B, S, H, hd = k.shape
    M_ = PW.max_clusters(S, retro, 64)
    built = PW.prefill_build(torch.from_numpy(k), torch.from_numpy(v), retro,
                             M_)
    cp = PW.init_chunked_prefill(B, H, hd, M_, retro, 48, torch.float32,
                                 device="cpu")
    for c0 in range(0, S, 48):
        n = min(48, S - c0)
        pad = lambda a: torch.from_numpy(np.concatenate(
            [a[:, c0:c0 + n], np.zeros((B, 48 - n, H, hd), np.float32)], 1))
        cp = PW.prefill_append_chunk(cp, pad(k), pad(v), retro,
                                     torch.full((B,), n, dtype=torch.int32))
    chunked = PW.prefill_finalize(cp, retro, S)
    for f, a, b in zip(built._fields, built, chunked):
        assert torch.equal(a, b), f


def test_maybe_flush_matches_reference():
    k, v = _kv(3, S=120)
    M_ = RW.max_clusters(120, REF_RETRO, 64)
    ref = RW.prefill_build(jnp.asarray(k), jnp.asarray(v), REF_RETRO, M_)
    out = PW.prefill_build(torch.from_numpy(k), torch.from_numpy(v), RETRO,
                           M_)
    rng = np.random.default_rng(9)
    step = jax.jit(lambda st, kn, vn, act: RW.maybe_flush(
        RW.append_token(st, kn, vn, active=act), REF_RETRO))
    for t in range(KW["update_segment"] + 2):
        kn, vn = _randn(rng, 2, 2, 16), _randn(rng, 2, 2, 16)
        act = np.array([True, t % 3 != 0])
        ref = step(ref, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(act))
        out = PW.maybe_flush(PW.append_token(out, torch.from_numpy(kn),
                                             torch.from_numpy(vn),
                                             active=torch.from_numpy(act)),
                             RETRO)
    port = wave_state_to_numpy(out)
    _assert_states(port, {f: np.asarray(getattr(ref, f))
                          for f in ref._fields})
    assert port["n_clusters"][0] > port["n_clusters"][1]   # row 0 flushed


# ---------------------------------------------------------------------------
# block_sparse_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(topk_blocks=1, sink_blocks=1, local_blocks=1),
    # sel 4 of 4 blocks: query block 0 also selects the NEG-masked
    # (non-causal) blocks 1-3, tied at NEG
    dict(topk_blocks=2, sink_blocks=1, local_blocks=2),
    dict(topk_blocks=2, sink_blocks=0, local_blocks=1, window=40.0,
         softcap=30.0),
])
def test_block_sparse_matches_reference(case):
    rng = np.random.default_rng(len(case))
    q = _randn(rng, 2, 128, 4, 16)
    k, v = _randn(rng, 2, 128, 2, 16), _randn(rng, 2, 128, 2, 16)
    ref = ref_sparse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block=32, **case)
    out = block_sparse_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), block=32, **case)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# apply_prefill on gemma2-2b reduced
# ---------------------------------------------------------------------------

LENS = (256, 200)


@pytest.fixture(scope="module")
def models():
    ref_cfg, cfg = ref_gemma.reduced(), gemma2_2b.reduced()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    toks = np.zeros((2, LENS[0]), np.int32)
    rng = np.random.default_rng(0)
    for b, n in enumerate(LENS):
        toks[b, :n] = rng.integers(0, 512, n)
    return ref_cfg, ref_params, cfg, params, toks


@pytest.mark.parametrize("runtime,sparse", [("retro", 0), ("full", 0),
                                            ("retro", 2)])
def test_apply_prefill_matches_reference(models, runtime, sparse):
    """Ragged blocking prefill (row 1 right-padded): last-real-position
    logits within 1e-4. The retro state: the same assignments (positions,
    sizes, counters equal), the K/V the model computed and the meta index
    within 1e-4; the dense cache's valid prefix within 1e-4. ``sparse``:
    block-sparse prefill blocks."""
    ref_cfg, ref_params, cfg, params, toks = models
    ref_cfg = ref_cfg.replace(sparse_prefill_blocks=sparse)
    cfg = cfg.replace(sparse_prefill_blocks=sparse)
    lens = np.asarray(LENS, np.int32)
    S = toks.shape[1]
    prefill = jax.jit(functools.partial(
        RM.apply_prefill, cfg=ref_cfg, runtime=runtime,
        plan=ref_plan_zones(S, ref_cfg.retro, 128), gen_headroom=128,
        cache_len=S + 128))
    ref_lg, ref_st = prefill(ref_params, batch={"tokens": jnp.asarray(toks)},
                             lengths=jnp.asarray(lens))
    lg, st = M.apply_prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                             runtime=runtime,
                             plan=plan_zones(S, cfg.retro, 128),
                             gen_headroom=128, lengths=torch.from_numpy(lens),
                             cache_len=S + 128)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), atol=1e-4,
                               rtol=1e-4)
    for i, layer in enumerate(st.kv):
        ref_l = {f: np.asarray(getattr(ref_st.kv, f))[i]
                 for f in ref_st.kv._fields}
        if runtime == "retro":
            _assert_states(wave_state_to_numpy(layer), ref_l, exact=INTS,
                           tol=1e-4)
        else:
            np.testing.assert_array_equal(layer.length.numpy(), lens)
            for f in ("k", "v"):
                for b, n in enumerate(lens):
                    np.testing.assert_allclose(
                        getattr(layer, f)[b, :, :n].numpy(),
                        ref_l[f][b, :, :n], atol=1e-4, rtol=1e-4)
