"""Port wave index against the JAX chunked build, decode append and flush.

Generic-position fixtures (independent Gaussian keys, no duplicated or
near-duplicated keys): assignments, stores and counters must be identical
and the meta index within 1e-5. Near ties are tested separately on the
port's invariants only, since argmax may flip between summation orders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RetroConfig as RefRetro
from repro.core import wave_index as RW
from repro_torch.configs.base import RetroConfig
from repro_torch.core import wave_index as PW
from repro_torch.interop import wave_state_to_numpy

torch.set_num_threads(2)
KW = dict(avg_cluster=8, cluster_cap=16, prefill_segment=256,
          update_segment=128, sink=4, local=32, kmeans_iters=3)
REF_RETRO, RETRO = RefRetro(**KW), RetroConfig(**KW)
B, H, HD, N, CHUNK = 2, 2, 32, 612, 64
EXACT = ("k_store", "v_store", "pos_store", "size", "stored", "max_pos",
         "n_clusters", "sink_k", "sink_v", "local_k", "local_v", "local_len",
         "length")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, N, H, HD)).astype(np.float32)
    v = rng.standard_normal((B, N, H, HD)).astype(np.float32)
    dec = rng.standard_normal((RETRO.update_segment, 2, B, H, HD)) \
        .astype(np.float32)
    active = np.ones((RETRO.update_segment, B), bool)
    active[:5, 1] = False              # row 1 stays short of a full buffer
    return k, v, dec, active


def _chunks():
    for c0 in range(0, N, CHUNK):
        yield c0, min(CHUNK, N - c0)


def _pad(a, c0, n):
    out = np.zeros((B, CHUNK) + a.shape[2:], a.dtype)
    out[:, :n] = a[:, c0:c0 + n]
    return out


def _ref_states():
    k, v, dec, active = _inputs()
    M = RW.max_clusters(N, REF_RETRO, 256)
    cp = RW.init_chunked_prefill(B, H, HD, M, REF_RETRO, CHUNK, jnp.float32)
    append = jax.jit(functools.partial(RW.prefill_append_chunk,
                                       retro=REF_RETRO))
    for c0, n in _chunks():
        cp = append(cp, jnp.asarray(_pad(k, c0, n)),
                    jnp.asarray(_pad(v, c0, n)),
                    chunk_lens=jnp.full((B,), n, jnp.int32))
    built = RW.prefill_finalize(cp, REF_RETRO, N)
    st = built
    app = jax.jit(RW.append_token)
    for t in range(len(dec)):
        st = app(st, jnp.asarray(dec[t, 0]), jnp.asarray(dec[t, 1]),
                 active=jnp.asarray(active[t]))
    flushed = RW.flush_segment(st, REF_RETRO)
    to_np = lambda s: {f: np.asarray(getattr(s, f)) for f in s._fields}
    return to_np(built), to_np(st), to_np(flushed)


@pytest.fixture(scope="module")
def ref_states():
    return _ref_states()


@pytest.fixture(scope="module")
def port_states():
    return _port_states()


def _port_states():
    k, v, dec, active = _inputs()
    M = PW.max_clusters(N, RETRO, 256)
    cp = PW.init_chunked_prefill(B, H, HD, M, RETRO, CHUNK, torch.float32,
                                 device="cpu")
    for c0, n in _chunks():
        cp = PW.prefill_append_chunk(
            cp, torch.from_numpy(_pad(k, c0, n)), torch.from_numpy(_pad(v, c0, n)),
            RETRO, torch.full((B,), n, dtype=torch.int32))
    st = PW.prefill_finalize(cp, RETRO, N)
    built = wave_state_to_numpy(st)
    for t in range(len(dec)):
        st = PW.append_token(st, torch.from_numpy(dec[t, 0]),
                             torch.from_numpy(dec[t, 1]),
                             active=torch.from_numpy(active[t]))
    appended = wave_state_to_numpy(st)
    flushed = wave_state_to_numpy(PW.flush_segment(st, RETRO))
    return built, appended, flushed


def _assert_same(ref, port):
    for f in EXACT:
        np.testing.assert_array_equal(port[f], ref[f], err_msg=f)
    for f in ("centroid", "vsum"):
        np.testing.assert_allclose(port[f], ref[f], atol=1e-5, rtol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("stage", ["chunked_build", "append_token",
                                   "flush_segment"])
def test_wave_index_matches_reference(ref_states, port_states, stage):
    i = ("chunked_build", "append_token", "flush_segment").index(stage)
    port = port_states[i]
    _assert_same(ref_states[i], port)
    if stage == "flush_segment":       # row 0 flushed, row 1 did not
        assert port["n_clusters"][0] > ref_states[1]["n_clusters"][0]
        assert port["n_clusters"][1] == ref_states[1]["n_clusters"][1]


def test_near_tie_build_keeps_invariants():
    """Near-duplicate keys make argmax flips likely; whatever the
    assignment, sizes sum to the clustered region and stored positions are
    a permutation of it (cap large enough that nothing overflows)."""
    retro = RetroConfig(**{**KW, "cluster_cap": 256})
    rng = np.random.default_rng(5)
    n = 400
    base = rng.standard_normal((1, 1, 1, HD)).astype(np.float32)
    k = base + 1e-7 * rng.standard_normal((1, n, 1, HD)).astype(np.float32)
    v = rng.standard_normal((1, n, 1, HD)).astype(np.float32)
    M = PW.max_clusters(n, retro, 256)
    cp = PW.init_chunked_prefill(1, 1, HD, M, retro, 100, torch.float32,
                                 device="cpu")
    for c0 in range(0, n, 100):
        cp = PW.prefill_append_chunk(cp, torch.from_numpy(k[:, c0:c0 + 100]),
                                     torch.from_numpy(v[:, c0:c0 + 100]), retro)
    st = PW.prefill_finalize(cp, retro, n)
    active = int(st.n_clusters[0])
    region = np.arange(retro.sink, n - retro.local)
    assert int(st.size[0, 0, :active].sum()) == len(region)
    assert int(st.size[0, 0, active:].sum()) == 0
    pos = st.pos_store[0, 0, :active].numpy().reshape(-1)
    np.testing.assert_array_equal(np.sort(pos[pos >= 0]), region)


def test_cluster_segment_with_valid_mask_matches_reference():
    """Segment clustering with a ragged-padding ``valid`` mask: padded tokens
    enter no store and no statistic, as in the reference."""
    from repro.core.clustering import cluster_segment as ref_cluster
    from repro_torch.core.clustering import cluster_segment
    rng = np.random.default_rng(3)
    S, n = 3, 128
    k = rng.standard_normal((S, n, HD)).astype(np.float32)
    v = rng.standard_normal((S, n, HD)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (S, n)).copy()
    valid = np.arange(n)[None, :] < np.array([[128], [100], [37]])
    ref = jax.vmap(lambda a, b, c, d: ref_cluster(a, b, c, 8, 16, 3, True,
                                                  valid=d))(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(valid))
    out = cluster_segment(torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos), 8, 16, 3, True,
                          valid=torch.from_numpy(valid))
    for f, r, o in zip(out._fields, ref, out):
        if f in ("centroid", "vsum"):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                       rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=f)
    assert int(out.size[2].sum()) == 37
