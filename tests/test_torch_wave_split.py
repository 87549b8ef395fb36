"""The split-and-combine algebra of the wave-attention kernels
(``csrc/wave_fold.cuh``) on the CPU: the twin's walk cut into split
partials at several split counts, the estimation zone cut into chunks, the
partials combined by log-sum-exp (``ref.combine_partials``), against the
JAX package's plain references, for the paged walk and for the same walk
as a gathered buffer. The kernels are held against the twins on the card in
``test_torch_cuda_kernels.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wave_attention import ref as jref
from repro_torch.kernels.wave_attention import ops, ref

torch.set_num_threads(2)
NEG = -1e30
TILE = ops.TILE
SOFTCAP = 50.0
# (BH, ...) geometries of the kernels' edge cases at small widths; q/K/V in
# f32 (the algebra is the point), positions spread past q_pos and outside
# the window, ragged local buffers, a tenth of the estimation entries dead
GEOMETRIES = {
    "r0_dead_slot": dict(r0=True, seed=2),
    "live_zeros": dict(live_frac=0.5, seed=1),
    "e0_overflow_only": dict(e=0, seed=3),
    "no_estimation": dict(e=0, overflow=False, seed=4),
    "ragged_rows_window": dict(window=128.0, q_pos=(900, 300),
                               local_len=(1, 20), seed=5),
    "all_masked_row": dict(masked_row=True, seed=6),
}
SPLITS = ["1", "2", "7", "more_than_tiles", "more_than_tokens", "plan"]


def decode_inputs(*, B=2, H=2, G=2, hd=32, M=64, cap=16, sink=4, lbuf=160,
                  r=3, e=10, q_pos=(900, 600), local_len=(40, 160),
                  window=None, live_frac=1.0, r0=False, overflow=True,
                  masked_row=False, seed=0):
    """numpy inputs of the paged kernel in the twin's flat order (idx, rowb,
    live, q, sink_k, sink_v, local_k, local_v, local_pos, k_store, v_store,
    pos_store, est_logit, cs, vs). ``masked_row``: flat row 0 has no valid
    token and a dead estimation zone."""
    rng = np.random.default_rng(seed)
    BH = B * H
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    qp = np.repeat(np.asarray(q_pos[:B]), H)
    ll = np.repeat(np.asarray(local_len[:B]), H)
    slot = np.arange(lbuf)
    local_pos = np.where(slot[None] < ll[:, None],
                         (qp - ll + 1)[:, None] + slot[None], -1)
    pos_store = (rng.random((BH, M, cap)) * (qp + 64 - sink)[:, None, None]
                 ).astype(np.int32) + sink
    pos_store = np.where(rng.random((BH, M, cap)) < 0.3, -1, pos_store)
    lo = np.full(BH, -1) if window is None else \
        np.maximum(np.floor(qp - window), -1)
    rowb = np.stack([lo, qp], -1)
    if r0:
        r, live = 1, np.zeros((BH, 1))
    else:
        live = rng.random((BH, r)) < live_frac
    idx = np.stack([rng.permutation(M)[:r] for _ in range(BH)])
    E = max(1, e + (r if overflow and not r0 else 0))
    est_logit = 3 * n(BH, G, E)
    cs = est_logit - np.abs(n(BH, G, E))         # cs <= est_logit, as served
    dead = rng.random((BH, G, E)) < 0.1
    if e == 0 and not overflow:
        dead[:] = True
    if masked_row:
        rowb[0] = (qp[0], qp[0])                 # lo = hi: no position passes
        dead[0] = True
    est_logit = np.where(dead, NEG, est_logit).astype(np.float32)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return [i32(idx), i32(rowb), i32(live), n(BH, G, hd),
            n(BH, sink, hd), n(BH, sink, hd), n(BH, lbuf, hd), n(BH, lbuf, hd),
            i32(local_pos), n(BH, M, cap, hd), n(BH, M, cap, hd),
            i32(pos_store), est_logit, cs, 3 * n(BH, E, hd)]


@functools.lru_cache(maxsize=None)
def case(name):
    """(port tensors, the JAX reference's output) of a geometry."""
    args = decode_inputs(**GEOMETRIES[name])
    sink_len = args[4].shape[1]
    want = np.asarray(jref.paged_wave_attention_jnp(
        *(jnp.asarray(a) for a in args), sink_len=sink_len, softcap=SOFTCAP))
    return [torch.from_numpy(a) for a in args], want


def _walk(t, *, tile=None):
    """(q, k, v, ok, est_logit, cs, vs) of a paged case, its walk laid out
    as one gathered buffer; ``tile``: each zone padded to whole tiles with
    masked tokens, as the kernel's tiles cut it."""
    idx, rowb, live, q = t[:4]
    k, v, ok = ref.paged_walk(idx, rowb, live, *t[4:12],
                              sink_len=t[4].shape[1], tile=tile)
    return q, k, v, ok, t[12], t[13], t[14]


def _cuts(n, splits, *, tile):
    """Boundaries of ``splits`` contiguous pieces of n tokens (entries)."""
    tiles = -(-n // tile)
    count = {"more_than_tiles": tiles + 5,
             "more_than_tokens": n + 3}.get(splits)
    count = int(splits) if count is None else count
    return np.linspace(0, n, count + 1).round().astype(int)


def _partials(q, k, v, ok, est_logit, cs, vs, splits):
    """The split partials of a walk and its estimation zone, cut as
    ``splits`` says ("plan": ``ops.split_plan``'s tiles per split, the
    kernel's own cut)."""
    N, E = k.shape[1], vs.shape[1]
    if splits == "plan":
        tps, _ = ops.split_plan(q.shape[0], -(-N // TILE), -(-E // TILE))
        att = list(range(0, N, tps * TILE)) + [N]
        est = list(range(0, E, tps * TILE)) + [E]
    else:
        att = _cuts(N, splits, tile=TILE)
        est = np.unique(_cuts(E, splits, tile=TILE))  # no empty E chunk
    parts = [ref.attention_partial(q, k[:, a:b], v[:, a:b], ok[:, a:b],
                                   softcap=SOFTCAP)
             for a, b in zip(att[:-1], att[1:])]
    parts += [ref.estimation_partial(est_logit[..., a:b], cs[..., a:b],
                                     vs[:, a:b])
              for a, b in zip(est[:-1], est[1:])]
    return parts


def _close(out, want):
    tol = 2e-5 * (1 + np.abs(want).max())
    err = np.abs(out.numpy() - want).max()
    assert np.isfinite(out.numpy()).all()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_paged_split_partials_match_reference(geometry, splits):
    t, want = case(geometry)
    walk = _walk(t, tile=TILE if splits == "plan" else None)
    out = ref.combine_partials(_partials(*walk, splits))
    _close(out, want)
    if geometry == "all_masked_row":
        assert (out[0] == 0).all()


@functools.lru_cache(maxsize=None)
def merge_case(name):
    """A paged case's walk as the gathered-buffer merge's inputs, with the
    JAX reference merge's output on them."""
    walk = _walk(case(name)[0])
    want = np.asarray(jref.wave_attention_ref(
        *(jnp.asarray(a.numpy()) for a in walk), softcap=SOFTCAP))
    return walk, want


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_merge_split_partials_match_reference(geometry, splits):
    walk, want = merge_case(geometry)
    _close(ref.combine_partials(_partials(*walk, splits)), want)
    # the paged walk and the gathered buffer are one attention
    _close(ref.combine_partials(_partials(*walk, "7")), case(geometry)[1])


def test_empty_partials_change_nothing():
    """An empty split (m = -inf, l = 0, acc = 0) adds exactly nothing,
    wherever it stands."""
    walk, _ = merge_case("live_zeros")
    parts = _partials(*walk, "7")
    q = walk[0]
    empty = ref.attention_partial(q, walk[1][:, :0], walk[2][:, :0],
                                  walk[3][:, :0])
    assert (empty[0] == -np.inf).all() and (empty[1] == 0).all() \
        and (empty[2] == 0).all()
    base = ref.combine_partials(parts)
    for at in (0, 3, len(parts)):
        padded = parts[:at] + [empty, empty] + parts[at:]
        assert torch.equal(ref.combine_partials(padded), base)


@pytest.mark.parametrize("rows,n_tiles,e_tiles", [
    (8, 53, 8),                      # gemma2-2b decode at B = 2 (both kernels)
    (2, 53, 8), (32, 53, 8), (256, 53, 8), (8, 1, 1), (1024, 400, 64)])
def test_split_plan(rows, n_tiles, e_tiles):
    """Splits cover every tile once, within MAX_TPS tiles each; the grid
    fills the card several times over where the work allows, and one tile
    per split is kept until it does."""
    tps, splits = ops.split_plan(rows, n_tiles, e_tiles)
    assert 1 <= tps <= ops.MAX_TPS
    att = -(-n_tiles // tps)
    assert (att - 1) * tps < n_tiles <= att * tps
    assert splits == att + -(-e_tiles // tps)
    if rows * (n_tiles + e_tiles) >= 3 * 132:
        assert rows * splits >= 3 * 132
    if rows * (n_tiles + e_tiles) <= ops.TARGET_BLOCKS:
        assert tps == 1
    if (rows, n_tiles, e_tiles) == (8, 53, 8):
        assert (tps, splits) == (1, 61)
