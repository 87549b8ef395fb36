"""Block gather and segmented k-means: the port's ops (plain twins on the
CPU) against the reference's Pallas kernels in interpret mode, over the
cases of the reference's own kernel tests. The CUDA kernels are held
against the twins in ``test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather.ops import block_gather_op as ref_gather
from repro.kernels.kmeans.ops import segmented_kmeans_op as ref_kmeans_op
from repro.kernels.kmeans.ref import kmeans_step_ref as ref_kmeans_step
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels.gather import ops as gather_ops
from repro_torch.kernels.kmeans import ops as kmeans_ops
from repro_torch.kernels.kmeans.ref import kmeans_ref

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,M,cap,hd,r", [
    (2, 2, 64, 16, 32, 8), (1, 1, 128, 32, 64, 13), (4, 2, 32, 8, 128, 32),
])
def test_gather_matches_pallas_kernel(B, H, M, cap, hd, r, dtype):
    rng = np.random.default_rng(M * r)
    kst, vst = (np.asarray(jnp.asarray(
        rng.standard_normal((B, H, M, cap, hd)), jnp.dtype(dtype)))
        for _ in range(2))
    idx = rng.integers(0, M, (B, H, r)).astype(np.int32)
    ko, vo = ref_gather(jnp.asarray(idx), jnp.asarray(kst), jnp.asarray(vst),
                        interpret=True)
    before = gather_ops.block_gather_op.launches
    pk, pv = gather_ops.block_gather_op(*(tensor_from_numpy(a, "cpu")
                                          for a in (idx, kst, vst)))
    assert gather_ops.block_gather_op.launches == before    # twin, no kernel
    for got, want in ((pk, ko), (pv, vo)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_gather_repeated_indices():
    """Duplicate ids replicate blocks (the reference's cache-hit case)."""
    kst = torch.arange(4 * 2 * 8, dtype=torch.float32).reshape(1, 1, 4, 2, 8)
    idx = torch.tensor([[[2, 2, 0]]], dtype=torch.int32)
    ko, _ = gather_ops.block_gather_op(idx, kst, kst)
    assert torch.equal(ko[0, 0, 0], ko[0, 0, 1])
    assert torch.equal(ko[0, 0, 2], kst[0, 0, 0])
    want, _ = ref_gather(jnp.asarray(idx.numpy()), jnp.asarray(kst.numpy()),
                         jnp.asarray(kst.numpy()), interpret=True)
    np.testing.assert_array_equal(ko.numpy(), np.asarray(want))


KMEANS = [(4, 256, 32, 16, 4), (2, 128, 64, 8, 3), (1, 512, 128, 64, 2),
          (8, 64, 16, 8, 5)]          # S, n, d, k, iters (test_kernels.py:64)


def _kmeans_inputs(S, n, d, k):
    x = np.random.default_rng(S * n).standard_normal((S, n, d)).astype(
        np.float32)
    return x, np.ascontiguousarray(x[:, ::max(1, n // k)][:, :k])


@pytest.mark.parametrize("S,n,d,k,iters", KMEANS)
def test_kmeans_matches_pallas_kernel(S, n, d, k, iters):
    """Final centroids within 1e-5, assignments equal."""
    x, c0 = _kmeans_inputs(S, n, d, k)
    cr, ar = ref_kmeans_op(jnp.asarray(x), jnp.asarray(c0), iters=iters,
                           interpret=True)
    tx, tc0 = torch.from_numpy(x), torch.from_numpy(c0)
    before = kmeans_ops.kmeans_step.launches
    cp, ap = kmeans_ops.segmented_kmeans_op(tx, tc0, iters=iters)
    assert kmeans_ops.kmeans_step.launches == before         # twin, no kernel
    np.testing.assert_allclose(cp.numpy(), np.asarray(cr), atol=1e-5)
    np.testing.assert_array_equal(ap.numpy(), np.asarray(ar))
    # the loop twin is the op's loop
    ct, at = kmeans_ref(tx, tc0, iters)
    assert torch.equal(ct, cp) and torch.equal(at, ap)


@pytest.mark.parametrize("S,n,d,k,iters", KMEANS[:2])
def test_kmeans_step_matches_reference(S, n, d, k, iters):
    """One step's sums, counts and assignments against the reference's
    step oracle."""
    x, c0 = _kmeans_inputs(S, n, d, k)
    sums, counts, assign = kmeans_ops.kmeans_step(torch.from_numpy(x),
                                                  torch.from_numpy(c0))
    rs, rc, ra = ref_kmeans_step(jnp.asarray(x), jnp.asarray(c0))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(rs), atol=1e-5)
    assert assign.dtype == torch.int32 and counts.dtype == torch.float32


def test_kmeans_ties_take_the_lowest_index():
    """Two identical centroids: every point goes to the first, as
    jnp.argmax does; the empty second cluster keeps its centroid."""
    x = torch.randn((1, 32, 8), generator=torch.Generator().manual_seed(0))
    c0 = torch.ones((1, 2, 8))
    sums, counts, assign = kmeans_ops.kmeans_step(x, c0)
    assert (assign == 0).all() and counts.tolist() == [[32.0, 0.0]]
    cent, _ = kmeans_ops.segmented_kmeans_op(x, c0, iters=1)
    assert torch.equal(cent[0, 1], c0[0, 1])


def test_kmeans_step_check_catches_faults():
    """The card's acceptance check passes the twin's own outputs and flags a
    moved assignment, a wrong sum and a wrong count."""
    from repro_torch.kernels.kmeans.ref import kmeans_step_check
    x, c0 = (torch.from_numpy(a) for a in _kmeans_inputs(2, 128, 64, 8))
    sums, counts, assign = kmeans_ops.kmeans_step(x, c0)
    res = kmeans_step_check(x, c0, sums, counts, assign)
    assert res["ok"] and res["mismatches"] == 0, res
    moved = assign.clone()
    moved[0, 0] = (moved[0, 0] + 1) % 8
    sums_m, counts_m = (t.clone() for t in (sums, counts))
    assert not kmeans_step_check(x, c0, sums, counts, moved)["ok"]
    sums_m[1, 2, 3] += 1e-3 * (1 + sums_m[1, 2, 3].abs())
    assert not kmeans_step_check(x, c0, sums_m, counts, assign)["ok"]
    counts_m[0, 1] += 1
    assert not kmeans_step_check(x, c0, sums, counts_m, assign)["ok"]


# ---- the plain models of the CUDA kernels' new pieces ----------------------

@pytest.mark.parametrize("S,n,d,k", [(3, 1000, 72, 70), (2, 64, 16, 1),
                                     (2, 50, 8, 7), (1, 300, 30, 1100)])
def test_cluster_order_is_a_stable_permutation(S, n, d, k):
    """The order the CUDA update sums in: every point once, clusters in
    increasing id, points ascending within a cluster, and offsets that are
    the exclusive prefix of the one-hot counts."""
    from repro_torch.kernels.kmeans.ref import (cluster_order_ref,
                                                kmeans_update_ref)
    x = torch.from_numpy(np.random.default_rng(n + k).standard_normal(
        (S, n, d)).astype(np.float32))
    assign = torch.from_numpy(np.random.default_rng(k).integers(
        0, k, (S, n)).astype(np.int32))
    order, offsets = cluster_order_ref(assign, k)
    _, counts = kmeans_update_ref(x, assign, k)
    assert torch.equal(offsets[:, 1:] - offsets[:, :-1], counts.long())
    assert (offsets[:, 0] == 0).all() and (offsets[:, -1] == n).all()
    assert torch.equal(order.sort(dim=1).values,
                       torch.arange(n).expand(S, n))
    keys = assign.long().gather(1, order) * n + order   # (cluster, point)
    assert (keys[:, 1:] > keys[:, :-1]).all()


@pytest.mark.parametrize("S,n,d,k", [(3, 1000, 72, 70), (2, 64, 16, 1),
                                     (4, 256, 32, 16), (2, 300, 8, 5)])
def test_ordered_update_matches_one_hot_sums(S, n, d, k):
    """The point-order sums (what the CUDA kernel adds, bit for bit)
    against the reference's one-hot update and the port's twin: counts
    exact, sums within 2 c u sum|x| per cluster of c points (two orders of
    c f32 additions, each off by at most (c - 1) u sum|x|)."""
    from repro_torch.kernels.kmeans.ref import (kmeans_update_ref,
                                                ordered_update_ref)
    x, c0 = _kmeans_inputs(S, n, d, k)
    rs, rc, ra = (np.array(a) for a in ref_kmeans_step(jnp.asarray(x),
                                                        jnp.asarray(c0)))
    assign = torch.from_numpy(ra)
    tx = torch.from_numpy(x)
    sums, counts = ordered_update_ref(tx, assign, k)
    np.testing.assert_array_equal(counts.numpy(), rc)
    ts, tc = kmeans_update_ref(tx, assign, k)
    assert torch.equal(tc, counts)
    mag, _ = kmeans_update_ref(tx.abs(), assign, k)
    tol = 2 * tc[..., None] * 2.0 ** -24 * mag
    assert ((sums - ts).abs() <= tol).all()
    assert (np.abs(sums.numpy() - rs) <= tol.numpy()).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap,hd,chunk", [(16, 32, 8192), (33, 256, 8192),
                                          (2, 4, 16), (4, 8, 48)])
def test_gather_chunks_match_pallas_kernel(cap, hd, chunk, dtype):
    """The CUDA kernel's chunking (one CTA per chunk of K or V, the last
    chunk short, ids out of range zero-filled) in plain code: bit-exact
    against the reference's kernel in interpret mode for ids in range, zeros
    for the rest, and one chunk per CTA of the kernel's grid."""
    from repro_torch.kernels.gather.ref import block_gather_chunked
    rng = np.random.default_rng(cap * hd)
    BH, M, r = 3, 12, 5
    kst, vst = (np.asarray(jnp.asarray(
        rng.standard_normal((BH, M, cap, hd)), jnp.dtype(dtype)))
        for _ in range(2))
    idx = rng.integers(0, M, (BH, r)).astype(np.int32)
    ko, vo = ref_gather(jnp.asarray(idx)[None], jnp.asarray(kst)[None],
                        jnp.asarray(vst)[None], interpret=True)
    bad = idx.copy()
    bad[0, 1], bad[2, 4] = -1, M
    (pk, pv), ctas = block_gather_chunked(
        torch.from_numpy(bad), *(tensor_from_numpy(a, "cpu")
                                 for a in (kst, vst)), chunk)
    esz = np.dtype(np.float32).itemsize if dtype == "float32" else 2
    assert ctas == BH * r * 2 * -(-cap * hd * esz // chunk)
    ok = torch.from_numpy(bad == idx)
    for got, want in ((pk, ko), (pv, vo)):
        want = torch.from_numpy(np.array(want[0], np.float32))
        assert torch.equal(got.float()[ok], want[ok])
        assert (got[~ok] == 0).all()
