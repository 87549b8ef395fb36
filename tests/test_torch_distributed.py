"""Sharded retrieval (``repro_torch/core/distributed.py``) against the JAX
package on the CPU, on the same numpy inputs: the attention hooks it rides
(``return_parts``, ``cluster_offset``, ``include_steady=False``) against
the reference's within 1e-5; the local plan; the partition specs; a
world-1 gloo group against the serial path within 1e-5; the ranks' parts
combined in one process, and four gloo ranks in spawned processes (their
own 120 s deadline), against the port's serial path and the reference's
single-device path within 1e-4 at full coverage, and within the
reference's bound (e_dist <= 2 e_ser + 1e-3 against full attention) on
clustered keys; a rank that never reaches the collective ends the run at
its deadline. The reference's own multi-shard test is red under this
JAX, so it is not an oracle here.
"""
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import RetroConfig as RefRetro
from repro.core import attention as RA
from repro.core import distributed as RD
from repro.core.wave_index import WaveState as RefWaveState
from repro.core.zones import plan_zones as ref_plan_zones
from repro.data.pipeline import clustered_keys
from repro_torch.configs.base import RetroConfig
from repro_torch.core import attention as PA
from repro_torch.core import distributed as D
from repro_torch.core.wave_index import WaveState, max_clusters, prefill_build
from repro_torch.core.zones import plan_zones
from torch_rank_bodies import sharded_attention, stalling

torch.set_num_threads(2)
PARTS_TOL = dict(atol=1e-5, rtol=1e-5)     # same ops, f32 on both sides
SHARD_TOL = 1e-4                           # sums regrouped across ranks
KW = dict(avg_cluster=8, prefill_segment=256, update_segment=128, sink=4,
          local=32, kmeans_iters=3)
SMALL = dict(cluster_cap=16, **KW)         # tests/test_distributed.py:17
WIDE = dict(cluster_cap=256, **KW)         # its multi-shard setup


def _case(retro_kw, seed=0, B=2, n=1100, H=2, hd=32, keys=None, vals=None):
    """The port's prefill of random (or given) K/V in f32, its state in
    both packages, q, and both plans at ``n`` tokens."""
    rng = np.random.default_rng(seed)
    ref_retro = RefRetro(**retro_kw)
    if keys is None:
        k = rng.standard_normal((B, n, H, hd)).astype(np.float32)
        v = rng.standard_normal((B, n, H, hd)).astype(np.float32)
        q = rng.standard_normal((B, 2 * H, hd)).astype(np.float32)
    else:
        k, v, q = keys, vals, None
    retro = RetroConfig(**retro_kw)
    M = max_clusters(n, retro, 128)
    state = prefill_build(torch.from_numpy(k), torch.from_numpy(v), retro, M,
                          dtype=torch.float32)
    # copies: a tensor sent to a spawned rank moves into shared memory,
    # and an array aliasing its old buffer would dangle
    ref_state = RefWaveState(**{f: jnp.asarray(np.array(getattr(state, f)))
                                for f in WaveState._fields})
    return dict(ref_state=ref_state, state=state, q=q, M=M,
                ref_retro=ref_retro, retro=retro,
                ref_plan=ref_plan_zones(n, ref_retro, 128),
                plan=plan_zones(n, retro, 128))


def _ref_decode(c, plan=None, state=None, **kw):
    """The reference's ``wave_attention_decode`` of case ``c`` (compiled)."""
    plan = c["ref_plan"] if plan is None else plan
    fn = jax.jit(lambda q, st: RA.wave_attention_decode(
        q, st, c["ref_retro"], plan, **kw))
    return fn(jnp.asarray(c["q"]),
              c["ref_state"] if state is None else state)


@pytest.fixture(scope="module")
def small():
    return _case(SMALL)


def test_local_plan_ceil():
    plan = plan_zones(1100, RetroConfig(**SMALL), 128)._replace(r=10, e=33)
    lp = D.local_plan(plan, 4)
    assert (lp.r, lp.e) == (3, 9)
    assert RD.local_plan(plan, 4) == lp


@pytest.mark.parametrize("variant", ["whole", "cluster_offset",
                                     "no_steady"])
def test_return_parts_match_reference(small, variant):
    """(num, den, m) and the retrieved ids: the whole state, rank 1's half
    of the cluster axis at its offset, and the state without the steady
    zone."""
    c = small
    ref_state, state = c["ref_state"], c["state"]
    kw = dict(cluster_offset=0, include_steady=True)
    if variant == "cluster_offset":
        m_loc = c["M"] // 2
        ref_state = ref_state._replace(**{
            f: getattr(ref_state, f)[:, :, m_loc:] for f in D.CLUSTER_FIELDS})
        state = D.shard_state(state, 1, 2)
        kw["cluster_offset"] = m_loc
    if variant == "no_steady":
        kw["include_steady"] = False
    ref = _ref_decode(c, state=ref_state, softcap=30.0, return_parts=True,
                      **kw)
    got = PA.wave_attention_decode(torch.from_numpy(c["q"]), state,
                                   c["retro"], c["plan"], softcap=30.0,
                                   return_parts=True, **kw)
    for g, r, name in zip(got[:3], ref[:3], ("num", "den", "m")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **PARTS_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("hook", ["return_parts", "include_steady"])
def test_kernel_impls_refuse_the_sharding_hooks(small, impl, hook):
    kw = {"return_parts": True} if hook == "return_parts" \
        else {"include_steady": False}
    with pytest.raises(ValueError, match="execution-buffer"):
        PA.wave_attention_decode(torch.from_numpy(small["q"]), small["state"],
                                 small["retro"], small["plan"], impl=impl,
                                 **kw)


def test_cluster_sharded_specs_match_reference(small):
    got = D.state_specs_cluster_sharded(small["state"])
    want = RD.state_specs_cluster_sharded(small["ref_state"])
    for f in WaveState._fields:
        assert tuple(getattr(got, f)) == tuple(getattr(want, f)), f


def test_single_rank_group_equals_serial(small):
    """A world-1 gloo group: local top r is the global top r."""
    q = torch.from_numpy(small["q"])
    serial = PA.wave_attention_decode(q, small["state"], small["retro"],
                                      small["plan"]).out
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method="file://"
                            + os.path.join(tmp, "rdv"), rank=0, world_size=1)
    try:
        got = D.distributed_wave_attention(q, small["state"], small["retro"],
                                           small["plan"])
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.numpy(), serial.numpy(), **PARTS_TOL)


def _combine(parts):
    """The ranks' (num, den, m) merged as ``merge_parts`` does, in one
    process."""
    m_glob = torch.stack([m for _, _, m in parts]).amax(0)
    num = sum(n * torch.exp(m - m_glob)[..., None] for n, _, m in parts)
    den = sum(d * torch.exp(m - m_glob) for _, d, m in parts)
    return num / torch.clamp(den, min=1e-30)[..., None]


@pytest.fixture(scope="module")
def wide():
    c = _case(WIDE, B=2, n=2084)
    keys, qv, _ = clustered_keys(2084, 32, n_hot=6, seed=1)
    vals = np.random.default_rng(0).standard_normal((2084, 32)) \
        .astype(np.float32)
    k2 = np.repeat(np.repeat(keys[None, :, None, :], 2, 0), 2, 2)
    v2 = np.repeat(np.repeat(vals[None, :, None, :], 2, 0), 2, 2)
    c2 = _case(WIDE, B=2, n=2084, keys=k2, vals=v2)
    c2["q"] = np.repeat(np.repeat(qv[None, None, :], 2, 0), 4, 1)
    cache = RA.DenseCache(jnp.swapaxes(jnp.asarray(k2), 1, 2),
                          jnp.swapaxes(jnp.asarray(v2), 1, 2),
                          jnp.full((2,), 2084, jnp.int32))
    c2["full"] = np.asarray(RA.full_attention_decode(jnp.asarray(c2["q"]),
                                                     cache))
    # full coverage (r = every cluster, e = 0): the port's serial path and
    # the reference's
    c["full_plan"] = c["plan"]._replace(r=c["M"], e=0)
    c["serial"] = PA.wave_attention_decode(
        torch.from_numpy(c["q"]), c["state"], c["retro"],
        c["full_plan"]).out.numpy()
    c["ref"] = np.asarray(_ref_decode(
        c, c["ref_plan"]._replace(r=c["M"], e=0)).out)
    return c, c2


def test_shard_parts_combine_to_serial(wide):
    """Four ranks' parts merged in one process at full coverage (r = every
    cluster, e = 0) against the port's serial path and the reference's."""
    c = wide[0]
    q = torch.from_numpy(c["q"])
    parts = [D.shard_wave_attention(q, D.shard_state(c["state"], i, 4),
                                    c["retro"], c["full_plan"], rank=i,
                                    n_shards=4)
             for i in range(4)]
    got = _combine(parts).reshape(q.shape).numpy()
    assert np.abs(got - c["serial"]).max() < SHARD_TOL
    assert np.abs(got - c["ref"]).max() < SHARD_TOL


def test_four_gloo_ranks(wide):
    """Four gloo ranks in spawned processes (120 s deadline): every rank
    gets the same result; at full coverage it matches serial within 1e-4;
    with the default plan on clustered keys its error against full
    attention is within the reference's bound of the serial error."""
    c, c2 = wide
    q2 = torch.from_numpy(c2["q"])
    res = D.run_ranks(sharded_attention, 4,
                      (torch.from_numpy(c["q"]), c["state"], c["retro"],
                       c["full_plan"], q2, c2["state"], c2["plan"]),
                      timeout=120)
    for r in res:
        np.testing.assert_array_equal(r[0], res[0][0])
        np.testing.assert_array_equal(r[1], res[0][1])
    assert np.abs(res[0][0] - c["serial"]).max() < SHARD_TOL
    assert np.abs(res[0][0] - c["ref"]).max() < SHARD_TOL
    ser2 = PA.wave_attention_decode(q2, c2["state"], c2["retro"],
                                    c2["plan"]).out.numpy()
    ref2 = np.asarray(_ref_decode(c2).out)
    e_ser = float(np.linalg.norm(ser2 - c2["full"]))
    e_ref = float(np.linalg.norm(ref2 - c2["full"]))
    e_dist = float(np.linalg.norm(res[0][1] - c2["full"]))
    assert abs(e_ser - e_ref) <= 1e-4 * (1 + e_ref), (e_ser, e_ref)
    assert e_dist <= 2.0 * e_ser + 1e-3, (e_ser, e_dist)


def test_rank_that_never_joins_ends_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not return"):
        D.run_ranks(stalling, 2, timeout=3)
    assert time.monotonic() - t0 < 60
