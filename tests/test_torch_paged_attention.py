"""Paged wave attention: the port's plain twin against the Pallas kernel in
interpret mode and against its jnp emulation, over the cases of the
reference's own kernel tests; the port's rank/estimation/decode against the
reference's fused decode. The CUDA kernel is held against the twin in
``test_torch_cuda_kernels.py``."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RetroConfig as RefRetro
from repro.core import attention as RA
from repro.core.wave_index import append_token, prefill_build
from repro.core.zones import plan_zones
from repro.kernels.wave_attention import ops as ref_ops
from repro_torch.configs.base import RetroConfig
from repro_torch.core import attention as PA
from repro_torch.core.zones import ZonePlan
from repro_torch.interop import tensor_from_numpy, wave_states_from_numpy
from repro_torch.kernels.wave_attention import ops as port_ops

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
BASE = dict(avg_cluster=8, cluster_cap=16, prefill_segment=256,
            update_segment=128, sink=4, local=32, kmeans_iters=3)
ARG_NAMES = port_ops.ARG_NAMES


def _state(G=4, n=640, B=2, H=2, hd=32, seed=0, lengths=None, retro_kw=None,
           n_append=0, dtype=jnp.float32):
    retro = RefRetro(**{**BASE, **(retro_kw or {})})
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((B, n, H, hd)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, n, H, hd)), jnp.float32)
    plan = plan_zones(n, retro, 128)
    state = prefill_build(k, v, retro, plan.m_max, dtype=dtype,
                          lengths=lengths)
    for _ in range(n_append):
        kn = jnp.asarray(rng.standard_normal((B, H, hd)), jnp.float32)
        state = append_token(state, kn, kn)
    q = jnp.asarray(rng.standard_normal((B, G * H, hd)), jnp.float32)
    return q, state, retro, plan


def _capture(q, state, retro, plan, **kw):
    """Run the reference's fused decode once and capture the exact
    arguments it hands the paged kernel (as numpy)."""
    seen = {}
    orig = ref_ops.paged_wave_attention

    def spy(*a, **k):
        seen["args"] = [np.asarray(x) for x in a]
        seen["softcap"] = k.get("softcap")
        return orig(*a, **k)

    with mock.patch.object(ref_ops, "paged_wave_attention", spy):
        RA.wave_attention_decode(q, state, retro, plan, impl="fused", **kw)
    return seen["args"], seen["softcap"]


def _port_args(args):
    return [tensor_from_numpy(a, "cpu") for a in args]


def _check(args, softcap):
    """Twin vs Pallas interpret and vs jnp emulation."""
    out = port_ops.paged_wave_attention(*_port_args(args),
                                        softcap=softcap).numpy()
    jargs = [jnp.asarray(a) for a in args]
    for emulate in (False, True):
        ref = ref_ops.paged_wave_attention(*jargs, softcap=softcap,
                                           interpret=True, emulate=emulate)
        np.testing.assert_allclose(out, np.asarray(ref), **TOL,
                                   err_msg=f"emulate={emulate}")
    return out


CASES = {
    "G1": dict(G=1),
    "G2": dict(G=2),
    "G4": dict(G=4),
    "G8": dict(G=8),
    "softcap": dict(seed=3, kw=dict(softcap=30.0)),
    "window": dict(seed=3, kw=dict(window=jnp.float32(200.0))),
    "softcap_window": dict(seed=3, kw=dict(softcap=50.0,
                                           window=jnp.float32(128.0))),
    "no_overflow_corr": dict(seed=5, kw=dict(overflow_correction=False)),
    "no_estimation": dict(seed=5, kw=dict(use_estimation=False,
                                          overflow_correction=False)),
    "plan_e_zero": dict(seed=7, retro_kw=dict(
        cluster_cap=64, prefill_segment=64, update_segment=32,
        retrieval_frac=1.0, estimation_frac=0.0)),
    "ragged_rows": dict(seed=9, n=512, n_append=5,
                        lengths=jnp.asarray([512, 300], jnp.int32)),
    "steady_only_r0": dict(seed=11, n=24, retro_kw=dict(local=64)),
    "bf16_stores": dict(G=2, seed=13, dtype=jnp.bfloat16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_pallas_kernel(case):
    c = dict(CASES[case])
    kw = c.pop("kw", {})
    q, state, retro, plan = _state(**c)
    if case == "plan_e_zero":
        assert plan.e == 0
    if case == "steady_only_r0":
        assert plan.r == 0 and plan.e == 0
    args, softcap = _capture(q, state, retro, plan, **kw)
    _check(args, softcap)


def test_twin_live_mask():
    q, state, retro, plan = _state(G=2, seed=29)
    args, softcap = _capture(q, state, retro, plan)
    live = ARG_NAMES.index("live")
    args[live] = np.random.default_rng(31).integers(
        0, 2, args[live].shape).astype(np.int32)
    assert 0 < args[live].sum() < args[live].size
    _check(args, softcap)


def test_twin_cache_slot_indirection():
    """The kernel is agnostic to what the id-addressed block store is:
    permuting the retrieved blocks into a slot store and passing slots
    reproduces the direct result bit for bit."""
    q, state, retro, plan = _state(G=2, seed=21)
    args, softcap = _capture(q, state, retro, plan)
    direct = _check(args, softcap)
    i = {n: ARG_NAMES.index(n) for n in ("k_store", "v_store", "pos_store",
                                         "idx_r")}
    idx = args[i["idx_r"]]
    slot_args = list(args)
    for name in ("k_store", "v_store", "pos_store"):
        a = args[i[name]]
        slot_args[i[name]] = np.take_along_axis(
            a, idx.reshape(idx.shape + (1,) * (a.ndim - 3)), axis=2)
    slot_args[i["idx_r"]] = np.broadcast_to(
        np.arange(idx.shape[2], dtype=np.int32), idx.shape).copy()
    via_slots = port_ops.paged_wave_attention(*_port_args(slot_args),
                                              softcap=softcap).numpy()
    np.testing.assert_array_equal(direct, via_slots)


def _port_state(state):
    return wave_states_from_numpy(
        {f: np.asarray(getattr(state, f))[None] for f in state._fields},
        "cpu")[0]


@pytest.mark.parametrize("case", ["G4", "softcap_window", "ragged_rows",
                                  "steady_only_r0", "bf16_stores"])
def test_decode_attention_matches_reference(case):
    """rank_clusters + estimation zone + fused attention of the port on a
    carried-across state vs the reference's fused decode."""
    c = dict(CASES[case])
    kw = c.pop("kw", {})
    q, state, retro, plan = _state(**c)
    ref = RA.wave_attention_decode(q, state, retro, plan, impl="fused", **kw)
    pst = _port_state(state)
    pplan = ZonePlan(*plan)
    pretro = RetroConfig(**{**BASE, **c.get("retro_kw", {})})
    win = kw.get("window")
    pkw = dict(softcap=kw.get("softcap"),
               window=None if win is None else float(win))
    out = PA.wave_attention_decode(tensor_from_numpy(q, "cpu"), pst,
                                   pretro, pplan, impl="fused", **pkw)
    np.testing.assert_allclose(out.out.numpy(), np.asarray(ref.out), **TOL)

    # ranking: scores agree; ids agree on live (non-NEG) clusters
    B, H = state.centroid.shape[:2]
    qg = q.reshape(B, H, -1, q.shape[-1])
    cs_ref, idx_ref = RA.rank_clusters(qg, state, plan, kw.get("window"),
                                       kw.get("softcap"))
    cs, idx = PA.rank_clusters(tensor_from_numpy(qg, "cpu"), pst, pplan,
                               pkw["window"], pkw["softcap"])
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_ref), **TOL)
    score = np.asarray(cs_ref).max(axis=2)
    live = np.take_along_axis(score, np.asarray(idx_ref), axis=2) > RA.NEG / 2
    np.testing.assert_array_equal(idx.numpy()[live], np.asarray(idx_ref)[live])


def test_wrapper_rejects_bad_inputs():
    q, state, retro, plan = _state(G=2, seed=1)
    args = _port_args(_capture(q, state, retro, plan)[0])
    bad = list(args)
    bad[ARG_NAMES.index("idx_r")] = bad[ARG_NAMES.index("idx_r")].long()
    with pytest.raises(TypeError):
        port_ops.paged_wave_attention(*bad)
    bad = list(args)
    bad[ARG_NAMES.index("local_k")] = bad[ARG_NAMES.index("local_k")][:, :, ::2]
    with pytest.raises(ValueError):
        port_ops.paged_wave_attention(*bad)
