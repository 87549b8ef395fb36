"""Gathered-buffer wave attention (``attn_impl="jnp"`` and ``"pallas"``):
the port's merge twin against the reference's Pallas kernel in interpret
mode over the shapes of the reference's own kernel tests, the plain merge's
bf16 cast points, and the port's whole decode attention on a carried-across
reference state for each impl. The CUDA kernel is held against the twin in
``test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RetroConfig as RefRetro
from repro.core import attention as RA
from repro.core.wave_index import max_clusters, prefill_build
from repro.core.zones import plan_zones
from repro.kernels.wave_attention import ops as ref_ops
from repro_torch.configs.base import RetroConfig
from repro_torch.core import attention as PA
from repro_torch.core.zones import ZonePlan
from repro_torch.interop import tensor_from_numpy, wave_states_from_numpy
from repro_torch.kernels.wave_attention import ops as port_ops

torch.set_num_threads(2)
NEG = -1e30
# both sides compute in f32 on the same upcast operands: only the order of
# the f32 sums differs (the reference kernel's tiles are 512 tokens long)
TOL = dict(atol=5e-5, rtol=5e-5)
SHAPES = [  # B, H, G, hd, T, E, softcap (tests/test_kernels.py:18-25)
    (2, 2, 2, 32, 300, 24, None),
    (1, 4, 8, 64, 1024, 100, 50.0),
    (2, 1, 1, 128, 77, 5, None),
    (1, 2, 4, 256, 513, 64, None),
    (3, 3, 2, 64, 128, 1, 30.0),
]


def _merge_inputs(B, H, G, hd, T, E, dtype, seed):
    """numpy inputs: q/k/v in ``dtype`` (float32 or bfloat16), a random
    mask, a tenth of the estimation entries dead."""
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(dtype)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    el = 2 * n(B, H, G, E)
    cs = el - np.abs(n(B, H, G, E))
    el = np.where(rng.random((B, H, G, E)) < 0.9, el, NEG).astype(np.float32)
    return [np.asarray(jnp.asarray(n(B, H, G, hd), dt)),
            np.asarray(jnp.asarray(n(B, H, T, hd), dt)),
            np.asarray(jnp.asarray(n(B, H, T, hd), dt)),
            rng.random((B, H, T)) < 0.8, el, cs, 3 * n(B, H, E, hd)]


def _port(args):
    return [tensor_from_numpy(a, "cpu") for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,hd,T,E,softcap", SHAPES)
def test_merge_matches_pallas_kernel(B, H, G, hd, T, E, softcap, dtype):
    args = _merge_inputs(B, H, G, hd, T, E, dtype, seed=T * E)
    ref = ref_ops.wave_attention_merge(*(jnp.asarray(a) for a in args),
                                       softcap=softcap, interpret=True)
    before = port_ops.wave_attention_merge.launches
    out = port_ops.wave_attention_merge(*_port(args), softcap=softcap)
    assert port_ops.wave_attention_merge.launches == before   # twin, no kernel
    assert out.dtype == torch.float32 and out.shape == (B, H, G, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_merge_all_invalid_estimation():
    """Estimation zone fully masked: exact softmax attention."""
    B, H, G, hd, T, E = 1, 1, 2, 32, 128, 8
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, G, hd), (B, H, T, hd), (B, H, T, hd)))
    valid = np.ones((B, H, T), bool)
    el = np.full((B, H, G, E), NEG, np.float32)
    vs = np.zeros((B, H, E, hd), np.float32)
    args = [q, k, v, valid, el, el, vs]
    out = port_ops.wave_attention_merge(*_port(args)).numpy()
    s = np.einsum("bhgd,bhtd->bhgt", q, k) / np.sqrt(hd)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhgt,bhtd->bhgd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out, want, atol=1e-5)
    ref = ref_ops.wave_attention_merge(*(jnp.asarray(a) for a in args),
                                       interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_merge_jnp_keeps_bf16_cast_points(softcap):
    """The plain merge rounds q (and p) to the bf16 storage dtype as the
    reference does: it matches the reference's jnp merge far closer than
    the all-f32 merge of the kernel does."""
    args = _merge_inputs(2, 2, 4, 64, 300, 24, "bfloat16", seed=5)
    args[0] = np.random.default_rng(6).standard_normal(
        args[0].shape).astype(np.float32)          # q in f32, stores in bf16
    ref = np.asarray(RA.tripartite_merge_jnp(
        *(jnp.asarray(a) for a in args), softcap=softcap))
    targs = _port(args)
    out = PA.tripartite_merge_jnp(*targs, softcap=softcap).numpy()
    err = np.abs(out - ref).max()
    assert err <= 2e-5 * (1 + np.abs(ref).max()), err
    f32 = port_ops.wave_attention_merge(*targs, softcap=softcap).numpy()
    assert np.abs(f32 - ref).max() > 100 * err


def _state(*, n=640, B=2, H=2, hd=32, G=2, seed=0, dtype=jnp.float32):
    retro = RefRetro(avg_cluster=8, cluster_cap=16, prefill_segment=256,
                     update_segment=128, sink=4, local=32, kmeans_iters=3)
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((B, n, H, hd)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, n, H, hd)), jnp.float32)
    state = prefill_build(k, v, retro, max_clusters(n, retro, 128),
                          dtype=dtype)
    q = jnp.asarray(rng.standard_normal((B, G * H, hd)), jnp.float32)
    return q, state, retro, plan_zones(n, retro, 128)


def _port_state(state):
    return wave_states_from_numpy(
        {f: np.asarray(getattr(state, f))[None] for f in state._fields},
        "cpu")[0]


DECODE_CASES = {
    "f32": dict(),
    "softcap_window": dict(seed=3, kw=dict(softcap=50.0, window=128.0)),
    "bf16_stores": dict(seed=13, dtype=jnp.bfloat16),
}


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_reference(case, impl):
    """Rank + estimation + execution buffer + merge of the port on a
    reference ``prefill_build`` state carried across, against the
    reference's decode with the same impl (its Pallas kernel interpreted).
    Each impl matches its own reference within 1e-5; bf16 stores round q
    and p at the same places on both sides."""
    c = dict(DECODE_CASES[case])
    kw = c.pop("kw", {})
    q, state, retro, plan = _state(**c)
    rkw = dict(kw, window=jnp.float32(kw["window"])) if "window" in kw else kw
    ref = RA.wave_attention_decode(q, state, retro, plan, impl=impl, **rkw)
    pretro = RetroConfig(**{f: getattr(retro, f) for f in
                            RetroConfig.__dataclass_fields__})
    out = PA.wave_attention_decode(tensor_from_numpy(q, "cpu"),
                                   _port_state(state), pretro,
                                   ZonePlan(*plan), impl=impl, **kw)
    np.testing.assert_allclose(out.out.numpy(), np.asarray(ref.out),
                               atol=1e-5, rtol=1e-5)


def test_decode_impls_agree():
    """On an f32 state the three impls compute the same attention; they
    differ only in the order of the f32 sums (tests/test_kernels.py:299)."""
    q, state, retro, plan = _state(seed=1)
    pretro = RetroConfig(**{f: getattr(retro, f) for f in
                            RetroConfig.__dataclass_fields__})
    outs = {impl: PA.wave_attention_decode(
        tensor_from_numpy(q, "cpu"), _port_state(state), pretro,
        ZonePlan(*plan), impl=impl).out.numpy()
        for impl in PA.ATTN_IMPLS}
    for impl in ("fused", "pallas"):
        np.testing.assert_allclose(outs[impl], outs["jnp"], atol=1e-5,
                                   rtol=1e-5, err_msg=impl)


def test_unported_hooks_raise():
    """The sharded-retrieval hooks (ported since; held against the reference
    in ``test_torch_distributed.py``) raise with a kernel impl, which they
    would leave unused; an unknown impl raises."""
    q, state, retro, plan = _state(seed=2)
    pretro = RetroConfig(**{f: getattr(retro, f) for f in
                            RetroConfig.__dataclass_fields__})
    args = (tensor_from_numpy(q, "cpu"), _port_state(state), pretro,
            ZonePlan(*plan))
    for impl in ("fused", "pallas"):
        with pytest.raises(ValueError, match="return_parts"):
            PA.wave_attention_decode(*args, impl=impl, return_parts=True)
        with pytest.raises(ValueError, match="include_steady"):
            PA.wave_attention_decode(*args, impl=impl, include_steady=False)
    num, den, m, _ = PA.wave_attention_decode(*args, return_parts=True)
    out = PA.wave_attention_decode(*args).out
    np.testing.assert_allclose((num / den[..., None]).reshape(out.shape),
                               out, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown attn impl"):
        PA.wave_attention_decode(*args, impl="flash")
    assert PA.resolve_attn_impl(None) == "jnp"
