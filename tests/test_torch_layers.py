"""Port layers against ``repro.models.layers`` on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as PL

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), **TOL)


def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((3, 5, 64)).astype(np.float32))
    gj, gt = _pair(0.1 * rng.standard_normal(64).astype(np.float32))
    _close(RL.rms_norm(xj, gj, 1e-6), PL.rms_norm(xt, gt, 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 7, 3, 32)).astype(np.float32))
    pos = rng.integers(0, 20000, (2, 7)).astype(np.int32)
    pj, pt = _pair(pos)
    _close(RL.apply_rope(xj, pj, theta), PL.apply_rope(xt, pt, theta))


@pytest.mark.parametrize("cap", [None, 0.0, 30.0])
def test_soft_cap(cap):
    rng = np.random.default_rng(2)
    sj, st = _pair(40 * rng.standard_normal((4, 9)).astype(np.float32))
    _close(RL.soft_cap(sj, cap), PL.soft_cap(st, cap))


def _proj(rng, shape):
    return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


def test_attention_qkv():
    rng = np.random.default_rng(3)
    d, H, Hkv, hd = 64, 4, 2, 16
    p = {"wq": _proj(rng, (d, H * hd)), "wk": _proj(rng, (d, Hkv * hd)),
         "wv": _proj(rng, (d, Hkv * hd))}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None, :] + np.array([[0], [300]],
                                                           np.int32)
    ref = RL.attention_qkv({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), H, Hkv, hd, jnp.asarray(pos),
                           10_000.0)
    out = PL.attention_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), H, Hkv, hd,
                           torch.from_numpy(pos), 10_000.0)
    for j, t in zip(ref, out):
        _close(j, t)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_apply(act):
    rng = np.random.default_rng(4)
    d, f = 64, 128
    p = {"w_gate": _proj(rng, (d, f)), "w_up": _proj(rng, (d, f)),
         "w_down": _proj(rng, (f, d))}
    x = rng.standard_normal((3, d)).astype(np.float32)
    _close(RL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act),
           PL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), act))
