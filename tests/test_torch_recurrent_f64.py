"""Is the recurrent states' f32 drift against the reference rounding, or an
operation order that differs? Reduced rwkv6-3b and zamba2-1.2b (full
runtime at its attention sites), prefill and six decode steps, with every
f32 compute point of both packages promoted to f64: the reference under
``jax_enable_x64`` with ``jnp.float32`` read as ``float64`` in its model
modules, the port with ``Tensor.float`` and ``torch.float32`` read as f64
in its own, both from the same f64 parameters.

If the port computed a different function (another order of operations
that matters, a missing term), the f64 gap would stay near the f32 one
(~1e-6 of the largest ``wkv`` entry, ``test_torch_rwkv6.py``). It falls to
f64 rounding: every state and logit within 1e-12 (1 + max |ref|) of its
layer, about 2^-40, a million times under the f32 bound (measured: 1e-16
to 2e-15 on every state, logits included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.core import attention as RA
from repro.models import hybrid as RH
from repro.models import layers as RL
from repro.models import mamba2 as RMB
from repro.models import model as RM
from repro.models import rwkv6 as RR
from repro.models import transformer as RT
from repro_torch.configs.registry import reduced_config
from repro_torch.core import attention as PA
from repro_torch.interop import params_from_numpy, serve_state_to_numpy
from repro_torch.models import hybrid as PH
from repro_torch.models import layers as PL
from repro_torch.models import mamba2 as PMB
from repro_torch.models import model as M
from repro_torch.models import rwkv6 as PR
from repro_torch.models import transformer as PT

torch.set_num_threads(2)
F64_TOL = 1e-12
T, STEPS, HEADROOM = 96, 6, 64


class _Promoted:
    """A module seen with its ``float32`` read as ``float64``."""

    def __init__(self, mod, f64):
        self._mod, self.float32 = mod, f64

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.fixture
def f64(monkeypatch):
    """Both packages' f32 compute points promoted to f64 for one test."""
    for mod in (RA, RH, RL, RMB, RM, RR, RT):
        monkeypatch.setattr(mod, "jnp", _Promoted(jnp, jnp.float64))
    for mod in (PA, PH, PL, PMB, M, PR, PT):
        monkeypatch.setattr(mod, "torch", _Promoted(torch, torch.float64))
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _tree64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), tree)


def _per_layer_err(got, want):
    """max over layers of |got - want| / (1 + max |want|) in that layer."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want).reshape(len(want), -1).max(-1)
    return (d / (1 + np.abs(want).reshape(len(want), -1).max(-1))).max()


def _states(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_states(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ("rwkv6_3b", "zamba2_1p2b"))
def test_recurrent_state_gap_is_rounding(f64, arch):
    ref_cfg = ref_reduced(arch).replace(dtype="float64")
    cfg = reduced_config(arch).replace(dtype="float64")
    params = _tree64(RM.init_params(ref_reduced(arch),
                                    jax.random.PRNGKey(3)))
    ref_params = jax.tree.map(jnp.asarray, params)
    pparams = params_from_numpy(params, cfg, "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, T)).astype(np.int32)
    kw = {} if arch == "rwkv6_3b" else dict(runtime="full",
                                            gen_headroom=HEADROOM)
    ref_lg, ref_state = RM.apply_prefill(
        ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, **kw)
    with torch.no_grad():
        lg, state = M.apply_prefill(pparams, cfg,
                                    {"tokens": torch.from_numpy(toks)}, **kw)
    assert lg.dtype == torch.float64
    errs = {"prefill logits": _per_layer_err(lg.numpy()[None],
                                             np.asarray(ref_lg)[None])}
    dec = {} if arch == "rwkv6_3b" else dict(runtime="full", seq_len=T,
                                             gen_headroom=HEADROOM)
    for step in range(STEPS):
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        ref_lg, ref_state = RM.apply_decode(ref_params, ref_cfg, ref_state,
                                            jnp.asarray(tok), **dec)
        with torch.no_grad():
            lg, state = M.apply_decode(pparams, cfg, state,
                                       torch.from_numpy(tok), **dec)
        errs[f"step {step} logits"] = _per_layer_err(
            lg.numpy()[None], np.asarray(ref_lg)[None])
    got = _states(serve_state_to_numpy(state))
    want = _states(jax.tree.map(np.asarray, _asdict(ref_state)))
    assert set(got) == set(want)
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            errs[k] = _per_layer_err(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("wkv", "mamba.ssm"):
        if k in want:
            assert want[k].dtype == np.float64 and np.abs(want[k]).max() > 0.1
    assert max(errs.values()) <= F64_TOL, errs


def _asdict(x):
    if hasattr(x, "_fields"):
        return {f: _asdict(getattr(x, f)) for f in x._fields}
    if isinstance(x, list):
        return [_asdict(v) for v in x]
    return x
