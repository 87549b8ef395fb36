"""The non-attention families' bf16 model path against the JAX package:
reduced rwkv6-3b, zamba2-1.2b and whisper-tiny with ``dtype="bfloat16"``,
the port and the reference on the same numpy parameters on the CPU: the
prefill, then three decode steps (retro runtime, ``jnp`` impl) from the
reference's prefill state carried over bit for bit
(``serve_state_from_numpy``).

The reference is compiled with ``xla_allow_excess_precision=False``, so it
rounds at every bf16 cast point its source writes, as the port does (see
``test_torch_bf16.py``). The cast points these families add: the silu of
the mamba2 gate and conv and of rwkv6's ``g`` (``layers.silu``, op for
op), rwkv6's squared relu and sigmoid in bf16, the decay's and dt's
``exp`` / ``softplus`` in f32, and the bf16 cast of the sinusoidal table
before its add (whisper's encoder).

Tolerance: logits within one bf16 ulp of the row's largest logit
(``row_ulps``). A bf16 matrix product sums in f32 in another order than
XLA's, which moves a product's rounding by one ulp now and then; the
prefill holds that within the tolerance. From one state the decode steps
of rwkv6 and whisper give the same bits; zamba2's differ in the last f32
place of its ``ssm`` state (XLA's f32 ``exp`` and ``log1p`` in dt and the
decay are not torch's), a few millionths of an ulp of the largest logit
(``-s``). (Each package decoding from its own prefill
state differs by more in whisper: the encoder's one-ulp differences reach
every frame through its attention, and the cross K/V carry them into
every step; reduced whisper measured up to 3.5 ulps.) Run ``-s`` to see
the numbers.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import model as RM
from repro_torch.configs import registry
from repro_torch.core.zones import plan_zones
from repro_torch.interop import params_from_numpy, serve_state_from_numpy
from repro_torch.models import model as M

torch.set_num_threads(2)
S, HEADROOM = 96, 64
NO_EXCESS = {"xla_allow_excess_precision": False}


def bf16_ulp(x):
    """The bf16 ulp at magnitude ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def row_ulps(port, want):
    """max |port - want| per row in bf16 ulps of the row's largest |want|;
    the largest over the rows."""
    port, want = np.asarray(port, np.float32), np.asarray(want, np.float32)
    d = np.abs(port - want).max(-1)
    return float((d / bf16_ulp(np.abs(want).max(-1))).max())


def _numpy_tree(x):
    """A reference state as nested dicts of numpy arrays (bf16 leaves stay
    bf16)."""
    if hasattr(x, "_fields"):
        return {f: _numpy_tree(getattr(x, f)) for f in x._fields}
    return np.asarray(x)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_1p2b", "whisper_tiny"])
def test_bf16_family_matches_reference(arch):
    ref_cfg = importlib.import_module(f"repro.configs.{arch}").reduced() \
        .replace(dtype="bfloat16")
    cfg = registry.reduced_config(arch).replace(dtype="bfloat16")
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    assert params["embed"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    pbatch = {"tokens": torch.from_numpy(toks)}
    if cfg.family == "audio":
        frames = jnp.asarray(rng.standard_normal(
            (2, cfg.encoder_frames, cfg.d_model)), jnp.bfloat16)
        batch["frames"] = frames
        pbatch["frames"] = torch.from_numpy(
            np.asarray(frames.astype(jnp.float32))).to(torch.bfloat16)
    ssm = cfg.family == "ssm"
    ref_plan = None if ssm else ref_plan_zones(S, ref_cfg.retro, HEADROOM)
    plan = None if ssm else plan_zones(S, cfg.retro, HEADROOM)
    prefill = _compile(lambda p, b: RM.apply_prefill(
        p, ref_cfg, b, plan=ref_plan, gen_headroom=HEADROOM),
        ref_params, batch)
    ref_lg, ref_st = prefill(ref_params, batch)
    lg, st = M.apply_prefill(params, cfg, pbatch, plan=plan,
                             gen_headroom=HEADROOM)
    errs = [row_ulps(lg.numpy(), ref_lg)]
    state = serve_state_from_numpy(_numpy_tree(ref_st), "cpu")
    dec = None
    for t in range(3):
        tok = jnp.asarray(rng.integers(0, cfg.vocab, (2,)), jnp.int32)
        if dec is None:
            dec = _compile(lambda p, s, t: RM.apply_decode(
                p, ref_cfg, s, t, plan=ref_plan, attn_impl="jnp"),
                ref_params, ref_st, tok)
        ref_lg, ref_st = dec(ref_params, ref_st, tok)
        lg, state = M.apply_decode(params, cfg, state,
                                   torch.from_numpy(np.asarray(tok)),
                                   plan=plan, attn_impl="jnp")
        errs.append(row_ulps(lg.numpy(), ref_lg))
    print(f"\n{arch} bf16: prefill, then 3 decode steps from the reference's "
          f"state: max |d| in ulps of the largest logit: "
          f"{['%.3f' % e for e in errs]}")
    assert max(errs) <= 1.0, errs
