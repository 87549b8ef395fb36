"""The MoE family against the JAX package: ``models/moe.py`` on the same
numpy inputs and weights (f32 and bf16, with and without dropped tokens,
one and two dispatch groups, top-2 of 8 and top-8 of 16), and reduced
mixtral-8x22b and kimi-k2 end to end (ragged blocking prefill, chunked
prefill at two chunk sizes, decode under ``jnp``, ``fused``, ``pallas`` and
the full runtime), with parameters carried over by
``interop.params_from_numpy``.

Tolerances. f32: within 1e-5 (1 + |ref|) for one MoE call and 1e-4 for
model logits (matrix products sum in other orders than XLA's). bf16: the
reference is compiled with ``xla_allow_excess_precision=False`` (the cast
points its source writes, as ``tests/test_torch_bf16.py`` does), and the
port's y is held within one bf16 ulp of the row's largest |y|, the model's
logits within one ulp of the row's largest logit. The aux loss, an f32 sum
of means over the same routing, within 1e-6 relative. The reference's
Pallas kernels run in interpret mode (``attn_impl="fused"``/``"pallas"``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import kimi_k2_1t_a32b as ref_kimi
from repro.configs import mixtral_8x22b as ref_mixtral
from repro.configs.base import MoEConfig as RefMoE
from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.models import transformer as RT
from repro_torch.configs import kimi_k2_1t_a32b, mixtral_8x22b
from repro_torch.configs.base import MoEConfig
from repro_torch.core.zones import plan_zones
from repro_torch.interop import (params_from_numpy, serve_state_from_numpy,
                                 tensor_from_numpy)
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as PT
from test_torch_bf16 import NO_EXCESS, row_ulps

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
S, HEADROOM, LENS = 320, 128, (300, 200)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# one MoE call
# ---------------------------------------------------------------------------

# name -> (num_experts, top_k, capacity_factor): 4.0 keeps every token,
# 0.5 drops about half of them
MOE_CASES = {"top2of8": (8, 2, 4.0), "top2of8_drops": (8, 2, 0.5),
             "top8of16": (16, 8, 4.0), "top8of16_drops": (16, 8, 0.5)}
T, D, F = 64, 32, 48


def _moe_inputs(E, dtype, seed=0):
    """x (T, D) and the layer's weights as numpy: router f32, experts in
    ``dtype``, each scaled by its fan-in."""
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    nrm = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"router": (nrm(D, E) / np.sqrt(D)).astype(np.float32),
         "w_gate": (nrm(E, D, F) / np.sqrt(D)).astype(dt),
         "w_up": (nrm(E, D, F) / np.sqrt(D)).astype(dt),
         "w_down": (nrm(E, F, D) / np.sqrt(F)).astype(dt)}
    return nrm(T, D).astype(dt), p


def _dropped(x, p, cfg):
    """Token replicas past their expert's capacity, counted in numpy."""
    logits = x.astype(np.float32) @ p["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    counts = np.bincount(top.reshape(-1), minlength=cfg.num_experts)
    C = moe.expert_capacity(x.shape[0], cfg)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case, dtype, groups):
    E, K, cf = MOE_CASES[case]
    cfg, ref_cfg = MoEConfig(E, K, F, capacity_factor=cf), \
        RefMoE(E, K, F, capacity_factor=cf)
    x, p = _moe_inputs(E, dtype)
    if groups == 1:
        assert (_dropped(x, p, cfg) > 0) == case.endswith("drops")
    fn = functools.partial(RMoE.moe_apply_grouped, moe=ref_cfg, act="silu",
                           groups=groups)
    args = ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    options = NO_EXCESS if dtype == "bfloat16" else None
    ref_y, ref_aux = jax.jit(fn).lower(*args).compile(
        compiler_options=options)(*args)
    y, aux = moe.moe_apply_grouped(
        {k: tensor_from_numpy(v, "cpu") for k, v in p.items()},
        tensor_from_numpy(x, "cpu"), cfg, "silu", groups=groups)
    assert y.dtype == (torch.bfloat16 if dtype == "bfloat16"
                       else torch.float32)
    ref_y = np.asarray(ref_y, np.float32)
    if dtype == "bfloat16":
        assert row_ulps(y.float().numpy(), ref_y) <= 1.0
    else:
        np.testing.assert_allclose(y.numpy(), ref_y, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)


def test_moe_combine_order_is_the_references():
    """f32, top-8 of 16 with drops, bit for bit. The router's
    probabilities are patched in both packages to distinct powers of two
    (so the routing, the normalised weights and their sums are the same
    bits in both), and the experts scale their input exactly (silu of
    40 x >= 40 is 40 x), so every contribution is the same bits: what
    remains is the order in which each token's contributions are added,
    ascending expert id as the reference's scatter-add, not the top-k
    order."""
    from unittest import mock
    E, K, cf = MOE_CASES["top8of16_drops"]
    cfg, ref_cfg = MoEConfig(E, K, F, capacity_factor=cf), \
        RefMoE(E, K, F, capacity_factor=cf)
    rng = np.random.default_rng(3)
    x = rng.uniform(1.0, 2.0, (T, D)).astype(np.float32)
    probs = np.stack([2.0 ** -rng.permutation(E) for _ in range(T)]) \
        .astype(np.float32)
    eye = np.eye(D, F, dtype=np.float32)
    p = {"router": np.zeros((D, E), np.float32),
         "w_gate": np.repeat(eye[None] * 40.0, E, 0),
         "w_up": np.stack([eye * (e + 1) / 7 for e in range(E)]),
         "w_down": np.repeat(eye.T[None], E, 0)}
    with mock.patch.object(jax.nn, "softmax",
                           lambda l, axis=-1: jnp.asarray(probs)):
        ref_y, _ = RMoE.moe_apply(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), ref_cfg)
    with mock.patch.object(torch, "softmax",
                           lambda l, dim=-1: torch.from_numpy(probs)):
        y, _ = moe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg)
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    counts = np.bincount(top.reshape(-1), minlength=E)
    assert (counts > moe.expert_capacity(T, cfg)).any()     # drops happen
    assert (np.diff(top, axis=-1) < 0).any()       # top-k order != id order
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_y))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 256, 16384])
def test_expert_capacity_matches_reference(n):
    for cfg in (mixtral_8x22b.CONFIG.moe, kimi_k2_1t_a32b.CONFIG.moe,
                MoEConfig(4, 2, 8, capacity_factor=0.5)):
        # the reference's fields only: the port's share-layer fields follow
        ref = RefMoE(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(RefMoE)})
        assert moe.expert_capacity(n, cfg) == RMoE.expert_capacity(n, ref)
    assert moe.expert_capacity(256, mixtral_8x22b.CONFIG.moe) == 80
    assert moe.expert_capacity(16384, mixtral_8x22b.CONFIG.moe) == 5120


def test_init_moe_shapes_and_scales():
    """The router in f32, the experts stacked in the model dtype, each
    scaled by its own fan-in (not by the expert count)."""
    cfg = MoEConfig(6, 2, 256)
    p = moe.init_moe(torch.Generator().manual_seed(0), 64, cfg,
                     torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32
    assert tuple(p["router"].shape) == (64, 6)
    for k, shape, fan_in in (("w_gate", (6, 64, 256), 64),
                             ("w_up", (6, 64, 256), 64),
                             ("w_down", (6, 256, 64), 256)):
        assert p[k].dtype == torch.bfloat16 and tuple(p[k].shape) == shape
        assert abs(p[k].float().std().item() * fan_in ** 0.5 - 1) < 0.05
    assert len({p[k][0].float().sum().item() for k in p if k != "router"}
               | {p["w_gate"][1].float().sum().item()}) == 4


# ---------------------------------------------------------------------------
# reduced mixtral and kimi end to end
# ---------------------------------------------------------------------------

ARCHS = {"mixtral": (ref_mixtral, mixtral_8x22b),
         "kimi": (ref_kimi, kimi_k2_1t_a32b)}


@functools.lru_cache(maxsize=None)
def _models(arch):
    ref_mod, mod = ARCHS[arch]
    ref_cfg, cfg = ref_mod.reduced(), mod.reduced()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(1))
    return ref_cfg, ref_params, cfg, params_from_numpy(
        _np_tree(ref_params), cfg, "cpu")


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((2, S), np.int32)
    for b, n in enumerate(LENS):
        toks[b, :n] = rng.integers(0, vocab, n)
    return toks


def test_moe_params_carry_over():
    """The reference's stacked (L, E, ...) expert leaves become per-layer
    (E, ...) tensors, the router stays f32, bit for bit."""
    ref_cfg, ref_params, cfg, params = _models("mixtral")
    assert "mlp" not in params["layers"][0]
    for i, lp in enumerate(params["layers"]):
        for k, leaf in ref_params["layers"]["moe"].items():
            want = np.asarray(leaf[i])
            assert tuple(lp["moe"][k].shape) == want.shape
            assert lp["moe"][k].dtype == torch.float32      # an f32 config
            np.testing.assert_array_equal(lp["moe"][k].numpy(), want)
    assert tuple(params["layers"][0]["moe"]["w_down"].shape) == \
        (cfg.moe.num_experts, cfg.moe.d_expert, cfg.d_model)
    bf = ref_mixtral.reduced().replace(dtype="bfloat16")
    bf_params = params_from_numpy(
        _np_tree(RM.init_params(bf, jax.random.PRNGKey(1))),
        mixtral_8x22b.reduced().replace(dtype="bfloat16"), "cpu")
    lp = bf_params["layers"][1]["moe"]
    assert lp["router"].dtype == torch.float32
    assert lp["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_ragged_matches_reference(arch):
    ref_cfg, ref_params, cfg, params = _models(arch)
    toks = _prompts(cfg.vocab)
    ref_lg, _ = RM.apply_prefill(ref_params, ref_cfg,
                                 {"tokens": jnp.asarray(toks)},
                                 gen_headroom=HEADROOM,
                                 lengths=jnp.asarray(LENS, jnp.int32))
    lg, _ = M.apply_prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                            gen_headroom=HEADROOM,
                            lengths=torch.tensor(LENS, dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)


@pytest.mark.parametrize("chunk", [64, 96])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_chunks_match_reference(arch, chunk):
    """Every chunk's logits, two chunk sizes (the capacity is per call, so
    each split is held against the same split of the reference)."""
    ref_cfg, ref_params, cfg, params = _models(arch)
    toks = _prompts(cfg.vocab, seed=1)
    step = jax.jit(functools.partial(RM.apply_prefill_chunk, cfg=ref_cfg))
    rcs = RM.make_prefill_chunk_state(ref_cfg, 2, S, chunk=chunk,
                                      gen_headroom=HEADROOM)
    cs = M.make_prefill_chunk_state(cfg, 2, S, chunk=chunk,
                                    gen_headroom=HEADROOM, device="cpu")
    for c0 in range(0, max(LENS), chunk):
        clens = np.clip(np.asarray(LENS) - c0, 0, chunk).astype(np.int32)
        piece = toks[:, c0:c0 + chunk]
        ref_lg, rcs = step(ref_params, batch={"tokens": jnp.asarray(piece)},
                           state=rcs, chunk_lens=jnp.asarray(clens))
        lg, cs = M.apply_prefill_chunk(
            params, cfg, {"tokens": torch.from_numpy(piece)}, cs,
            chunk_lens=torch.from_numpy(clens))
        live = clens > 0
        np.testing.assert_allclose(lg.numpy()[live],
                                   np.asarray(ref_lg)[live], **TOL,
                                   err_msg=f"chunk at {c0}")


DECODE_CASES = {"jnp": ("retro", "jnp"), "fused": ("retro", "fused"),
                "pallas": ("retro", "pallas"), "full": ("full", "jnp")}


def _decode_vs_reference(ref_cfg, ref_params, cfg, params, runtime, impl,
                         steps=4, seed=2):
    """Blocking prefill of two ragged prompts by the reference, the state
    carried across, then ``steps`` decode steps of both with the same
    tokens (row 1 idle on every other step): the logits of each step."""
    toks = _prompts(cfg.vocab, seed=seed)
    _, ref_state = RM.apply_prefill(
        ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, runtime=runtime,
        gen_headroom=HEADROOM, lengths=jnp.asarray(LENS, jnp.int32),
        cache_len=S + HEADROOM)
    state = serve_state_from_numpy(_np_tree(ref_state.kv)._asdict(), "cpu")
    ref_plan = ref_plan_zones(S, ref_cfg.retro, HEADROOM)
    plan = plan_zones(S, cfg.retro, HEADROOM)
    dec = jax.jit(functools.partial(RT.decode_step, cfg=ref_cfg,
                                    runtime=runtime, plan=ref_plan,
                                    attn_impl=impl))
    rng = np.random.default_rng(seed + 1)
    out = []
    for t in range(steps):
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        act = np.array([True, t % 2 == 0])
        ref_lg, ref_state = dec(ref_params, state=ref_state,
                                token=jnp.asarray(tok),
                                active=jnp.asarray(act))
        lg, state = PT.decode_step(params, cfg, state, torch.from_numpy(tok),
                                   runtime=runtime, plan=plan,
                                   active=torch.from_numpy(act),
                                   attn_impl=impl)
        out.append((lg.float().numpy(), np.asarray(ref_lg, np.float32)))
    return out


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_reference(arch, case):
    runtime, impl = DECODE_CASES[case]
    for t, (lg, ref) in enumerate(_decode_vs_reference(*_models(arch),
                                                       runtime, impl)):
        np.testing.assert_allclose(lg, ref, **TOL, err_msg=f"step {t}")


def test_kimi_bf16_top8_matches_no_excess_reference():
    """Reduced kimi at top-8 of 16 experts in bf16, against the reference
    compiled with its written cast points: blocking prefill and four
    ``fused`` decode steps within one bf16 ulp of each row's largest
    logit."""
    kw = dict(dtype="bfloat16")
    ref_cfg = ref_kimi.reduced().replace(moe=RefMoE(16, 8, 128), **kw)
    cfg = kimi_k2_1t_a32b.reduced().replace(moe=MoEConfig(16, 8, 128), **kw)
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(5))
    params = params_from_numpy(_np_tree(ref_params), cfg, "cpu")
    toks = _prompts(cfg.vocab, seed=4)

    def pre(p, t, lens):
        return RM.apply_prefill(p, ref_cfg, {"tokens": t},
                                gen_headroom=HEADROOM, lengths=lens)
    args = (ref_params, jnp.asarray(toks), jnp.asarray(LENS, jnp.int32))
    ref_lg, ref_state = jax.jit(pre).lower(*args).compile(
        compiler_options=NO_EXCESS)(*args)
    lg, state = M.apply_prefill(params, cfg,
                                {"tokens": torch.from_numpy(toks)},
                                gen_headroom=HEADROOM,
                                lengths=torch.tensor(LENS, dtype=torch.int32))
    assert row_ulps(lg.numpy(), ref_lg) <= 1.0
    plan = ref_plan_zones(S, ref_cfg.retro, HEADROOM)
    dec = jax.jit(functools.partial(RT.decode_step, cfg=ref_cfg, plan=plan,
                                    attn_impl="fused"))
    state = serve_state_from_numpy(_np_tree(ref_state.kv)._asdict(), "cpu")
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
    compiled = dec.lower(ref_params, state=ref_state,
                         token=jnp.asarray(tok)).compile(
        compiler_options=NO_EXCESS)
    for t in range(4):
        ref_lg, ref_state = compiled(ref_params, state=ref_state,
                                     token=jnp.asarray(tok))
        lg, state = PT.decode_step(params, cfg, state, torch.from_numpy(tok),
                                   plan=plan_zones(S, cfg.retro, HEADROOM),
                                   attn_impl="fused")
        assert row_ulps(lg.numpy(), ref_lg) <= 1.0, f"step {t}"
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
