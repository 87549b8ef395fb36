"""The VLM family against the JAX package on reduced llava-next-34b: the
patch embeddings (seeded normal at model width, the reference's stub
vision tower) replace the embeddings of the first P positions in blocking
prefill (ragged lengths) and in chunked prefill (P crossing a chunk
boundary), decode after them under ``jnp``, ``fused``, ``pallas`` and the
full runtime, and ``ServeEngine`` with ``Request.extra={"patch_embeds":
...}`` given on both sides (both runtimes, both admissions, and
``run_wave``'s ``extra_batch``). Then the attention kernels' plain twins
at 6 and 7 query heads per KV head (test-local head counts of the reduced
config; mixtral-8x22b has G 6, llava-next-34b G 7) against the reference's
interpreted Pallas kernels.

Tolerance: f32 logits within 1e-4 (matrix products sum in other orders
than XLA's); served token streams equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llava_next_34b as ref_llava
from repro.configs.base import AttnConfig as RefAttn
from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import model as RM
from repro.models import transformer as RT
from repro.serving import engine as RE
from repro_torch.configs import llava_next_34b
from repro_torch.configs.base import AttnConfig
from repro_torch.core.zones import plan_zones
from repro_torch.interop import params_from_numpy, serve_state_from_numpy
from repro_torch.models import model as M
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
S, HEADROOM, LENS = 320, 128, (300, 200)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(heads=None):
    """Reduced llava in both packages from the same numpy leaves;
    ``heads`` (n_heads, n_kv_heads) replaces the reduced head counts."""
    ref_cfg, cfg = ref_llava.reduced(), llava_next_34b.reduced()
    if heads is not None:
        ref_cfg = ref_cfg.replace(attn=RefAttn(*heads, head_dim=32))
        cfg = cfg.replace(attn=AttnConfig(*heads, head_dim=32))
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(2))
    return ref_cfg, ref_params, cfg, params_from_numpy(
        _np_tree(ref_params), cfg, "cpu")


def _patches(cfg, B=2, seed=0):
    """Seeded normal patch embeddings (B, P, D), f32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.num_patch_tokens, cfg.d_model)) \
        .astype(np.float32)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((2, S), np.int32)
    for b, n in enumerate(LENS):
        toks[b, :n] = rng.integers(0, vocab, n)
    return toks


def _ref_prefill(ref_cfg, ref_params, toks, pe, runtime="retro"):
    return RM.apply_prefill(
        ref_params, ref_cfg, {"tokens": jnp.asarray(toks),
                              "patch_embeds": jnp.asarray(pe)},
        runtime=runtime, gen_headroom=HEADROOM,
        lengths=jnp.asarray(LENS, jnp.int32), cache_len=S + HEADROOM)


def test_prefill_with_patches_matches_reference():
    """Ragged blocking prefill with the patches; without them the logits
    move (the patches are not ignored)."""
    ref_cfg, ref_params, cfg, params = _models()
    toks, pe = _prompts(cfg.vocab), _patches(cfg)
    ref_lg, _ = _ref_prefill(ref_cfg, ref_params, toks, pe)
    batch = {"tokens": torch.from_numpy(toks),
             "patch_embeds": torch.from_numpy(pe)}
    lens = torch.tensor(LENS, dtype=torch.int32)
    lg, _ = M.apply_prefill(params, cfg, batch, gen_headroom=HEADROOM,
                            lengths=lens)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)
    plain, _ = M.apply_prefill(params, cfg, {"tokens": batch["tokens"]},
                               gen_headroom=HEADROOM, lengths=lens)
    assert (plain - lg).abs().max() > 1e-2


def test_patch_embeds_cast_to_the_activation_dtype():
    """bf16 model, f32 patches: the first P positions are the patches
    rounded to bf16 (unscaled), the rest the scaled token embeddings."""
    cfg = llava_next_34b.reduced().replace(dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pe = torch.from_numpy(_patches(cfg, B=1))
    toks = torch.arange(100)[None]
    x = PT.embed_tokens(params, cfg, toks, pe)
    P = cfg.num_patch_tokens
    assert x.dtype == torch.bfloat16 and x.shape == (1, 100, cfg.d_model)
    assert torch.equal(x[:, :P], pe.to(torch.bfloat16))
    assert torch.equal(x[:, P:], PT.embed_tokens(params, cfg, toks)[:, P:])


@pytest.mark.parametrize("chunk", [48, 100])
def test_prefill_chunks_with_patches_match_reference(chunk):
    """Every chunk's logits; at 48-token chunks the 64 patch positions
    cross a chunk boundary, at 100 they end inside the first chunk."""
    ref_cfg, ref_params, cfg, params = _models()
    toks, pe = _prompts(cfg.vocab, seed=1), _patches(cfg, seed=1)
    step = jax.jit(functools.partial(RM.apply_prefill_chunk, cfg=ref_cfg))
    rcs = RM.make_prefill_chunk_state(ref_cfg, 2, S, chunk=chunk,
                                      gen_headroom=HEADROOM)
    cs = M.make_prefill_chunk_state(cfg, 2, S, chunk=chunk,
                                    gen_headroom=HEADROOM, device="cpu")
    for c0 in range(0, max(LENS), chunk):
        clens = np.clip(np.asarray(LENS) - c0, 0, chunk).astype(np.int32)
        piece = toks[:, c0:c0 + chunk]
        ref_lg, rcs = step(ref_params, batch={
            "tokens": jnp.asarray(piece), "patch_embeds": jnp.asarray(pe)},
            state=rcs, chunk_lens=jnp.asarray(clens))
        lg, cs = M.apply_prefill_chunk(
            params, cfg, {"tokens": torch.from_numpy(piece),
                          "patch_embeds": torch.from_numpy(pe)}, cs,
            chunk_lens=torch.from_numpy(clens))
        live = clens > 0
        np.testing.assert_allclose(lg.numpy()[live],
                                   np.asarray(ref_lg)[live], **TOL,
                                   err_msg=f"chunk at {c0}")


DECODE_CASES = {"jnp": ("retro", "jnp"), "fused": ("retro", "fused"),
                "pallas": ("retro", "pallas"), "full": ("full", "jnp")}


def _decode_check(heads, runtime, impl, steps=4):
    """The reference's blocking prefill with patches, its state carried
    across, then ``steps`` decode steps of both on the same tokens."""
    ref_cfg, ref_params, cfg, params = _models(heads)
    toks, pe = _prompts(cfg.vocab, seed=2), _patches(cfg, seed=2)
    _, ref_state = _ref_prefill(ref_cfg, ref_params, toks, pe, runtime)
    state = serve_state_from_numpy(_np_tree(ref_state.kv)._asdict(), "cpu")
    dec = jax.jit(functools.partial(
        RT.decode_step, cfg=ref_cfg, runtime=runtime,
        plan=ref_plan_zones(S, ref_cfg.retro, HEADROOM), attn_impl=impl))
    plan = plan_zones(S, cfg.retro, HEADROOM)
    rng = np.random.default_rng(3)
    for t in range(steps):
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        ref_lg, ref_state = dec(ref_params, state=ref_state,
                                token=jnp.asarray(tok))
        lg, state = PT.decode_step(params, cfg, state, torch.from_numpy(tok),
                                   runtime=runtime, plan=plan,
                                   attn_impl=impl)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_after_patches_matches_reference(case):
    _decode_check(None, *DECODE_CASES[case])


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("heads", [(12, 2), (14, 2)], ids=["G6", "G7"])
def test_attention_twins_at_group_sizes_6_and_7(heads, impl):
    """The paged (``fused``) and gathered-buffer (``pallas``) attention at
    G 6 and G 7: the port's plain twins against the reference's
    interpreted Pallas kernels, through the model's decode."""
    _decode_check(heads, "retro", impl, steps=3)


# ---------------------------------------------------------------------------
# ServeEngine with patch embeddings
# ---------------------------------------------------------------------------

SERVE_LENS, SERVE_NEWS, SERVE_CTX, CHUNK = (200, 130, 160), (40, 6, 12), \
    256, 48
SERVE_CASES = [("retro", "chunked"), ("retro", "blocking"),
               ("full", "chunked"), ("full", "blocking")]


def _short_flush(cfg):
    return cfg.replace(retro=dataclasses.replace(cfg.retro, update_segment=32,
                                                 local=16))


@pytest.fixture(scope="module")
def serve_models():
    ref_cfg = _short_flush(ref_llava.reduced())
    cfg = _short_flush(llava_next_34b.reduced())
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(4))
    return ref_cfg, ref_params, cfg, params_from_numpy(
        _np_tree(ref_params), cfg, "cpu")


def _requests(make, vocab, pe):
    rng = np.random.default_rng(21)
    return [make(prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new_tokens=m, extra={"patch_embeds": pe[i:i + 1]})
            for i, (n, m) in enumerate(zip(SERVE_LENS, SERVE_NEWS))]


@pytest.fixture(scope="module")
def ref_serves(serve_models):
    ref_cfg, ref_params, cfg, _ = serve_models
    pe = _patches(cfg, B=3, seed=5)
    out = {}
    for runtime, admission in SERVE_CASES:
        eng = RE.ServeEngine(ref_cfg, ref_params, runtime=runtime,
                             admission=admission, gen_headroom=64,
                             max_context=SERVE_CTX, prefill_chunk=CHUNK)
        reqs = _requests(RE.Request, ref_cfg.vocab, pe)
        eng.serve(reqs, batch_size=2)
        out[runtime, admission] = [r.out_tokens for r in reqs]
    return out


@pytest.mark.parametrize("runtime,admission", SERVE_CASES)
def test_vlm_serve_matches_reference(serve_models, ref_serves, runtime,
                                     admission):
    """Three requests on two slots, each with its own patches; request 0
    crosses a flush."""
    _, _, cfg, params = serve_models
    pe = _patches(cfg, B=3, seed=5)
    eng = ServeEngine(cfg, params, runtime=runtime, admission=admission,
                      gen_headroom=64, max_context=SERVE_CTX,
                      prefill_chunk=CHUNK, device="cpu")
    reqs = _requests(Request, cfg.vocab, pe)
    m = eng.serve(reqs, batch_size=2)
    got = [r.out_tokens for r in reqs]
    assert got == ref_serves[runtime, admission]
    assert (m.flushes >= 1) == (runtime == "retro")
    assert len(set(got[0])) > 1
    if (runtime, admission) == ("retro", "chunked"):
        # without the patches the streams differ: they were not ignored
        plain = _requests(Request, cfg.vocab, pe)
        for r in plain:
            r.extra = None
        eng.serve(plain, batch_size=2)
        assert [r.out_tokens for r in plain] != got


def test_run_wave_splits_extra_batch(serve_models):
    """``run_wave``'s ``extra_batch`` gives each request its row of the
    patches, as the reference's does."""
    ref_cfg, ref_params, cfg, params = serve_models
    pe = _patches(cfg, B=2, seed=6)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (150, 100)]
    ref_reqs = [RE.Request(prompt=p, max_new_tokens=5) for p in prompts]
    RE.ServeEngine(ref_cfg, ref_params, gen_headroom=64,
                   prefill_chunk=CHUNK).run_wave(
        ref_reqs, extra_batch={"patch_embeds": jnp.asarray(pe)})
    reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
    ServeEngine(cfg, params, gen_headroom=64, prefill_chunk=CHUNK,
                device="cpu").run_wave(
        reqs, extra_batch={"patch_embeds": torch.from_numpy(pe)})
    assert [tuple(r.extra["patch_embeds"].shape) for r in reqs] == \
        [(1, cfg.num_patch_tokens, cfg.d_model)] * 2
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
