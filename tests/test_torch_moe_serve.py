"""Reduced mixtral-8x22b served by ``ServeEngine`` against the reference's
engine on the same requests: both runtimes and both admissions, a case
where the prefill drops tokens (``capacity_factor`` 0.5), and offload
(the same tokens and every wave-buffer counter). The untied output head
makes the greedy tokens vary, so the token streams are compared. Each
admission is held against the same admission of the reference: the
capacity is per call, so blocking and chunked admission route differently
in both packages.

On a CUDA card (marked ``cuda``, skipped without one): a reduced MoE decode
step captured by ``DecodeGraph`` replays bit for bit as the eager step. The
reference is imported inside the fixtures, so the ``cuda`` cases also run
on a machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_moe_serve.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import mixtral_8x22b
from repro_torch.configs.base import MoEConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M
from repro_torch.serving.engine import (Request, Sampler, ServeEngine,
                                        _DirectStore)

torch.set_num_threads(2)
LENS, NEWS, CTX, CHUNK = (200, 130, 160), (40, 6, 12), 256, 48
# name -> (runtime, admission, capacity_factor, engine knobs)
CASES = {
    "retro_chunked": ("retro", "chunked", 1.25, {}),
    "retro_blocking": ("retro", "blocking", 1.25, {}),
    "full_chunked": ("full", "chunked", 1.25, {}),
    "full_blocking": ("full", "blocking", 1.25, {}),
    "retro_chunked_drops": ("retro", "chunked", 0.5, {}),
    "offload_fused": ("retro", "chunked", 1.25,
                      dict(offload=True, cache_frac=0.25, attn_impl="fused")),
}


def _short_flush(cfg, cf):
    """A 32-token update segment (request 0's 40 new tokens cross a
    flush); the MoE's capacity factor ``cf``."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf),
                       retro=dataclasses.replace(cfg.retro, update_segment=32,
                                                 local=16))


def _prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


def _summary(reqs, m):
    return dict(tokens=[r.out_tokens for r in reqs], steps=m.steps,
                cache=dataclasses.asdict(m.cache), degraded=m.degraded_steps)


@pytest.fixture(scope="module")
def models():
    """Per capacity factor: (reference config, its params, port config,
    port params from the same numpy leaves)."""
    import jax
    from repro.configs import mixtral_8x22b as ref_mixtral
    from repro.models import model as RM
    out = {}
    for cf in {c[2] for c in CASES.values()}:
        ref_cfg = _short_flush(ref_mixtral.reduced(), cf)
        cfg = _short_flush(mixtral_8x22b.reduced(), cf)
        ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(4))
        out[cf] = (ref_cfg, ref_params, cfg, params_from_numpy(
            jax.tree.map(np.asarray, ref_params), cfg, "cpu"))
    return out


@pytest.fixture(scope="module")
def ref_serves(models):
    """Every case served once by the reference's engine."""
    from repro.serving import engine as RE
    out = {}
    for name, (runtime, admission, cf, kw) in CASES.items():
        ref_cfg, ref_params, _, _ = models[cf]
        eng = RE.ServeEngine(ref_cfg, ref_params, runtime=runtime,
                             admission=admission, gen_headroom=64,
                             max_context=CTX, prefill_chunk=CHUNK, **kw)
        reqs = [RE.Request(prompt=p, max_new_tokens=n)
                for p, n in zip(_prompts(ref_cfg.vocab), NEWS)]
        out[name] = _summary(reqs, eng.serve(reqs, batch_size=2))
    return out


def _port_serve(cfg, params, runtime, admission, device="cpu", **kw):
    eng = ServeEngine(cfg, params, runtime=runtime, admission=admission,
                      gen_headroom=64, max_context=CTX, prefill_chunk=CHUNK,
                      device=device, **kw)
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, n in zip(_prompts(cfg.vocab), NEWS)]
    m = eng.serve(reqs, batch_size=2)
    return _summary(reqs, m), m


@pytest.mark.parametrize("case", list(CASES))
def test_moe_serve_matches_reference(models, ref_serves, case):
    runtime, admission, cf, kw = CASES[case]
    _, _, cfg, params = models[cf]
    got, m = _port_serve(cfg, params, runtime, admission, **kw)
    assert got == ref_serves[case]
    assert m.tokens_out == sum(NEWS)
    assert (m.flushes >= 1) == (runtime == "retro")
    assert len(set(got["tokens"][0])) > 1
    if kw.get("offload"):
        assert m.cache.lookups > 0 and m.cache.bytes_over_link > 0
        assert 0 < m.cache.hit_ratio <= 1


def test_drops_change_the_routing(models, ref_serves):
    """The 48-token chunks drop tokens at capacity factor 0.5 (C 16 against
    24 replicas an expert on average), and the tokens differ from the
    undropped serve's: the drop case tests something."""
    from repro_torch.models import moe
    cfg = models[0.5][2]
    assert moe.expert_capacity(CHUNK, cfg.moe) * cfg.moe.num_experts \
        < CHUNK * cfg.moe.top_k
    assert ref_serves["retro_chunked_drops"]["tokens"] != \
        ref_serves["retro_chunked"]["tokens"]


def test_moe_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    for arch in ("mixtral-8x22b", "kimi_k2_1t_a32b", "llava_next_34b"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "2", "--prompt-lens", "80,60",
                    "--new-tokens", "3", "--prefill-chunk", "32"])
        out = capsys.readouterr().out
        assert "served 2 requests" in out, arch
        assert "req 1: prompt 60, out 3," in out, arch


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["jnp", "fused", "pallas"])
def test_moe_replay_equals_eager(cuda, impl):
    """Reduced mixtral at top-2 of 8 in bf16 on the card: from one
    blocking-prefilled state, eight eager steps and eight steps of the
    ``DecodeGraph`` (warm-up, then seven replays) give the same logits, ids
    and state bit for bit. The MoE step has no host sync: it captures."""
    cfg = mixtral_8x22b.reduced().replace(
        dtype="bfloat16", moe=MoEConfig(8, 2, 128), tie_embeddings=False)
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    S, lens, headroom = 200, (200, 150), 64
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    from repro_torch.core.zones import plan_zones
    plan = plan_zones(S, cfg.retro, headroom)
    copy = lambda st: type(st)(kv=[type(s)(*(t.clone() for t in s))
                                   for s in st.kv])
    with torch.inference_mode():
        _, state0 = M.apply_prefill(
            params, cfg, {"tokens": torch.from_numpy(toks).to(cuda)},
            plan=plan, gen_headroom=headroom,
            lengths=torch.tensor(lens, dtype=torch.int32, device=cuda))
        tokens = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
        stage = _DirectStore(cfg, params, plan, copy(state0), tokens,
                             Sampler(device=cuda), runtime="retro",
                             attn_impl=impl).graph
        fn, eager, tok = stage.fn, copy(state0), tokens.clone()
        for t in range(8):
            act = np.array([True, t % 3 != 1])
            lg, ids = stage.step(act, stage.state)
            lg, ids = lg.clone(), ids.clone()
            ref, eager = fn(eager, tok, torch.from_numpy(act).to(cuda))
            tok = stage.sample(ref)
            assert torch.equal(lg, ref), f"step {t}"
            assert torch.equal(ids, tok), f"step {t}"
    torch.cuda.synchronize()
    assert (stage.captures, stage.replays) == (1, 7)
    for a, b in zip(stage.state.kv, eager.kv):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f
