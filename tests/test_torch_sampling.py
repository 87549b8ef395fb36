"""Temperature sampling on the serve path (``serving/engine.py::Sampler``).

``jax.random`` bits cannot be reproduced in torch, so the port holds the
distribution, not the reference's tokens: over 30 000 seeded Gumbel-max
draws each id's frequency is within 4 standard errors of
``softmax(logits / T)``; T -> 0 gives the argmax; one seed gives one
token stream through the direct and the offload paths, another seed
another; ``temperature=0`` serves the greedy tokens. On a CUDA card
(marked ``cuda``, skipped without one) the captured decode step with the
generator registered replays equal to the eager step bit for bit, with
the generator rewound between them.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_sampling.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import gemma2_2b
from repro_torch.core.zones import plan_zones
from repro_torch.models import model as M
from repro_torch.serving import graphs
from repro_torch.serving.engine import (Request, Sampler, ServeEngine,
                                        _DirectStore)

torch.set_num_threads(2)
N_DRAWS = 30_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("temperature", (0.5, 1.0, 2.5))
def test_gumbel_max_frequencies_match_softmax(temperature):
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    ids = Sampler(temperature, seed=11)(logits.expand(N_DRAWS, -1))
    assert ids.dtype == torch.int32 and ids.shape == (N_DRAWS,)
    freq = torch.bincount(ids.long(), minlength=6).double() / N_DRAWS
    p = torch.softmax(logits.double() / temperature, -1)
    se = torch.sqrt(p * (1 - p) / N_DRAWS)
    assert ((freq - p).abs() <= 4 * se).all(), (freq, p)


def test_temperature_to_zero_gives_argmax():
    logits = torch.randn(64, 50, generator=torch.Generator().manual_seed(0))
    want = logits.argmax(-1).to(torch.int32)
    greedy = Sampler(0.0)
    assert greedy.generator is None
    assert torch.equal(greedy(logits), want)
    assert torch.equal(Sampler(1e-4, seed=3)(logits), want)


def test_sampler_draws_advance_and_reseed():
    logits = torch.zeros(4, 1000)
    s = Sampler(1.0, seed=2)
    a, b = s(logits), s(logits)
    assert not torch.equal(a, b)
    assert torch.equal(Sampler(1.0, seed=2)(logits), a)


def _cfg():
    """Reduced gemma2-2b, untied head so tokens vary."""
    return gemma2_2b.reduced().replace(tie_embeddings=False)


def _serve(params, cfg, *, temperature=None, seed=0, offload=False,
           admission="chunked"):
    kw = {} if temperature is None else {"temperature": temperature}
    eng = ServeEngine(cfg, params, device="cpu", gen_headroom=64,
                      offload=offload, admission=admission, **kw)
    rng = np.random.default_rng(4)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in ((150, 9), (100, 6), (120, 7))]
    eng.serve(reqs, batch_size=2, seed=seed)
    return [r.out_tokens for r in reqs], eng


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("offload", (False, True))
def test_one_seed_one_token_stream(model, offload):
    """At a high temperature (so draws differ): the same seed twice gives
    the same tokens, another seed others, every id in the vocabulary."""
    cfg, params = model
    a, _ = _serve(params, cfg, temperature=4.0, seed=5, offload=offload)
    b, _ = _serve(params, cfg, temperature=4.0, seed=5, offload=offload)
    c, _ = _serve(params, cfg, temperature=4.0, seed=6, offload=offload)
    assert a == b
    assert a != c
    assert all(0 <= t < cfg.vocab for r in a + c for t in r)
    assert [len(r) for r in a] == [9, 6, 7]


@pytest.mark.parametrize("admission", ("chunked", "blocking"))
def test_temperature_zero_serves_greedy_tokens(model, admission):
    """``temperature=0`` is the greedy engine (no generator), whatever the
    seed; each request's first token is the argmax of its prefill."""
    cfg, params = model
    greedy, eng = _serve(params, cfg, admission=admission)
    zero, eng0 = _serve(params, cfg, temperature=0.0, seed=9,
                        admission=admission)
    assert zero == greedy
    assert eng0.last_graph.sample.generator is None
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, 150).astype(np.int64)
    with torch.no_grad():
        lg, _ = M.apply_prefill(params, cfg,
                                {"tokens": torch.from_numpy(toks)[None]},
                                gen_headroom=64)
    assert zero[0][0] == int(lg.argmax(-1))


def test_sampled_step_matches_functional_step(model):
    """On the CPU the engine's decode step samples eagerly: its ids are the
    sampler's draw from the step's logits, the generator advanced once a
    step."""
    cfg, params = model
    S = 160
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    plan = plan_zones(S, cfg.retro, 64)
    with torch.no_grad():
        _, state = M.apply_prefill(params, cfg,
                                   {"tokens": torch.from_numpy(toks)},
                                   plan=plan, gen_headroom=64)
        sampler = Sampler(1.5, seed=8)
        twin = Sampler(1.5, seed=8)
        stage = _DirectStore(cfg, params, plan, state,
                             torch.tensor([3, 5], dtype=torch.int32),
                             sampler, runtime="retro", attn_impl="jnp").graph
        for _ in range(4):
            lg, ids = stage.step(np.ones(2, bool))
            assert torch.equal(ids, twin(lg))
    assert graphs.generators(sampler) == (sampler.generator,)
    assert graphs.generators(Sampler(0.0)) == ()


@pytest.mark.cuda
def test_sampled_replay_equals_eager(cuda):
    """The captured step with the sampler's generator registered: four
    eager steps, then (state, tokens and generator rewound) a capture and
    four replays give the same logits bits and ids; the replays drew fresh
    numbers each (the ids are not all the same row to row)."""
    cfg = _cfg()
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    S = 200
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    plan = plan_zones(S, cfg.retro, 64)
    with torch.inference_mode():
        _, state = M.apply_prefill(
            params, cfg, {"tokens": torch.from_numpy(toks).to(cuda)},
            plan=plan, gen_headroom=64)
        saved = [t.clone() for t in graphs.leaves(state)]
        sampler = Sampler(4.0, seed=3, device=cuda)
        first = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
        stage = _DirectStore(cfg, params, plan, state, first.clone(), sampler,
                             runtime="retro", attn_impl="jnp").graph
        act = np.ones(2, bool)

        def restore(rng_state):
            for t, s in zip(graphs.leaves(state), saved):
                t.copy_(s)
            stage.tokens.copy_(first)
            sampler.generator.set_state(rng_state)

        rng0 = sampler.generator.get_state()
        stage.active.copy_(torch.from_numpy(act))
        eager = [tuple(t.clone() for t in stage._run()) for _ in range(4)]
        restore(rng0)
        stage.step(act)                     # warm-up + capture
        restore(rng0)
        replay = [tuple(t.clone() for t in stage.step(act))
                  for _ in range(4)]
        torch.cuda.synchronize()
    assert stage.captures == 1
    for (el, ei), (rl, ri) in zip(eager, replay):
        assert torch.equal(el, rl) and torch.equal(ei, ri)
    assert len({tuple(i.tolist()) for _, i in replay}) > 1
