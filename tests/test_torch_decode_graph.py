"""The compiled decode stage (``serving/graphs.py``): the serve state's
tensors keep their addresses through a serve run, the stable-state step
equals the functional step, and, on a CUDA card (marked ``cuda``, skipped
without one: a CUDA graph has no CPU mode), a replayed step equals the eager
step bit for bit, a serve run captures once per geometry, and a capture
error raises. The reference is imported inside the one test that uses it,
so the ``cuda`` cases also run on a machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_graph.py -q
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import gemma2_2b
from repro_torch.core.zones import plan_zones
from repro_torch.kernels.wave_attention import ops as wa_ops
from repro_torch.models import model as M
from repro_torch.models.transformer import ServeState
from repro_torch.serving import graphs
from repro_torch.serving.engine import (Request, Sampler, ServeEngine,
                                        _DirectStore)

torch.set_num_threads(2)
S, LENS, HEADROOM = 200, (200, 150), 64
# name -> (runtime, attn_impl)
STEP_CASES = {"jnp": ("retro", "jnp"), "fused": ("retro", "fused"),
              "pallas": ("retro", "pallas"), "full": ("full", "jnp")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg():
    """Reduced gemma2-2b (SMOKE_RETRO: 128-token update segments), untied
    head so greedy tokens vary."""
    return gemma2_2b.reduced().replace(tie_embeddings=False)


def _params(cfg, device="cpu", seed=0):
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
        else [to(v) for v in t] if isinstance(t, list) \
        else t.to(device) if isinstance(t, torch.Tensor) else t
    return to(params)


def _copy(state):
    return ServeState(kv=[type(s)(*(t.clone() for t in s))
                          for s in state.kv])


def _prefilled(cfg, params, runtime, device="cpu"):
    """Two ragged prompts through blocking prefill: (state, plan)."""
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    plan = plan_zones(S, cfg.retro, HEADROOM)
    _, state = M.apply_prefill(
        params, cfg, {"tokens": torch.from_numpy(toks).to(device)},
        runtime=runtime, plan=plan, gen_headroom=HEADROOM,
        lengths=torch.tensor(LENS, dtype=torch.int32, device=device),
        cache_len=S + HEADROOM)
    return state, plan


ACTIVE = [np.array([True, t % 3 != 1]) for t in range(8)]


def _stage(cfg, params, runtime, impl, state, plan, device):
    tokens = torch.tensor([3, 5], dtype=torch.int32, device=device)
    return _DirectStore(cfg, params, plan, state, tokens,
                        Sampler(device=device), runtime=runtime,
                        attn_impl=impl).graph


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_stable_state_step_matches_functional_step(case):
    """Eight steps, one row inactive on some: the engine's step on its
    static buffers (updated in place) gives the logits, ids and state of
    ``apply_decode`` on a fresh copy of the state each step, bit for bit
    (the full runtime reads the whole cache on both)."""
    runtime, impl = STEP_CASES[case]
    cfg = _cfg()
    params = _params(cfg)
    state0, plan = _prefilled(cfg, params, runtime)
    stage = _stage(cfg, params, runtime, impl, _copy(state0), plan, "cpu")
    addresses = graphs.state_addresses(stage.state)
    func, tok = _copy(state0), torch.tensor([3, 5], dtype=torch.int32)
    for t, act in enumerate(ACTIVE):
        lg, ids = stage.step(act, stage.state)
        func = _copy(func)
        ref, func = M.apply_decode(params, cfg, func, tok, runtime=runtime,
                                   plan=plan, active=torch.from_numpy(act),
                                   attn_impl=impl)
        tok = ref.argmax(-1).to(torch.int32)
        assert torch.equal(lg, ref), f"step {t}"
        assert torch.equal(ids, tok) and torch.equal(stage.tokens, tok)
    assert graphs.state_addresses(stage.state) == addresses
    for a, b in zip(stage.state.kv, func.kv):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f
    assert stage.captures == 0 and stage.replays == 0


def test_step_that_rebinds_the_state_raises():
    """A step that returns new state tensors cannot be replayed at fixed
    addresses: the stage refuses it."""
    cfg = _cfg()
    params = _params(cfg)
    state, plan = _prefilled(cfg, params, "retro")
    stage = _stage(cfg, params, "retro", "jnp", state, plan, "cpu")
    real = stage.fn

    def rebinding(st, tokens, active):
        lg, st = real(st, tokens, active)
        return lg, _copy(st)

    stage.fn = rebinding
    with pytest.raises(RuntimeError, match="moved"):
        stage.step(np.ones(2, bool))


def test_full_runtime_whole_cache_span_matches_reference():
    """The full runtime's step, which reads the whole cache, against the
    reference's compiled step, which reads it too: the reference's
    blocking prefill carried across, eight steps with one row inactive on
    some, logits within 1e-4 (``test_full_decode_steps_match_reference``'s
    tolerance)."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.configs import gemma2_2b as ref_gemma
    from repro.core.zones import plan_zones as ref_plan_zones
    from repro.models import model as RM
    from repro.models import transformer as RT
    from repro_torch.interop import params_from_numpy, serve_state_from_numpy
    ref_cfg, cfg = ref_gemma.reduced(), gemma2_2b.reduced()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    rng = np.random.default_rng(1)
    lens = np.array([160, 90], np.int32)
    toks = rng.integers(0, 512, (2, 160)).astype(np.int32)
    _, ref_st = RM.apply_prefill(ref_params, ref_cfg,
                                 {"tokens": jnp.asarray(toks)},
                                 runtime="full", gen_headroom=16,
                                 lengths=jnp.asarray(lens))
    state = serve_state_from_numpy(
        {f: np.asarray(a) for f, a in ref_st.kv._asdict().items()}, "cpu")
    plan = ref_plan_zones(160, ref_cfg.retro, 16)
    dec = jax.jit(functools.partial(RT.decode_step, cfg=ref_cfg,
                                    runtime="full", plan=plan))
    for t in range(8):
        tok = rng.integers(0, 512, (2,)).astype(np.int32)
        act = np.array([True, t % 3 != 1])
        ref_lg, ref_st = dec(ref_params, state=ref_st, token=jnp.asarray(tok),
                             active=jnp.asarray(act))
        lg, state = M.apply_decode(params, cfg, state, torch.from_numpy(tok),
                                   runtime="full",
                                   plan=plan_zones(160, cfg.retro, 16),
                                   active=torch.from_numpy(act))
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")


SERVE_CASES = {"retro_chunked": ("retro", "chunked"),
               "retro_blocking": ("retro", "blocking"),
               "full_chunked": ("full", "chunked")}


def _serve(cfg, params, runtime, admission, device, impl="fused"):
    """Three requests on two slots (three admissions, one slot reused);
    request 0's 140 new tokens cross a 128-token update segment."""
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in ((200, 140), (150, 8), (180, 10))]
    eng = ServeEngine(cfg, params, runtime=runtime, admission=admission,
                      attn_impl=impl, prefill_chunk=64, gen_headroom=256,
                      device=device)
    seen = []
    real = graphs.DecodeGraph.step

    def step(self, active, state=None):
        seen.append(graphs.state_addresses(state))
        return real(self, active, state)

    with mock.patch.object(graphs.DecodeGraph, "step", step):
        m = eng.serve(reqs, batch_size=2)
    return eng, m, reqs, seen


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_state_keeps_its_addresses(case):
    """Every tensor of the decode state keeps its ``data_ptr`` from the
    first decode step to the end of a serve run, across the admissions
    (``graft``) and the flush (``flush_state``)."""
    runtime, admission = SERVE_CASES[case]
    cfg = _cfg()
    eng, m, reqs, seen = _serve(cfg, _params(cfg), runtime, admission, "cpu")
    assert m.steps == len(seen) >= 139
    assert m.flushes >= (1 if runtime == "retro" else 0)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    assert len({r.slot for r in reqs}) == 2          # a slot was reused
    assert set(seen) == {graphs.state_addresses(eng.last_state)}
    assert eng.last_graph.key == (2, 200, "fused", runtime)


def test_dropped_engine_frees_its_graph_without_the_collector():
    """The engine holds its last serve's state and captured step, and the
    step no reference to the engine: dropping the engine frees both at
    once, with the cyclic collector off (a cycle would keep a state of
    many GB on the card until the collector's next full pass)."""
    import gc
    import weakref
    cfg = _cfg()
    eng = ServeEngine(cfg, _params(cfg), device="cpu")
    eng.serve([Request(np.arange(40, dtype=np.int32), 3)], batch_size=1)
    refs = (weakref.ref(eng), weakref.ref(eng.last_graph),
            weakref.ref(eng.last_state.kv[0].k_store))
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_replay_equals_eager(cuda, case):
    """From one state on the card, eight eager steps of the engine's step
    and eight steps of its ``DecodeGraph`` (the warm-up, then seven
    replays): the same logits and ids, bit for bit, and the same state."""
    runtime, impl = STEP_CASES[case]
    cfg = _cfg().replace(dtype="bfloat16")
    params = _params(cfg, cuda)
    state0, plan = _prefilled(cfg, params, runtime, cuda)
    with torch.inference_mode():
        stage = _stage(cfg, params, runtime, impl, _copy(state0), plan, cuda)
        fn = stage.fn
        eager, tok = _copy(state0), stage.tokens.clone()
        for t, act in enumerate(ACTIVE):
            lg, ids = stage.step(act, stage.state)
            lg, ids = lg.clone(), ids.clone()
            ref, eager = fn(eager, tok, torch.from_numpy(act).to(cuda))
            tok = stage.sample(ref)
            assert torch.equal(lg, ref), f"step {t}"
            assert torch.equal(ids, tok), f"step {t}"
    torch.cuda.synchronize()
    assert (stage.captures, stage.replays) == (1, len(ACTIVE) - 1)
    for a, b in zip(stage.state.kv, eager.kv):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_serve_captures_once_per_geometry(cuda, impl):
    """A serve run on the card (three admissions, one flush) captures its
    step once and gives the CPU's tokens. The path's kernel wrapper counts
    layers launches for the warm-up step and layers for the capture, and
    none for a replay."""
    cfg = _cfg()
    kernel = dict(fused=wa_ops.paged_wave_attention,
                  pallas=wa_ops.wave_attention_merge)[impl]
    before = kernel.launches
    eng, m, reqs, _ = _serve(cfg, _params(cfg, cuda), "retro", "chunked",
                             cuda, impl=impl)
    assert eng.last_graph.captures == 1
    assert eng.last_graph.replays == m.steps - 1
    assert kernel.launches - before == 2 * cfg.n_layers
    assert m.flushes >= 1
    _, _, cpu_reqs, _ = _serve(cfg, _params(cfg), "retro", "chunked", "cpu",
                               impl=impl)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in cpu_reqs]


@pytest.mark.cuda
def test_capture_error_raises(cuda):
    """A step that reads a device value back cannot be captured: the
    capture raises, and nothing falls back to eager."""
    cfg = _cfg()
    params = _params(cfg, cuda)
    state, plan = _prefilled(cfg, params, "retro", cuda)
    stage = _stage(cfg, params, "retro", "fused", state, plan, cuda)
    real = stage.fn

    def reads_back(st, tokens, active):
        if int(tokens.sum()) < 0:          # a host sync: illegal in capture
            raise AssertionError
        return real(st, tokens, active)

    stage.fn = reads_back
    with torch.inference_mode(), pytest.raises(RuntimeError):
        stage.step(np.ones(2, bool))
    assert stage.graph is None and stage.captures == 0
    torch.cuda.synchronize()
