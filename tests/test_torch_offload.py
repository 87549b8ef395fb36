"""The host-offload serving path on gemma2-2b ``reduced()`` (untied output
head, so greedy tokens vary): the retrieval cover and the offload flush,
the attend hooks ``kv_src`` / ``valid`` / ``cover`` for every impl, and
offload ``serve`` against the reference's offload ``serve`` (tokens, every
wave-buffer counter, degraded steps) in the scenario of
``tests/test_system.py:288``: 3 requests on 2 slots, generation crossing a
flush. The port's offload decode against its own direct path, and one
``cuda`` test: reduced offload on the card against the CPU.

The reference is imported inside the helpers, so the ``cuda`` test also
runs on a machine with the card and without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_offload.py -q
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import gemma2_2b
from repro_torch.core import attention as PA
from repro_torch.core.wave_buffer import LinkTransport, TransientFault
from repro_torch.core.wave_index import WaveState, flush_segment_offload
from repro_torch.core.zones import ZonePlan, plan_zones
from repro_torch.interop import (params_from_numpy, tensor_from_numpy,
                                 wave_states_from_numpy)
from repro_torch.models import model as M
from repro_torch.models.transformer import ServeState
from repro_torch.serving.engine import (Request, Sampler, ServeEngine,
                                        _OffloadPlane)

torch.set_num_threads(2)
S, CHUNK, HEADROOM = 384, 96, 256
LENS = (S, 256, 320)
TOL = dict(atol=1e-5, rtol=1e-5)
BASE = dict(avg_cluster=8, cluster_cap=16, prefill_segment=256,
            update_segment=128, sink=4, local=32, kmeans_iters=3)
# name -> (attn_impl, prompt lengths, new tokens per request, engine knobs)
CASES = {
    # 136 new tokens: request 2's staging buffer (32 + 128) flushes; the
    # "pallas" case (the reference's slowest on the CPU) stops short of it
    "jnp": ("jnp", LENS, (8, 6, 136), dict(cache_frac=0.25)),
    "fused": ("fused", LENS, (8, 6, 136), dict(cache_frac=0.25)),
    "pallas": ("pallas", LENS, (8, 6, 20), dict(cache_frac=0.25)),
    # the 40-token prompt holds one cluster and takes over slot 0 from the
    # first request: its ranking returns dead ids (>= n_clusters), which
    # never reach a buffer and read the staging tail's empty payload
    "dead_ids": ("fused", (S, 300, 40), (6, 30, 12), dict(cache_frac=0.25)),
    "eviction_pressure": ("fused", LENS, (6, 5, 8), dict(cache_frac=0.02)),
    "seeded_faults": ("jnp", LENS, (8, 6, 20), dict(
        cache_frac=0.25, fetch_retries=0, fetch_deadline_s=0.01,
        fault_profile="transient=0.2,corrupt=0.02,spike=0.3,seed=3")),
    "fatal": ("jnp", LENS, (8, 6, 8), dict(cache_frac=0.25,
                                           fault_profile="fatal=1.0,seed=2")),
}


def _prompts(vocab, lens=LENS):
    rng = np.random.default_rng(13)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# the reference ServeMetrics' wave-buffer properties, read by name on both
CACHE_PROPS = ("cache_lookups", "cache_hits", "cache_pending_hits",
               "bytes_over_link", "bytes_from_cache", "bytes_from_pending",
               "cache_faults", "cache_retries", "cache_corrupt_fetches",
               "cache_failed_fetches", "cache_hit_ratio",
               "effective_cache_hit_ratio")


def _summary(reqs, m):
    return dict(tokens=[r.out_tokens for r in reqs],
                status=[r.status for r in reqs], steps=m.steps,
                cache=dataclasses.asdict(m.cache),
                props={p: getattr(m, p) for p in CACHE_PROPS},
                degraded=m.degraded_steps, dropped=m.dropped_cluster_steps)


@pytest.fixture(scope="module")
def models():
    import jax
    from repro.configs import gemma2_2b as ref_gemma
    from repro.models import model as RM
    ref_cfg = ref_gemma.reduced().replace(tie_embeddings=False)
    cfg = gemma2_2b.reduced().replace(tie_embeddings=False)
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_params, cfg, params


@pytest.fixture(scope="module")
def ref_runs(models):
    """Every case served once by the reference's offload engine."""
    from repro.serving import engine as RE
    ref_cfg, ref_params, _, _ = models
    out = {}
    for name, (impl, lens, news, kw) in CASES.items():
        eng = RE.ServeEngine(ref_cfg, ref_params, runtime="retro",
                             gen_headroom=HEADROOM, max_context=S,
                             prefill_chunk=CHUNK, attn_impl=impl,
                             offload=True, **kw)
        reqs = [RE.Request(prompt=p, max_new_tokens=n)
                for p, n in zip(_prompts(ref_cfg.vocab, lens), news)]
        out[name] = _summary(reqs, eng.serve(reqs, batch_size=2))
    return out


def _port_serve(cfg, params, impl, news, device="cpu", offload=True,
                lens=LENS, **kw):
    eng = ServeEngine(cfg, params, gen_headroom=HEADROOM, max_context=S,
                      prefill_chunk=CHUNK, attn_impl=impl, offload=offload,
                      device=device, **kw)
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, n in zip(_prompts(cfg.vocab, lens), news)]
    m = eng.serve(reqs, batch_size=2)
    return _summary(reqs, m), m


@pytest.mark.parametrize("case", list(CASES))
def test_offload_serve_matches_reference(models, ref_runs, case):
    _, _, cfg, params = models
    impl, lens, news, kw = CASES[case]
    got, m = _port_serve(cfg, params, impl, news, lens=lens, **kw)
    want = ref_runs[case]
    assert got == want
    cache = m.cache
    # one lookup per live retrieved id of each decoding row, layer and head
    ranked = m.occupied_slot_steps * cfg.n_layers * cfg.n_kv_heads * \
        plan_zones(S, cfg.retro, HEADROOM).r
    if case in ("jnp", "fused", "pallas", "eviction_pressure"):
        assert cache.lookups == ranked
    if case in ("jnp", "fused", "pallas"):
        assert m.flushes >= (case != "pallas") and cache.bytes_over_link > 0
        assert 0 < cache.hit_ratio <= cache.effective_hit_ratio <= 1
        assert len(set(got["tokens"][2])) > 1
    elif case == "dead_ids":                     # dead ids are not looked up
        assert cache.lookups < ranked
    elif case == "eviction_pressure":
        assert cache.hit_ratio < 0.9 and cache.bytes_over_link > 0
    elif case == "seeded_faults":
        assert cache.faults > 0 and cache.failed_fetches > 0
        assert cache.corrupt_fetches > 0
        assert m.dropped_cluster_steps >= m.degraded_steps > 0
        assert [len(t) for t in got["tokens"]] == list(news)
    else:
        assert got["status"] == ["error"] * 3
        assert all(len(t) < n for t, n in zip(got["tokens"], news))


@pytest.mark.parametrize("case", ["fused", "dead_ids"])
def test_offload_serve_tokens_equal_direct(models, case):
    _, _, cfg, params = models
    impl, lens, news, kw = CASES[case]
    off, _ = _port_serve(cfg, params, impl, news, lens=lens, **kw)
    direct, m = _port_serve(cfg, params, impl, news, offload=False,
                            lens=lens)
    assert off["tokens"] == direct["tokens"]
    assert m.cache.lookups == 0 and m.cache.bytes_over_link == 0


# ---------------------------------------------------------------------------
# offload decode against the direct decode, on one admitted two-row state
# ---------------------------------------------------------------------------

class _FailSlot(LinkTransport):
    """Every fetch attempt from one slot's stores fails (a transient
    fault); other slots' fetches read the store as the production
    transport does."""

    def __init__(self, stores):
        self.stores = stores

    def fetch(self, store, cid):
        if any(np.shares_memory(store, s) for s in self.stores):
            raise TransientFault(f"cluster {cid}")
        return super().fetch(store, cid)


def _fail_slot_fetches(plane, slot):
    """Every fetch of ``slot``'s live clusters fails, every layer and step:
    none is admitted, so each one is masked out and covered each step."""
    fail = _FailSlot([layer.stores[slot] for layer in plane.layers])
    for layer in plane.layers:
        layer.transport = fail


def _offload_vs_direct(cfg, params, impl, device, steps=6, fault=None,
                       fail_slot=None):
    """Serve two requests directly, then run ``steps`` decode steps from
    copies of the state the serve left: through ``apply_decode`` and through
    an offload plane whose rows were admitted from that state. Row 1 holds
    one cluster, so its ranking returns dead ids (staged, empty).
    ``fail_slot``: that slot's fetches fail every layer and step.
    Returns the two logit sequences and the plane."""
    eng = ServeEngine(cfg, params, gen_headroom=HEADROOM, max_context=S,
                      prefill_chunk=CHUNK, attn_impl=impl, device=device,
                      fault_profile=fault, fetch_deadline_s=0.01)
    rng = np.random.default_rng(1)
    eng.serve([Request(rng.integers(0, cfg.vocab, n).astype(np.int32), 2)
               for n in (S, 40)], batch_size=2)
    st = eng.last_state
    copy = lambda s: ServeState(kv=[WaveState(*(t.clone() for t in w))
                                    for w in s.kv])
    row = lambda i, j: ServeState(kv=[
        WaveState(*(torch.cat([t[i:i + 1], t[j:j + 1]]) for t in w))
        for w in st.kv])
    direct, off = copy(st), copy(st)
    plan = plan_zones(S, cfg.retro, HEADROOM)
    plane = _OffloadPlane(cfg, params, plan, 2, S, attn_impl=eng.attn_impl,
                          sample=Sampler(device=device),
                          placement=eng.placement, device=device)
    active = np.ones(2, bool)
    tok = torch.tensor([5, 7], dtype=torch.int32, device=device)
    # slot 1 first decodes a step of row 0's request, then is handed to
    # row 1: its staging tail keeps row 0's misses where row 1 has dead ids
    warm = row(0, 0)
    for i in range(2):
        plane.admit_slot(i, ServeState(kv=[
            WaveState(*(t[:1].clone() for t in w)) for w in warm.kv]))
    plane.step(warm, tok, active)
    for i in range(2):
        plane.admit_slot(i, ServeState(kv=[
            WaveState(*(t[i:i + 1].clone() for t in w)) for w in st.kv]))
    if fail_slot is not None:
        _fail_slot_fetches(plane, fail_slot)
    out_d, out_o = [], []
    with torch.inference_mode():
        for _ in range(steps):
            a, direct = M.apply_decode(params, cfg, direct, tok, plan=plan,
                                       active=torch.from_numpy(active)
                                       .to(device), attn_impl=impl)
            b, _ = plane.step(off, tok, active)
            out_d.append(a.cpu())
            out_o.append(b.cpu())
            tok = a.argmax(-1).to(torch.int32)
    return torch.stack(out_d), torch.stack(out_o), plane


@pytest.mark.parametrize("impl", PA.ATTN_IMPLS)
def test_offload_decode_bit_identical_to_direct(models, impl):
    """Payloads are the same bits and the slots are walked in the ids'
    order. Every layer attends with the mask and the retrieval cover, as
    the reference does: with every fetch landed the r cover entries are
    gated to exact zeros, but they lengthen the estimation reductions,
    which changes the f32 rounding (measured up to 1.1e-6 on logits of
    magnitude 4.2). So the logits agree with the direct path's within the
    file's 1e-5, not bit for bit."""
    _, _, cfg, params = models
    direct, off, plane = _offload_vs_direct(cfg, params, impl, "cpu")
    torch.testing.assert_close(off, direct, **TOL)
    assert plane.counts["steps"] == 7 and plane.degraded_steps == 0
    assert sum(layer.total().lookups for layer in plane.layers) > 0


@pytest.mark.parametrize("impl", PA.ATTN_IMPLS)
def test_offload_fault_in_one_slot_leaves_other_slot_bits(models, impl):
    """A request's logits do not depend on what shares the batch: failed
    fetches in slot 1 (masked clusters, covered by the estimation zone)
    leave slot 0's logits the same bits as a run without them."""
    _, _, cfg, params = models
    _, clean, _ = _offload_vs_direct(cfg, params, impl, "cpu")
    _, faulty, plane = _offload_vs_direct(cfg, params, impl, "cpu",
                                          fail_slot=1)
    assert plane.degraded_steps == 6
    assert plane.dropped_cluster_steps >= 6 * cfg.n_layers * cfg.n_kv_heads
    assert torch.equal(faulty[:, 0], clean[:, 0])
    assert not torch.equal(faulty[:, 1], clean[:, 1])


# ---------------------------------------------------------------------------
# the control-plane pieces against the reference
# ---------------------------------------------------------------------------

def _ref_state(n=640, B=2, H=2, G=2, hd=32, seed=0, n_append=0):
    import jax.numpy as jnp
    from repro.configs.base import RetroConfig as RefRetro
    from repro.core.wave_index import append_token, prefill_build
    from repro.core.zones import plan_zones as ref_plan_zones
    retro = RefRetro(**BASE)
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((B, n, H, hd)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, n, H, hd)), jnp.float32)
    plan = ref_plan_zones(n, retro, 128)
    state = prefill_build(k, v, retro, plan.m_max, dtype=jnp.float32)
    for _ in range(n_append):
        kn = jnp.asarray(rng.standard_normal((B, H, hd)), jnp.float32)
        state = append_token(state, kn, kn)
    q = jnp.asarray(rng.standard_normal((B, G * H, hd)), jnp.float32)
    return q, state, retro, plan


def _port_state(state):
    return wave_states_from_numpy(
        {f: np.asarray(getattr(state, f))[None] for f in state._fields},
        "cpu")[0]


def _port_retro():
    from repro_torch.configs.base import RetroConfig
    return RetroConfig(**BASE)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def test_retrieval_cover_and_rank_match_reference():
    from repro.core import attention as RA
    q, state, retro, plan = _ref_state(seed=3)
    B, H = state.centroid.shape[:2]
    qg = q.reshape(B, H, q.shape[1] // H, q.shape[-1])
    ref = RA.wave_decode_rank(qg, state, retro, plan, with_cover=True)
    got = PA.wave_decode_rank(_t(qg), _port_state(state), _port_retro(),
                              ZonePlan(*plan), with_cover=True)
    assert [t.shape for t in got[:4]] == [np.asarray(t).shape
                                          for t in ref[:4]]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(list(got[1:4]) + list(got[4]),
                    list(ref[1:4]) + list(ref[4])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the cover on the reference's own cs and ids: NEG exactly where dead
    cs, idx = RA.rank_clusters(qg, state, plan)
    idx_r = idx[:, :, :plan.r]
    ref_cov = RA._retrieval_cover(state, cs, idx_r)
    cov = PA._retrieval_cover(_port_state(state), _t(cs), _t(idx_r))
    for a, b in zip(cov, ref_cov):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        np.testing.assert_array_equal(a.numpy() <= -1e29,
                                      np.asarray(b) <= -1e29)


def test_flush_segment_offload_matches_reference():
    """Full staging buffers, one row flushed: the meta index and the
    returned payload blocks equal the reference's, with the payload stores
    ``None`` on both sides; and equal what the direct flush writes into the
    stores at the row's old cluster offset."""
    import jax.numpy as jnp
    from repro.core.wave_index import flush_segment_offload as ref_flush
    _, state, retro, _ = _ref_state(seed=5, n_append=128)
    rows = np.array([True, False])
    live = state._replace(k_store=None, v_store=None, pos_store=None)
    ref_st, ref_res = ref_flush(live, retro, rows=jnp.asarray(rows))
    port = _port_state(state)
    old_ncl = port.n_clusters.clone()
    p_live = port._replace(k_store=None, v_store=None, pos_store=None)
    st, res = flush_segment_offload(p_live, _port_retro(),
                                    rows=torch.from_numpy(rows))
    assert st.k_store is None and st.pos_store is None
    for f in ("centroid", "vsum", "size", "stored", "max_pos", "n_clusters",
              "local_k", "local_v", "local_len", "length"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(ref_st, f)), **TOL,
                                   err_msg=f)
    for f in res._fields:
        np.testing.assert_allclose(getattr(res, f)[0].numpy(),
                                   np.asarray(getattr(ref_res, f))[0],
                                   **TOL, err_msg=f)
    # the direct flush on the same state writes those blocks in place
    from repro_torch.core.wave_index import flush_segment
    full = _port_state(state)
    full = flush_segment(full, _port_retro(), rows=torch.from_numpy(rows))
    k_new = res.size.shape[2]
    o = int(old_ncl[0])
    for f in ("k_store", "v_store", "pos_store"):
        assert torch.equal(getattr(full, f)[0, :, o:o + k_new],
                           getattr(res, f)[0]), f
    assert torch.equal(full.centroid, st.centroid)


def _slot_store(state, idx, extra=3, seed=0):
    """The ``idx`` blocks of the stores moved to shuffled slots of a block
    store with ``extra`` junk slots (never read): (kv_src, slot ids)."""
    k, v, p = (np.asarray(getattr(state, f)) for f in
               ("k_store", "v_store", "pos_store"))
    B, H, r = idx.shape
    rng = np.random.default_rng(seed)
    N = r + extra
    kb = rng.standard_normal((B, H, N) + k.shape[3:]).astype(k.dtype)
    vb = rng.standard_normal((B, H, N) + v.shape[3:]).astype(v.dtype)
    pb = rng.integers(0, 600, (B, H, N) + p.shape[3:]).astype(np.int32)
    slots = np.zeros((B, H, r), np.int32)
    for b in range(B):
        for h in range(H):
            perm = rng.permutation(N)[:r]
            slots[b, h] = perm
            kb[b, h, perm] = k[b, h, idx[b, h]]
            vb[b, h, perm] = v[b, h, idx[b, h]]
            pb[b, h, perm] = p[b, h, idx[b, h]]
    return (kb, vb, pb), slots


@pytest.mark.parametrize("mask", ["none", "ones", "mixed"])
@pytest.mark.parametrize("impl", PA.ATTN_IMPLS)
def test_attend_hooks_match_reference(impl, mask):
    """``wave_attention_attend`` through a shuffled slot store with the
    validity mask and the cover, against the reference (its Pallas kernels
    run by the Pallas interpreter)."""
    import jax.numpy as jnp
    from repro.core import attention as RA
    q, state, retro, plan = _ref_state(seed=7)
    B, H = state.centroid.shape[:2]
    qg = q.reshape(B, H, q.shape[1] // H, q.shape[-1])
    idx, el, cs, vs, cover = RA.wave_decode_rank(qg, state, retro, plan,
                                                 with_cover=True)
    kv_np, slots = _slot_store(state, np.asarray(idx))
    valid = {"none": None, "ones": np.ones(slots.shape, np.int32),
             "mixed": np.random.default_rng(9).integers(0, 2, slots.shape)
             .astype(np.int32)}[mask]
    ref_kw = dict(kv_src=tuple(jnp.asarray(a) for a in kv_np), impl=impl,
                  valid=None if valid is None else jnp.asarray(valid),
                  cover=cover)
    from repro.kernels.wave_attention import ops as ref_ops
    orig = ref_ops.paged_wave_attention

    def interpreted(*a, **k):       # the Pallas kernel itself, interpreted
        return orig(*a, **{**k, "emulate": False})

    with mock.patch.object(ref_ops, "paged_wave_attention", interpreted):
        ref = RA.wave_attention_attend(q, state, retro, plan,
                                       jnp.asarray(slots), el, cs, vs,
                                       **ref_kw).out
    pstate, pretro, pplan = _port_state(state), _port_retro(), ZonePlan(*plan)
    args = (_t(q), pstate, pretro, pplan, _t(slots), _t(el), _t(cs), _t(vs))
    port_kw = dict(kv_src=tuple(_t(a) for a in kv_np), impl=impl,
                   valid=None if valid is None else _t(valid),
                   cover=tuple(_t(c) for c in cover))
    out = PA.wave_attention_attend(*args, **port_kw).out
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the slot store holds the clusters' bits: same as reading the stores
    base = PA.wave_attention_attend(
        _t(q), pstate, pretro, pplan, _t(idx), _t(el), _t(cs), _t(vs),
        impl=impl).out
    unmasked = PA.wave_attention_attend(*args, impl=impl,
                                        kv_src=port_kw["kv_src"]).out
    assert torch.equal(unmasked, base)
    if mask == "ones":          # gated cover entries add exact zeros
        assert torch.equal(out, base)
    if mask == "mixed":
        assert not torch.equal(out, base)


def test_fused_validity_rides_live_operand():
    """Under "fused" the mask reaches the paged kernel as its ``live``
    operand and the cover widens the estimation zone by r entries."""
    from repro_torch.kernels.wave_attention import ops as wa_ops
    from repro.core import attention as RA
    q, state, retro, plan = _ref_state(seed=11)
    B, H = state.centroid.shape[:2]
    qg = q.reshape(B, H, q.shape[1] // H, q.shape[-1])
    idx, el, cs, vs, cover = RA.wave_decode_rank(qg, state, retro, plan,
                                                 with_cover=True)
    valid = np.random.default_rng(1).integers(0, 2, np.asarray(idx).shape)
    seen = {}

    def spy(*a, **k):
        seen["live"] = a[wa_ops.ARG_NAMES.index("live")].clone()
        seen["E"] = a[wa_ops.ARG_NAMES.index("vs_e")].shape[2]
        return wa_ops.paged_wave_attention_plain(*a, **k)

    with mock.patch.object(wa_ops, "paged_wave_attention", spy):
        PA.wave_attention_attend(
            _t(q), _port_state(state), _port_retro(), ZonePlan(*plan),
            _t(idx), _t(el), _t(cs), _t(vs), impl="fused",
            valid=_t(valid.astype(np.int32)),
            cover=tuple(_t(c) for c in cover))
    np.testing.assert_array_equal(seen["live"].numpy(), valid)
    assert seen["E"] == np.asarray(vs).shape[2] + plan.r


def test_launcher_offload_flags(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "gemma2_2b", "--reduced", "--device", "cpu",
                "--requests", "3", "--prompt-lens", "120,90",
                "--new-tokens", "4", "--stagger", "2", "--prefill-chunk",
                "64", "--offload", "--cache-frac", "0.3", "--cache-policy",
                "clock", "--fault-profile", "transient=0.3,seed=1",
                "--fetch-deadline", "0.001", "--fetch-retries", "0"])
    out = capsys.readouterr().out
    assert "retro+offload" in out and "wave buffer: hit" in out
    assert "link faults:" in out and "failed fetches" in out
    assert "req 2: prompt 120, out 8," in out


def test_offload_knobs_and_family_gate(models):
    _, _, cfg, params = models
    assert M.supports_offload(cfg)
    assert not M.supports_offload(cfg.replace(family="ssm"))
    assert not M.supports_offload(cfg, runtime="full")
    eng = ServeEngine(cfg, params, device="cpu", offload=True,
                      fault_profile="transient=0.5,seed=4", cache_frac=0.02)
    fault = eng.placement.fault_profile
    assert fault.transient == 0.5 and fault.seed == 4
    assert eng.placement.cache_slots(256) == 5
    assert eng.placement.cache_slots(10) == 1        # never zero slots
    assert ServeEngine(cfg, params, device="cpu",
                       cache_clusters=7).placement.cache_slots(256) == 7
    assert not ServeEngine(cfg, params, device="cpu").placement.offload


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_offload_on_card_matches_cpu(cuda, impl):
    """Reduced offload serve under a seeded fault profile on the card and on
    the CPU: the same tokens, statuses and counters; then offload decode
    logits on the card within 1e-3 of the CPU's, and within the file's 1e-5
    of the card's direct path (the cover lengthens the estimation fold)."""
    cfg = gemma2_2b.reduced().replace(tie_embeddings=False)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
        else [to(v) for v in t] if isinstance(t, list) \
        else t.to(cuda) if hasattr(t, "to") else t
    card = to(cpu)
    kw = dict(cache_frac=0.25, fetch_deadline_s=0.01,
              fault_profile="transient=0.2,spike=0.1,seed=3")
    news = (8, 6, 136)
    want, _ = _port_serve(cfg, cpu, impl, news, **kw)
    got, m = _port_serve(cfg, card, impl, news, device=cuda, **kw)
    assert got == want and m.degraded_steps > 0
    d_cpu, o_cpu, _ = _offload_vs_direct(cfg, cpu, impl, "cpu")
    d_card, o_card, _ = _offload_vs_direct(cfg, card, impl, cuda)
    assert torch.isfinite(o_card).all()
    assert (o_card - o_cpu).abs().max().item() <= 1e-3
    torch.testing.assert_close(o_card, d_card, **TOL)
