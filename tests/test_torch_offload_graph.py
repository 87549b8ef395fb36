"""The compiled offload stage (``serving/graphs.py::OffloadStage``) on
gemma2-2b ``reduced()``: the padded block-cache update against the
reference's jitted ``cache_upd`` / ``cache_stage`` bit for bit, every
tensor the stage captures keeping its address through an offload serve
(flush, a slot freed and re-admitted, seeded faults), and a rank half that
rebinds a live field raising. On a CUDA card (marked ``cuda``, skipped
without one: a CUDA graph has no CPU mode): replayed offload steps equal
eager ones (logits bits, ids, wave-buffer counters, bytes to the device)
for every impl, a serve run captures once, and a capture error raises.
The reference is imported inside the test that uses it, so the ``cuda``
cases also run on a machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_offload_graph.py -q
"""
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import gemma2_2b
from repro_torch.core.wave_index import WaveState
from repro_torch.core.zones import plan_zones
from repro_torch.kernels.wave_attention import ops as wa_ops
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.models.transformer import ServeState
from repro_torch.serving import graphs
from repro_torch.serving.engine import (Request, Sampler, ServeEngine,
                                        ServeMetrics, _OffloadPlane)

torch.set_num_threads(2)
S, CHUNK, HEADROOM = 384, 96, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg():
    """Reduced gemma2-2b (SMOKE_RETRO), untied head so greedy tokens vary."""
    return gemma2_2b.reduced().replace(tie_embeddings=False)


def _params(cfg, device="cpu", seed=0):
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
        else [to(v) for v in t] if isinstance(t, list) \
        else t.to(device) if isinstance(t, torch.Tensor) else t
    return to(params)


# ---------------------------------------------------------------------------
# (a) the padded cache update against the reference's jitted update
# ---------------------------------------------------------------------------

B, H, C, R, CAP, HD = 2, 2, 5, 3, 4, 8
D = 2 * CAP * HD + CAP
N = B * H * R
# name -> admissions per (row, head) (None: nothing queued, the reference's
# cache_stage), the miss share of the tail. Where fewer than R admissions
# are queued, the reference's other entries are out-of-range slot ids
# (dropped), at random places among the in-range ones.
UPDATE_CASES = {"none": (None, 0.0), "misses": (None, 0.5),
                "some": (2, 0.5), "all": (R, 1.0)}


def _update_inputs(case, dtype, seed=0):
    """Random caches, admissions and misses in the reference's padded
    (B, H, r) layout."""
    per_row, miss_share = UPDATE_CASES[case]
    rng = np.random.default_rng(seed)
    cast = lambda a: torch.from_numpy(a).to(dtype).float().numpy()
    ck = cast(rng.standard_normal((B, H, C + R, CAP, HD), np.float32))
    cv = cast(rng.standard_normal((B, H, C + R, CAP, HD), np.float32))
    cp = rng.integers(-1, 500, (B, H, C + R, CAP)).astype(np.int32)
    slots = np.full((B, H, R), C + R, np.int32)             # out of range
    adm = [cast(rng.standard_normal((B, H, R, CAP, HD), np.float32))
           for _ in range(2)] + [rng.integers(0, 500, (B, H, R, CAP))
                                 .astype(np.int32)]
    if per_row is not None:
        for b in range(B):
            for h in range(H):
                at = rng.permutation(R)[:per_row]
                slots[b, h, at] = rng.permutation(C)[:per_row]
    miss = rng.random((B, H, R)) < miss_share
    mk = np.where(miss[..., None, None], cast(rng.standard_normal(
        (B, H, R, CAP, HD), np.float32)), 0).astype(np.float32)
    mv = np.where(miss[..., None, None], cast(rng.standard_normal(
        (B, H, R, CAP, HD), np.float32)), 0).astype(np.float32)
    mp = np.where(miss[..., None], rng.integers(0, 500, (B, H, R, CAP)),
                  -1).astype(np.int32)
    return (ck, cv, cp), (per_row is not None, slots, *adm), (miss, mk, mv, mp)


def _plane_rows(entries):
    """(b, h, slot, k, v, p) entries -> the control plane's ((3, n) [row,
    head, slot] ids, (n, D) packed rows), or None for no entry."""
    if not entries:
        return None
    ids = np.array([e[:3] for e in entries], np.int64).T
    rows = np.stack([np.concatenate([k.ravel(), v.ravel(),
                                     p.astype(np.float32)])
                     for *_, k, v, p in entries])
    return ids, rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_padded_cache_update_matches_reference(case, dtype):
    """A stage's ``load`` (padding to N = B·H·r entries aimed at the dead
    slot, only the n filled rows copied, the rest of the row buffers left
    stale) and its ``cache_update`` leave the C + r slots the reference's
    ``cache_upd`` (admissions queued; out-of-range slot ids dropped) or
    ``cache_stage`` (nothing queued) leaves, bit for bit."""
    import jax
    import jax.numpy as jnp
    from repro.configs import gemma2_2b as ref_gemma
    from repro.models import model as RM
    from repro.serving.engine import ServeEngine as RefEngine
    tdt = getattr(torch, dtype)
    (ck, cv, cp), (queued, slots, ak, av, ap), (miss, mk, mv, mp) = \
        _update_inputs(case, tdt)
    ref_cfg = ref_gemma.reduced().replace(dtype=dtype)
    eng = RefEngine(ref_cfg, RM.init_params(ref_cfg, jax.random.PRNGKey(0)),
                    offload=True)
    fns = eng._offload_fns(B, S, C, R)
    cache_upd, cache_stage = fns[4], fns[5]
    jdt = getattr(jnp, dtype)
    ref_c = (jnp.asarray(ck, jdt), jnp.asarray(cv, jdt), jnp.asarray(cp))
    miss_j = tuple(jnp.asarray(a) for a in (mk, mv, mp))
    if queued:
        ref = cache_upd(*ref_c, jnp.asarray(slots),
                        *(jnp.asarray(a) for a in (ak, av, ap)), *miss_j)
    else:
        ref = cache_stage(*ref_c, *miss_j)

    adm = _plane_rows([(b, h, slots[b, h, j], ak[b, h, j], av[b, h, j],
                        ap[b, h, j])
                       for b in range(B) for h in range(H) for j in range(R)
                       if queued and slots[b, h, j] < C + R])
    miss_rows = _plane_rows([(b, h, C + j, mk[b, h, j], mv[b, h, j],
                              mp[b, h, j])
                             for b in range(B) for h in range(H)
                             for j in range(R) if miss[b, h, j]])
    if case == "all":
        assert adm[0].shape[1] == miss_rows[0].shape[1] == N
    dead = lambda a, fill: np.concatenate(
        [a, np.full(a.shape[:2] + (1,) + a.shape[3:], fill, a.dtype)], 2)
    caches = ([torch.from_numpy(dead(ck, 7.0)).to(tdt)],
              [torch.from_numpy(dead(cv, 7.0)).to(tdt)],
              [torch.from_numpy(dead(cp, 7))])
    stage = graphs.OffloadStage(_cfg(), None, SimpleNamespace(r=R), "jnp",
                                caches, C, sample=None)
    assert (stage.N, stage.dead, stage.rows.shape[2]) == (N, C + R, D)
    junk = np.random.default_rng(1).standard_normal((2, N, D)) * 1e3
    stage.rows.copy_(torch.from_numpy(junk))        # a previous step's rows
    stage.load(np.zeros((2, B, H, R), np.int32), adm, miss_rows)
    stage.cache_update(0)
    for got, want in zip((c[0] for c in caches), ref):
        np.testing.assert_array_equal(got[:, :, :C + R].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# (b, c) addresses
# ---------------------------------------------------------------------------

def _prompts(vocab, lens):
    rng = np.random.default_rng(13)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(cfg, params, news, device="cpu", impl="jnp", lens=(S, 256, 320),
           **kw):
    eng = ServeEngine(cfg, params, gen_headroom=HEADROOM, max_context=S,
                      prefill_chunk=CHUNK, attn_impl=impl, offload=True,
                      cache_frac=0.25, device=device, **kw)
    reqs = [Request(p, n) for p, n in zip(_prompts(cfg.vocab, lens), news)]
    return eng, eng.serve(reqs, batch_size=2), reqs


def test_stage_keeps_its_addresses():
    """Every tensor the stage's pieces read or write (the state's tensors,
    the block caches, the token buffer, the static and staging buffers)
    keeps its ``data_ptr`` from the first decode step to the end of an
    offload serve with a flush, a slot freed and re-admitted, and seeded
    transient faults."""
    cfg = _cfg()
    seen = []
    real = _OffloadPlane.decode_step

    def step(self, state, tokens_dev, active):
        out = real(self, state, tokens_dev, active)
        seen.append(self.stage.addresses(state, tokens_dev))
        return out

    with mock.patch.object(_OffloadPlane, "decode_step", step):
        eng, m, reqs = _serve(cfg, _params(cfg), (8, 6, 136),
                              fault_profile="transient=0.2,seed=3")
    stage = eng.last_plane.stage
    assert m.steps == len(seen) >= 136 and m.flushes >= 1
    assert m.cache.faults > 0
    assert len({r.slot for r in reqs}) == 2          # a slot was reused
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    assert set(seen) == {stage.addresses()}
    assert stage.key == (2, S, eng.last_plane.C, eng.last_plane.r, "jnp")
    assert (stage.captures, stage.replays) == (0, 0)
    assert eng.last_graph is stage


def test_rank_half_that_rebinds_a_live_field_raises():
    """A rank half that returns a new tensor for a live field cannot be
    replayed at fixed addresses: the stage refuses it."""
    cfg = _cfg()
    real = transformer.offload_decode_rank

    def rebinding(*a, **k):
        ctx, idx, live = real(*a, **k)
        return ctx, idx, {**live, "local_len": live["local_len"].clone()}

    with mock.patch.object(transformer, "offload_decode_rank", rebinding), \
            pytest.raises(RuntimeError, match="moved"):
        _serve(cfg, _params(cfg), (3, 3, 3))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

ACTIVE = [np.array([True, t % 3 != 1]) for t in range(8)]


def _planes(cfg, params, impl, device):
    """Two requests served directly, then two offload planes with both rows
    admitted from that state, and a copy of the state's live fields for
    each."""
    eng = ServeEngine(cfg, params, gen_headroom=HEADROOM, max_context=S,
                      prefill_chunk=CHUNK, attn_impl=impl, device=device,
                      cache_frac=0.25)
    rng = np.random.default_rng(1)
    eng.serve([Request(rng.integers(0, cfg.vocab, n).astype(np.int32), 2)
               for n in (S, 300)], batch_size=2)
    st = eng.last_state
    plan = plan_zones(S, cfg.retro, HEADROOM)
    out = []
    for _ in range(2):
        plane = _OffloadPlane(cfg, params, plan, 2, S, attn_impl=eng.attn_impl,
                              sample=Sampler(device=device),
                              placement=eng.placement, device=device)
        for i in range(2):
            plane.admit_slot(i, ServeState(kv=[
                WaveState(*(t[i:i + 1].clone() for t in w)) for w in st.kv]))
        state = ServeState(kv=[WaveState(*(t.clone() for t in w))
                               for w in st.kv])
        tok = torch.tensor([5, 7], dtype=torch.int32, device=device)
        out.append((plane, state, tok))
    return out


def _counters(plane):
    m = ServeMetrics()
    plane.export_stats(m)
    return (vars(m.cache), m.degraded_steps, m.dropped_cluster_steps,
            plane.counts["h2d_bytes"], plane.counts["steps"])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["jnp", "fused", "pallas"])
def test_offload_replay_equals_eager(cuda, impl):
    """From one admitted state on the card, eight steps of an eager plane
    (``step``) and eight of one whose stage captures after its first step
    (``decode_step``: the warm-up, then seven replays), one row inactive on
    some: the same logits bits and ids, the same wave-buffer counters and
    the same bytes to the device."""
    cfg = _cfg().replace(dtype="bfloat16")
    params = _params(cfg, cuda)
    with torch.inference_mode():
        (pe, se, te), (pg, sg, tg) = _planes(cfg, params, impl, cuda)
        for t, act in enumerate(ACTIVE):
            le, ie = pe.step(se, te, act)
            lg, ig = pg.decode_step(sg, tg, act)
            assert torch.equal(lg, le), f"step {t}"
            assert torch.equal(ig, ie), f"step {t}"
            assert torch.equal(tg, te)
    torch.cuda.synchronize()
    assert (pg.stage.captures, pg.stage.replays) == (1, len(ACTIVE) - 1)
    assert (pe.stage.captures, pe.stage.replays) == (0, 0)
    assert _counters(pg) == _counters(pe)
    for a, b in zip(sg.kv, se.kv):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f


@pytest.mark.cuda
def test_offload_serve_captures_once(cuda):
    """An offload serve on the card (three admissions, one flush) captures
    its pieces once and replays them every later step, gives the CPU's
    tokens and counters; the paged kernel's wrapper counts layers launches
    for the warm-up and layers for the capture, and none for a replay."""
    cfg = _cfg()
    before = wa_ops.paged_wave_attention.launches
    eng, m, reqs = _serve(cfg, _params(cfg, cuda), (8, 6, 136), cuda,
                          impl="fused")
    stage = eng.last_plane.stage
    assert (stage.captures, stage.replays) == (1, m.steps - 1)
    assert len(stage.graphs) == cfg.n_layers + 1
    assert wa_ops.paged_wave_attention.launches - before == 2 * cfg.n_layers
    assert m.flushes >= 1
    _, m_cpu, cpu_reqs = _serve(cfg, _params(cfg), (8, 6, 136), impl="fused")
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in cpu_reqs]
    assert vars(m.cache) == vars(m_cpu.cache)


@pytest.mark.cuda
def test_offload_capture_error_raises(cuda):
    """A piece that reads a device value back cannot be captured: the
    capture after the warm-up step raises, and nothing falls back to
    eager."""
    cfg = _cfg()
    (_, _, _), (plane, state, tok) = _planes(cfg, _params(cfg, cuda),
                                             "fused", cuda)
    stage = plane.stage
    real = stage._rank

    def reads_back(*a, **k):
        out = real(*a, **k)
        if int(out[1].sum()) < 0:          # a host sync: illegal in capture
            raise AssertionError
        return out

    stage._rank = reads_back
    with torch.inference_mode():
        plane.step(state, tok, np.ones(2, bool))
        with pytest.raises(RuntimeError):
            stage.capture_pieces()
    assert stage.graphs is None and stage.captures == 0
    torch.cuda.synchronize()
