"""K-EXAONE on the port against the benchmark's plain reference
(``perfbench/reference/kexaone.py``), at the reduced size on the CPU
(``configs/k_exaone_236b_a23b.py::reduced``: five layers of kinds L L L G
L, layer 0 dense, window 8, 4 of 8 experts held from expert 2, top 2,
float32) with seeded weights and a nonzero selection bias.

Tolerances. Both sides compute in float32 from the same weights; they
differ only in the order of their sums (the port's chunked attention and
grouped expert rows, the reference's blocks): logits read ~7e-7 (1 + max
|ref|) apart, and are held within 2e-5 (1 + max |ref|), which a bfloat16
rounding anywhere on the path (2^-9 relative) would exceed many times. The
expert share's algebra reads ~1e-7 and is held within 2e-6 (1 + max
|ref|): one layer, f32 sums in another order."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # perfbench
from perfbench.reference import kexaone as ref  # noqa: E402
from repro_torch.configs import k_exaone_236b_a23b as kx  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core import attention as wa  # noqa: E402
from repro_torch.core.zones import plan_zones  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

LOGIT_TOL = 2e-5
SHARE_TOL = 2e-6


def _params(cfg, seed=0):
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for lp in params["layers"]:
        # nonzero norms and selection bias: every weight the reference reads
        for name in ("ln_post_attn", "ln_post_ffn"):
            lp[name].copy_(0.1 * torch.randn(lp[name].shape, generator=g))
        for name in ("q_norm", "k_norm"):
            lp["attn"][name].copy_(0.1 * torch.randn(lp["attn"][name].shape,
                                                     generator=g))
        if "moe" in lp:
            b = lp["moe"]["router_bias"]
            b.copy_(0.3 * torch.randn(b.shape, generator=g))
    return params


def _conf(cfg):
    """The reference's configuration keys for a port config."""
    a, m = cfg.attn, cfg.moe
    kinds = {"l": "sliding_attention", "g": "full_attention"}
    return {"hidden_size": cfg.d_model, "num_attention_heads": a.n_heads,
            "num_key_value_heads": a.n_kv_heads, "head_dim": a.head_dim,
            "rms_norm_eps": cfg.norm_eps,
            "rope_parameters": {"rope_theta": a.rope_theta},
            "sliding_window": a.sliding_window,
            "layer_types": [kinds[k] for k in cfg.layer_kinds()],
            "num_experts_per_tok": m.top_k, "first_held_expert": m.expert_lo,
            "routed_scaling_factor": m.routed_scale,
            "wave_index": {f: getattr(cfg.retro, f) for f in (
                "avg_cluster", "cluster_cap", "prefill_segment",
                "update_segment", "sink", "local", "retrieval_frac",
                "estimation_frac", "kmeans_iters", "centering")}}


def _close(got, want, tol):
    err = (got - want).abs().max().item()
    assert err <= tol * (1 + want.abs().max().item()), err


def test_config_published_and_reduced():
    c = get_config("k_exaone_236b_a23b")
    assert c is kx.CONFIG
    assert c.layer_kinds()[:8] == ("l", "l", "l", "g") * 2
    assert c.moe.routed == 128 and c.moe.num_experts == 128
    r = reduced_config("k_exaone_236b_a23b")
    assert r.layer_kinds() == ("l", "l", "l", "g", "l")
    assert r.moe.routed == 8 and r.moe.num_experts == 4


@pytest.mark.parametrize("impl", ["jnp", "fused"])
def test_prefill_and_decode_logits_match_reference(impl):
    """Prefill logits, then teacher-forced decode through the cache for 20
    steps (more than the window of 8: every ring wraps twice), against the
    reference over the same sequence: exact attention at admission, then
    ring layers exact over their window and the global layer through the
    wave index at the plan's budgets."""
    cfg = reduced_config("k_exaone_236b_a23b")
    params = _params(cfg)
    g = torch.Generator().manual_seed(5)
    P, N = 100, 20
    seq = torch.randint(0, cfg.vocab, (P + N,), generator=g)
    plan = plan_zones(P, cfg.retro, 64)
    logits, st = M.apply_prefill(params, cfg, {"tokens": seq[None, :P]},
                                 plan=plan, gen_headroom=64)
    kinds = [type(s).__name__ for s in st.kv]
    assert kinds == ["RingCache"] * 3 + ["WaveState", "RingCache"]
    got = [logits[0]]
    counts = torch.zeros(2, dtype=torch.int64)
    for t in range(P, P + N - 1):
        logits, st = M.apply_decode(params, cfg, st, seq[t:t + 1], plan=plan,
                                    attn_impl=impl, moe_counts=counts)
        got.append(logits[0])
    want = ref.logits(params, _conf(cfg), seq[:P + N - 1], P - 1,
                      retro={"prompt_len": P, "r": plan.r, "e": plan.e})
    _close(torch.stack(got), want, LOGIT_TOL)
    # every step: 4 MoE layers x 4 held experts x 1 row computed
    assert counts[1].item() == (N - 1) * 4 * 4
    assert 0 < counts[0].item() <= (N - 1) * 4 * cfg.moe.top_k


def test_prefill_logits_ragged_row_match_reference():
    """A right-padded row of a two-row admission: its ring takes the last
    window of its own prompt, and its logits are those of the prompt
    alone."""
    cfg = reduced_config("k_exaone_236b_a23b")
    params = _params(cfg, seed=3)
    g = torch.Generator().manual_seed(9)
    toks = torch.randint(0, cfg.vocab, (2, 90), generator=g)
    lens = torch.tensor([90, 61])
    logits, st = M.apply_prefill(params, cfg, {"tokens": toks}, lengths=lens,
                                 gen_headroom=64)
    for row, n in enumerate(lens.tolist()):
        want = ref.logits(params, _conf(cfg), toks[row, :n], n - 1)
        _close(logits[row:row + 1], want, LOGIT_TOL)
    ring = st.kv[0]
    assert ring.length.tolist() == [90, 61]
    assert sorted(ring.pos[1].tolist()) == list(range(61 - 8, 61))


@pytest.mark.parametrize("step", [False, True], ids=["admission", "decode"])
def test_shares_add_up_to_the_uncut_layer(step):
    """Two shares of 4 of 8 experts (experts [0, 4) and [4, 8)), each
    routing over all 8: their results, with the shared expert (which each
    share computes alike) counted once, add up to the uncut reference's
    layer, in the dropless admission and in the capacity-B decode step."""
    D, F = 32, 16
    full = MoEConfig(num_experts=8, top_k=3, d_expert=F, scoring="sigmoid",
                     d_shared=F, routed_scale=2.5)
    p = moe.init_moe(torch.Generator().manual_seed(0), D, full,
                     torch.float32, "cpu")
    p["router_bias"].copy_(0.5 * torch.randn(8, generator=torch.Generator()
                                             .manual_seed(1)))
    x = torch.randn((12, D), generator=torch.Generator().manual_seed(2))
    parts = []
    for lo in (0, 4):
        share = MoEConfig(num_experts=4, top_k=3, d_expert=F,
                          scoring="sigmoid", d_shared=F, routed_scale=2.5,
                          n_routed=8, expert_lo=lo)
        ps = dict(p, **{k: p[k][lo:lo + 4] for k in ("w_gate", "w_up",
                                                      "w_down")})
        parts.append(moe.share_apply(ps, x, share, step=step))
    shared = moe.L.mlp_apply(p["shared"], x)
    uncut = ref._share(p, x, {"num_experts_per_tok": 3,
                              "first_held_expert": 0,
                              "routed_scaling_factor": 2.5}, "f32")
    _close(parts[0] + parts[1] - shared, uncut, SHARE_TOL)
    _close(moe.share_apply(p, x, full, step=step), uncut, SHARE_TOL)


def test_share_decode_counts_routed_rows():
    """The decode step's counters: token-expert pairs of active rows routed
    to held experts, and E x B rows computed."""
    D, F = 16, 8
    share = MoEConfig(num_experts=2, top_k=2, d_expert=F, scoring="sigmoid",
                      routed_scale=1.0, n_routed=4, expert_lo=1)
    p = moe.init_moe(torch.Generator().manual_seed(0), D, share,
                     torch.float32, "cpu")
    x = torch.randn((6, D), generator=torch.Generator().manual_seed(1))
    active = torch.tensor([True, True, False, True, False, True])
    counts = torch.zeros(2, dtype=torch.int64)
    moe.share_apply(p, x, share, step=True, active=active, counts=counts)
    top, _ = moe.share_route(p, x, share)
    held = ((top >= 1) & (top < 3)) & active[:, None]
    assert counts.tolist() == [int(held.sum()), 2 * 6]


def test_ring_wraparound_is_exact_window_attention():
    """A ring of W 5 fed 23 tokens (one row idle for some steps) attends
    exactly what a softmax over the last W positions of the row's whole
    history gives."""
    B, H, G, W, hd = 2, 2, 3, 5, 8
    g = torch.Generator().manual_seed(0)
    k0 = torch.randn((B, 7, H, hd), generator=g)
    v0 = torch.randn((B, 7, H, hd), generator=g)
    lens = torch.tensor([7, 3])
    ring = wa.ring_from_prompt(k0, v0, W, torch.float32, lengths=lens)
    hist_k = [[k0[b, t] for t in range(int(lens[b]))] for b in range(B)]
    hist_v = [[v0[b, t] for t in range(int(lens[b]))] for b in range(B)]
    for step in range(16):
        k = torch.randn((B, H, hd), generator=g)
        v = torch.randn((B, H, hd), generator=g)
        q = torch.randn((B, H * G, hd), generator=g)
        active = torch.tensor([True, step % 3 != 1])
        wa.ring_append(ring, k, v, active=active)
        out = wa.ring_attention_decode(q, ring)
        for b in range(B):
            if not active[b]:
                continue
            hist_k[b].append(k[b])
            hist_v[b].append(v[b])
            kw = torch.stack(hist_k[b][-W:])               # (n, H, hd)
            vw = torch.stack(hist_v[b][-W:])
            qb = q[b].view(H, G, hd)
            s = torch.einsum("hgd,nhd->hgn", qb, kw) / hd ** 0.5
            want = torch.einsum("hgn,nhd->hgd", s.softmax(-1), vw)
            _close(out[b].view(H, G, hd), want, 1e-6)
    assert ring.length.tolist() == [len(hist_k[0]), len(hist_k[1])]


def test_serve_moves_counters_and_graft_carries_both_states():
    """Blocking admission through ``ServeEngine`` (direct store, fused
    twin): every request finishes, each slot's rings and wave index are
    grafted in, and the share layers' counters are read once."""
    cfg = reduced_config("k_exaone_236b_a23b")
    params = _params(cfg)
    eng = ServeEngine(cfg, params, device="cpu", admission="blocking",
                      attn_impl="fused", max_context=160, gen_headroom=64)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=n,
                                        dtype=np.int32), max_new_tokens=m)
            for n, m in ((100, 12), (60, 20), (150, 9))]
    m = eng.serve(reqs, 2)
    assert all(r.done and r.status == "ok"
               and len(r.out_tokens) == r.max_new_tokens for r in reqs)
    assert m.moe_rows_computed == m.steps * 4 * cfg.moe.num_experts * 2
    assert 0 < m.moe_rows_routed <= m.moe_rows_computed
    kv = eng.last_state.kv
    assert [type(s).__name__ for s in kv] == \
        ["RingCache"] * 3 + ["WaveState", "RingCache"]
    assert kv[0].k.shape[2] == cfg.attn.sliding_window


@pytest.mark.parametrize("what", ["chunked", "offload", "chunk_state"])
def test_chunked_and_offload_refuse_ring_layers(what):
    cfg = reduced_config("k_exaone_236b_a23b")
    params = _params(cfg)
    with pytest.raises(ValueError, match="ring cache of sliding layers"):
        if what == "chunked":
            ServeEngine(cfg, params, device="cpu", admission="chunked")
        elif what == "offload":
            ServeEngine(cfg, params, device="cpu", admission="blocking",
                        offload=True)
        else:
            M.make_prefill_chunk_state(cfg, 1, 128, chunk=32, device="cpu")
    assert not M.supports_offload(cfg)
    # the full runtime keeps dense caches, windowed by mask: nothing refused
    ServeEngine(cfg, params, device="cpu", runtime="full",
                admission="chunked")
