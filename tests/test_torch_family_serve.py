"""``ServeEngine`` on the non-attention families against the reference's
engine on the same requests: reduced rwkv6-3b (ssm), zamba2-1.2b (hybrid)
and whisper-tiny (audio, with seeded frame embeddings in
``Request.extra``), both runtimes where the family has two, f32 on the CPU
from the same numpy parameters. A 32-token update segment makes request
0's 40 new tokens cross a flush of every wave index.

Held: the token streams, every first token's logits (the random
tied-embedding models emit a near-constant argmax token, so tokens alone
say little) and every leaf of the last decode state; chunked admission
falls back to blocking (the same result); prompts are not padded to
``prefill_bucket``; ssm serves a 1-token prompt; offload is refused.
Tolerance: f32 within 1e-5 (1 + |ref|), the recurrent matrix states
(``ssm``, ``wkv``) within 1e-6 (1 + max |ref|) of their layer, integer
leaves equal (see ``test_torch_rwkv6.py``).

On a CUDA card (marked ``cuda``, skipped without one): each family's
reduced decode step in bf16, captured by ``DecodeGraph``, replays bit for
bit as the eager step. The reference is imported inside the fixtures, so
the ``cuda`` cases also run on a machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_family_serve.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.interop import params_from_numpy, serve_state_to_numpy
from repro_torch.models import model as M
from repro_torch.serving import graphs
from repro_torch.serving.engine import (Request, Sampler, ServeEngine,
                                        _DirectStore)

torch.set_num_threads(2)
RTOL, STATE_TOL = 1e-5, 1e-6
NEWS, CTX, HEADROOM = (40, 6, 12), 80, 64
LENS = {"rwkv6_3b": (70, 1, 60), "zamba2_1p2b": (70, 45, 60),
        "whisper_tiny": (70, 45, 60)}
CASES = [("rwkv6_3b", "retro"), ("zamba2_1p2b", "retro"),
         ("zamba2_1p2b", "full"), ("whisper_tiny", "retro"),
         ("whisper_tiny", "full")]
RECURRENT = ("ssm", "wkv")


def _short_flush(cfg):
    return cfg.replace(retro=dataclasses.replace(cfg.retro, update_segment=32,
                                                 local=16))


def ref_tree(x):
    """A reference state as nested dicts of numpy arrays by field."""
    if hasattr(x, "_fields"):
        return {f: ref_tree(getattr(x, f)) for f in x._fields}
    return np.asarray(x)


def assert_tree(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree(got[k], want[k], f"{what}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    if what.endswith(RECURRENT):
        d = np.abs(got - want).reshape(len(want), -1).max(-1)
        err = (d / (1 + np.abs(want).reshape(len(want), -1).max(-1))).max()
        assert err <= STATE_TOL, f"{what}: {err:.3e}"
    else:
        err = (np.abs(got - want) / (1 + np.abs(want))).max()
        assert err <= RTOL, f"{what}: {err:.3e}"


def _requests(make, cfg, arch):
    rng = np.random.default_rng(21)
    reqs = [make(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                 max_new_tokens=m) for n, m in zip(LENS[arch], NEWS)]
    if cfg.family == "audio":
        for r in reqs:
            r.extra = {"frames": rng.standard_normal(
                (1, cfg.encoder_frames, cfg.d_model)).astype(np.float32)}
    return reqs


@pytest.fixture(scope="module")
def models():
    import importlib

    import jax

    from repro.models import model as RM
    out = {}
    for arch in LENS:
        ref_cfg = _short_flush(importlib.import_module(
            f"repro.configs.{arch}").reduced())
        cfg = _short_flush(registry.reduced_config(arch))
        ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(7))
        out[arch] = (ref_cfg, ref_params, cfg, params_from_numpy(
            jax.tree.map(np.asarray, ref_params), cfg, "cpu"))
    return out


@pytest.fixture(scope="module")
def ref_serves(models):
    """Every case served once by the reference's engine, recording each
    admission's first-token logits and the last decode state."""
    from repro.serving import engine as RE

    class Recording(RE.ServeEngine):
        def _prefill_fn(self, seq_len, max_ctx):
            fn = super()._prefill_fn(seq_len, max_ctx)

            def rec(params, batch, lengths):
                out = fn(params, batch, lengths)
                self.first_logits.append(np.asarray(out[0]))
                return out
            return rec

        def _decode_fns(self, batch_size, max_ctx):
            decode, flush = super()._decode_fns(batch_size, max_ctx)

            def dec(*args, **kw):
                out = decode(*args, **kw)
                self.last_state = ref_tree(out[1])
                return out

            def fl(state):
                out = flush(state)
                self.last_state = ref_tree(out)
                return out
            return dec, fl

    out = {}
    for arch, runtime in CASES:
        ref_cfg, ref_params, _, _ = models[arch]
        eng = Recording(ref_cfg, ref_params, runtime=runtime,
                        admission="blocking", gen_headroom=HEADROOM,
                        max_context=CTX)
        eng.first_logits = []
        reqs = _requests(RE.Request, ref_cfg, arch)
        m = eng.serve(reqs, batch_size=2)
        out[arch, runtime] = dict(
            tokens=[r.out_tokens for r in reqs], steps=m.steps,
            flushes=None, logits=np.concatenate(eng.first_logits),
            state=eng.last_state)
    return out


def _port_serve(models, arch, runtime, monkeypatch, **kw):
    """The port's engine on the case's requests; returns the metrics, the
    requests, the first-token logits and each prefill's token count."""
    _, _, cfg, params = models[arch]
    seen = dict(logits=[], lens=[])
    real = M.apply_prefill

    def rec(params, cfg, batch, **k):
        out = real(params, cfg, batch, **k)
        seen["logits"].append(out[0].numpy())
        seen["lens"].append(batch["tokens"].shape[1])
        return out
    monkeypatch.setattr(M, "apply_prefill", rec)
    eng = ServeEngine(cfg, params, runtime=runtime, gen_headroom=HEADROOM,
                      max_context=CTX, device="cpu", **kw)
    reqs = _requests(Request, cfg, arch)
    m = eng.serve(reqs, batch_size=2)
    return eng, m, reqs, seen


@pytest.mark.parametrize("arch,runtime", CASES)
def test_family_serve_matches_reference(models, ref_serves, monkeypatch,
                                        arch, runtime):
    eng, m, reqs, seen = _port_serve(models, arch, runtime, monkeypatch,
                                     admission="blocking")
    ref = ref_serves[arch, runtime]
    assert [r.out_tokens for r in reqs] == ref["tokens"]
    assert m.steps == ref["steps"]
    assert m.tokens_out == sum(NEWS)
    assert (m.flushes >= 1) == (runtime == "retro" and arch != "rwkv6_3b")
    assert_tree(np.concatenate(seen["logits"]), ref["logits"], "logits")
    assert_tree(serve_state_to_numpy(eng.last_state), ref["state"],
                "state")
    assert eng.last_graph.replays == 0      # the CPU steps eagerly


@pytest.mark.parametrize("arch", list(LENS))
def test_chunked_admission_falls_back_to_blocking(models, monkeypatch, arch):
    """``admission="chunked"`` (the default) admits these families blocking
    and unpadded, whatever ``prefill_bucket``: the same tokens and state
    bits as a blocking serve."""
    blk, _, blk_reqs, _ = _port_serve(models, arch, "retro", monkeypatch,
                                      admission="blocking")
    eng, _, reqs, seen = _port_serve(models, arch, "retro", monkeypatch,
                                     prefill_bucket=64)
    assert seen["lens"] == list(LENS[arch])
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in blk_reqs]
    for a, b in zip(graphs.leaves(eng.last_state),
                    graphs.leaves(blk.last_state)):
        assert torch.equal(a, b)


def test_short_prompts_and_offload_refusal(models):
    """ssm takes a 1-token prompt under either runtime (its minimum is
    1); the retro hybrid needs sink + 1 tokens; offload is refused with
    the reference's message."""
    _, _, cfg, params = models["rwkv6_3b"]
    for runtime in ("retro", "full"):
        eng = ServeEngine(cfg, params, runtime=runtime, device="cpu")
        r = Request(prompt=np.array([5], np.int32), max_new_tokens=3)
        eng.serve([r], batch_size=1)
        assert len(r.out_tokens) == 3
    _, _, hcfg, hparams = models["zamba2_1p2b"]
    with pytest.raises(ValueError, match="outside"):
        ServeEngine(hcfg, hparams, device="cpu").serve(
            [Request(prompt=np.arange(4, dtype=np.int32), max_new_tokens=2)],
            batch_size=1)
    for arch in LENS:
        _, _, c, p = models[arch]
        with pytest.raises(ValueError, match="requires the retro runtime on "
                           "an attention family"):
            ServeEngine(c, p, offload=True, device="cpu")


def test_family_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    for arch in ("rwkv6-3b", "zamba2_1p2b", "whisper_tiny"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "2", "--prompt-lens", "40,30",
                    "--new-tokens", "3"])
        out = capsys.readouterr().out
        assert "served 2 requests" in out, arch
        assert "req 1: prompt 30, out 3," in out, arch
    with pytest.raises(ValueError, match="attention family"):
        serve.main(["--arch", "whisper_tiny", "--reduced", "--device", "cpu",
                    "--offload"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, list):
        return [_clone(t) for t in x]
    return type(x)(*(_clone(t) for t in x))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [("rwkv6_3b", None),
                                       ("zamba2_1p2b", "fused"),
                                       ("zamba2_1p2b", "pallas"),
                                       ("whisper_tiny", "fused")])
def test_family_replay_equals_eager(cuda, arch, impl):
    """Each family's reduced model in bf16 on the card: from one prefill
    state, eight eager steps and eight steps of the ``DecodeGraph``
    (warm-up, then seven replays) give the same logits, ids and state bit
    for bit, a row inactive now and then."""
    cfg = registry.reduced_config(arch).replace(dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    S = 200
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    batch = {"tokens": torch.from_numpy(toks).to(cuda)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (2, cfg.encoder_frames, cfg.d_model), device=cuda,
            generator=torch.Generator(device=cuda).manual_seed(1)) \
            .to(torch.bfloat16)
    from repro_torch.core.zones import plan_zones
    plan = None if cfg.family == "ssm" else plan_zones(S, cfg.retro, 64)
    with torch.inference_mode():
        _, state0 = M.apply_prefill(params, cfg, batch, plan=plan,
                                    gen_headroom=64)
        tokens = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
        stage = _DirectStore(cfg, params, plan, _clone(state0), tokens,
                             Sampler(device=cuda), runtime="retro",
                             attn_impl=impl or "jnp").graph
        fn, eager, tok = stage.fn, _clone(state0), tokens.clone()
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
    for a, b in zip(graphs.leaves(stage.state), graphs.leaves(eager)):
        assert torch.equal(a, b)
