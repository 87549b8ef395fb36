"""The slice end to end on gemma2-2b ``reduced()``: chunked prefill and
decode logits against the JAX package, the serve engine's batch invariance
across a staging-buffer flush, and the port's independence from JAX."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as ref_gemma
from repro.core.zones import plan_zones as ref_plan_zones
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch.configs import gemma2_2b
from repro_torch.core.zones import plan_zones
from repro_torch.interop import (params_from_numpy,
                                 prefill_chunk_state_from_numpy,
                                 serve_state_from_numpy)
from repro_torch.models import model as M
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(atol=1e-4, rtol=1e-4)
CHUNK, MAX_CTX, LENS = 64, 320, (300, 200)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    ref_cfg, cfg = ref_gemma.reduced(), gemma2_2b.reduced()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(_np_tree(ref_params), cfg, "cpu")
    return ref_cfg, ref_params, cfg, params


def _prompts():
    rng = np.random.default_rng(0)
    toks = np.zeros((2, MAX_CTX), np.int32)
    for b, n in enumerate(LENS):
        toks[b, :n] = rng.integers(0, 512, n)
    return toks


@pytest.fixture(scope="module")
def ref_prefill(models):
    """JAX chunked admission of two ragged prompts: per-chunk logits, the
    state after chunk 0, and the finalized serve state."""
    ref_cfg, ref_params, _, _ = models
    toks = _prompts()
    step = jax.jit(functools.partial(RM.apply_prefill_chunk, cfg=ref_cfg))
    cs = RM.make_prefill_chunk_state(ref_cfg, 2, MAX_CTX, chunk=CHUNK,
                                     gen_headroom=128)
    logits, after0 = [], None
    for c0 in range(0, max(LENS), CHUNK):
        clens = np.clip(np.asarray(LENS) - c0, 0, CHUNK).astype(np.int32)
        lg, cs = step(ref_params, batch={"tokens": jnp.asarray(
            toks[:, c0:c0 + CHUNK])}, state=cs, chunk_lens=jnp.asarray(clens))
        logits.append(np.asarray(lg))
        if c0 == 0:
            after0 = _np_tree(cs)
    return toks, logits, after0


def _chunk_lens(c0):
    return torch.from_numpy(
        np.clip(np.asarray(LENS) - c0, 0, CHUNK).astype(np.int32))


def test_prefill_chunk_logits_match(models, ref_prefill):
    _, _, cfg, params = models
    toks, ref_logits, _ = ref_prefill
    cs = M.make_prefill_chunk_state(cfg, 2, MAX_CTX, chunk=CHUNK,
                                    gen_headroom=128, device="cpu")
    for i, c0 in enumerate(range(0, max(LENS), CHUNK)):
        lg, cs = M.apply_prefill_chunk(
            params, cfg, {"tokens": torch.from_numpy(toks[:, c0:c0 + CHUNK])},
            cs, chunk_lens=_chunk_lens(c0))
        live = np.asarray(LENS) > c0           # rows with tokens in this chunk
        np.testing.assert_allclose(lg.numpy()[live], ref_logits[i][live],
                                   **TOL, err_msg=f"chunk {i}")


def test_prefill_resumes_from_carried_state(models, ref_prefill):
    """Hand the JAX admission state after chunk 0 to the port; its chunk 1
    logits match the reference's."""
    _, _, cfg, params = models
    toks, ref_logits, after0 = ref_prefill
    wave = dict(after0.wave._asdict())
    wave["state"] = after0.wave.state._asdict()
    cs = prefill_chunk_state_from_numpy(after0.cache._asdict(), wave, "cpu")
    lg, _ = M.apply_prefill_chunk(
        params, cfg, {"tokens": torch.from_numpy(toks[:, CHUNK:2 * CHUNK])},
        cs, chunk_lens=_chunk_lens(CHUNK))
    np.testing.assert_allclose(lg.numpy(), ref_logits[1], **TOL)


@pytest.mark.parametrize("attn_impl", ["fused", "jnp", "pallas"])
def test_decode_steps_match_reference(models, attn_impl):
    """Eight decode steps from the same carried-across wave state (one
    prompt per row, finalized by the reference) with the same tokens: the
    port's logits match ``decode_step`` with the same ``attn_impl`` (the
    reference's Pallas kernels interpreted) within 1e-4 for every impl: the
    reduced config is f32, so no impl rounds to bf16."""
    ref_cfg, ref_params, cfg, params = models
    toks = _prompts()[0:1, :LENS[0]]
    cs = RM.make_prefill_chunk_state(ref_cfg, 1, LENS[0], chunk=LENS[0],
                                     gen_headroom=128)
    _, cs = RM.apply_prefill_chunk(ref_params, ref_cfg,
                                   {"tokens": jnp.asarray(toks)}, cs)
    ref_state = RM.finalize_prefill_chunk(ref_cfg, cs, total_len=LENS[0])
    state = serve_state_from_numpy(ref_state.kv._asdict(), "cpu")
    ref_plan = ref_plan_zones(LENS[0], ref_cfg.retro, 128)
    plan = plan_zones(LENS[0], cfg.retro, 128)
    dec = jax.jit(functools.partial(RT.decode_step, cfg=ref_cfg,
                                    plan=ref_plan, attn_impl=attn_impl))
    rng = np.random.default_rng(1)
    for t in range(8):
        tok = rng.integers(0, 512, (1,)).astype(np.int32)
        ref_lg, ref_state = dec(ref_params, state=ref_state,
                                token=jnp.asarray(tok))
        lg, state = PT.decode_step(params, cfg, state, torch.from_numpy(tok),
                                   plan=plan, attn_impl=attn_impl)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL,
                                   err_msg=f"step {t}")


def _serve(cfg, params, batch):
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in ((300, 150), (130, 20), (220, 40))]
    eng = ServeEngine(cfg, params, prefill_chunk=CHUNK, max_context=MAX_CTX,
                      gen_headroom=256, device="cpu")
    metrics = eng.serve(reqs, batch_size=batch)
    return reqs, metrics


def test_engine_batch_invariant_across_flush():
    """Untied output head so greedy tokens vary. Request 0 generates 150
    tokens: its staging buffer (local 32 + update 128) flushes mid-run."""
    cfg = gemma2_2b.reduced().replace(tie_embeddings=False)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    solo, m1 = _serve(cfg, params, 1)
    duo, m2 = _serve(cfg, params, 2)
    assert m1.flushes >= 1 and m2.flushes >= 1
    for a, b in zip(solo, duo):
        assert len(a.out_tokens) == a.max_new_tokens
        assert a.out_tokens == b.out_tokens
    assert len(set(solo[0].out_tokens)) > 1
    assert m2.tokens_out == sum(r.max_new_tokens for r in duo)


def test_serve_launcher_runs_on_cpu(capsys):
    """The launcher end to end; the second request outlives the per-request
    watchdog and finishes as a timeout."""
    from repro_torch.launch import serve
    serve.main(["--arch", "gemma2_2b", "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-lens", "80,60", "--new-tokens",
                "3", "--stagger", "10", "--prefill-chunk", "32",
                "--max-decode-steps", "6"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    assert "req 0: prompt 80, out 3," in out
    assert "req 1: prompt 60, out 5," in out and "[timeout]" in out


def test_engine_attn_impl_follows_config(models):
    """With no ``attn_impl`` the engine takes ``cfg.retro.attn_impl`` (the
    reference's default "jnp"), and decodes through that impl: only
    "pallas" reaches the gathered-buffer merge."""
    from unittest import mock

    from repro_torch.kernels.wave_attention import ops as wa_ops
    _, _, cfg, params = models
    assert cfg.retro.attn_impl == "jnp"
    assert ServeEngine(cfg, params, device="cpu").attn_impl == "jnp"
    pallas_cfg = cfg.replace(retro=dataclasses.replace(cfg.retro,
                                                       attn_impl="pallas"))
    for c, impl, want in ((cfg, None, 0), (pallas_cfg, None, 1),
                          (pallas_cfg, "jnp", 0), (cfg, "pallas", 1)):
        eng = ServeEngine(c, params, device="cpu", attn_impl=impl,
                          prefill_chunk=CHUNK)
        assert eng.attn_impl == (impl or c.retro.attn_impl)
        req = Request(np.arange(40, dtype=np.int32), 3)
        with mock.patch.object(wa_ops, "wave_attention_merge",
                               wraps=wa_ops.wave_attention_merge) as spy:
            m = eng.serve([req], batch_size=1)
        assert m.steps > 0
        assert spy.call_count == want * cfg.n_layers * m.steps, (impl, c)
    with pytest.raises(ValueError, match="unknown attn impl"):
        ServeEngine(cfg, params, device="cpu", attn_impl="flash")


def test_serve_launcher_attn_impl(capsys):
    """``--attn-impl`` reaches the engine and the report names it."""
    from repro_torch.launch import serve
    for flag, want in ((["--attn-impl", "jnp"], "jnp attention"),
                       (["--attn-impl", "fused"], "fused attention"),
                       ([], "jnp attention")):
        serve.main(["--arch", "gemma2_2b", "--reduced", "--device", "cpu",
                    "--requests", "1", "--prompt-lens", "40",
                    "--new-tokens", "2", "--prefill-chunk", "32", *flag])
        out = capsys.readouterr().out
        assert want in out and "req 0: prompt 40, out 2," in out, flag


def test_default_device_needs_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)


BLOCK_JAX = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "repro" \\
                or name.startswith("repro."):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k in sys.modules)
print(" ".join(mods))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", BLOCK_JAX], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 29
    assert {f"repro_torch.kernels.{k}.{m}" for k in ("gather", "kmeans",
                                                     "wave_attention")
            for m in ("ops", "ref")} <= mods
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b|\brepro\.",
                     re.MULTILINE)
    for f in (SRC / "repro_torch").rglob("*.py"):
        text = f.read_text()
        # the docstrings name their reference modules as paths, never as
        # importable dotted names
        assert not pat.search(text), f


# ---------------------------------------------------------------------------
# Both runtimes x both admission modes, against the reference's serve
# ---------------------------------------------------------------------------

SERVE_LENS, SERVE_NEWS, SERVE_CTX = (200, 130, 160), (40, 6, 12), 256
# name -> (runtime, admission, engine knobs)
SERVE_CASES = {
    "retro_chunked": ("retro", "chunked", {}),
    "retro_blocking": ("retro", "blocking", {}),
    "full_chunked": ("full", "chunked", {}),
    "full_blocking": ("full", "blocking", {}),
    "retro_blocking_bucket64": ("retro", "blocking", dict(prefill_bucket=64)),
    "retro_blocking_offload": ("retro", "blocking",
                               dict(offload=True, cache_frac=0.25)),
}


def _short_flush(cfg):
    """A 32-token update segment: request 0's 40 new tokens cross a flush."""
    return cfg.replace(tie_embeddings=False, retro=dataclasses.replace(
        cfg.retro, update_segment=32, local=16))


def _serve_summary(reqs, m):
    return dict(tokens=[r.out_tokens for r in reqs], steps=m.steps,
                cache=dataclasses.asdict(m.cache),
                degraded=m.degraded_steps)


@pytest.fixture(scope="module")
def serve_models():
    ref_cfg = _short_flush(ref_gemma.reduced())
    cfg = _short_flush(gemma2_2b.reduced())
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(4))
    return ref_cfg, ref_params, cfg, params_from_numpy(
        _np_tree(ref_params), cfg, "cpu")


def _serve_prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in SERVE_LENS]


@pytest.fixture(scope="module")
def ref_serves(serve_models):
    """Every case served once by the reference's engine."""
    from repro.serving import engine as RE
    ref_cfg, ref_params, _, _ = serve_models
    out = {}
    for name, (runtime, admission, kw) in SERVE_CASES.items():
        eng = RE.ServeEngine(ref_cfg, ref_params, runtime=runtime,
                             admission=admission, gen_headroom=64,
                             max_context=SERVE_CTX, prefill_chunk=48, **kw)
        reqs = [RE.Request(prompt=p, max_new_tokens=n) for p, n in
                zip(_serve_prompts(ref_cfg.vocab), SERVE_NEWS)]
        out[name] = _serve_summary(reqs, eng.serve(reqs, batch_size=2))
    return out


def _port_serve(cfg, params, runtime, admission, **kw):
    eng = ServeEngine(cfg, params, runtime=runtime, admission=admission,
                      gen_headroom=64, max_context=SERVE_CTX,
                      prefill_chunk=48, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, n in zip(_serve_prompts(cfg.vocab), SERVE_NEWS)]
    m = eng.serve(reqs, batch_size=2)
    return _serve_summary(reqs, m), m, eng


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_runtime_admission_matches_reference(serve_models, ref_serves,
                                                   case):
    """A ragged queue of 3 requests on 2 slots, one request crossing a
    flush: the same tokens as the reference's serve (blocking + offload:
    every wave-buffer counter too), and, unpadded, the same tokens as
    chunked admission (a bucket-padded prefill segments its clustered
    region by the padded length, so its clusters differ)."""
    _, _, cfg, params = serve_models
    runtime, admission, kw = SERVE_CASES[case]
    got, m, eng = _port_serve(cfg, params, runtime, admission, **kw)
    assert got == ref_serves[case]
    assert (eng.runtime, eng.admission) == (runtime, admission)
    assert m.tokens_out == sum(SERVE_NEWS)
    assert m.prefill_tokens == sum(SERVE_LENS)
    assert (m.flushes >= 1) == (runtime == "retro")
    assert len(set(got["tokens"][0])) > 1
    if kw.get("offload"):
        assert m.cache.lookups > 0 and m.cache.bytes_over_link > 0
    if "prefill_bucket" not in kw:
        chunked, _, _ = _port_serve(cfg, params, runtime, "chunked")
        assert got["tokens"] == chunked["tokens"]
    kinds = {type(st).__name__ for st in eng.last_state.kv}
    assert kinds == {"WaveState" if runtime == "retro" else "DenseCache"}


def test_blocking_bucket_pads_prompts(serve_models):
    """``prefill_bucket`` pads each blocking prefill up to its multiple
    (prompts shorter than sink + local stay exact), and the geometry
    follows the largest padded prompt."""
    _, _, cfg, params = serve_models
    eng = ServeEngine(cfg, params, admission="blocking", prefill_bucket=64,
                      device="cpu")
    assert [eng._bucket(n) for n in (200, 130, 128, 19, 20)] == \
        [256, 192, 128, 19, 64]
    assert ServeEngine(cfg, params, device="cpu")._bucket(130) == 130
    seen = []
    real = M.apply_prefill

    def spy(params, cfg, batch, **kw):
        seen.append((batch["tokens"].shape[1], int(kw["lengths"][0])))
        return real(params, cfg, batch, **kw)

    from unittest import mock
    with mock.patch.object(M, "apply_prefill", spy):
        reqs = [Request(p, 2) for p in _serve_prompts(cfg.vocab)]
        eng.serve(reqs, batch_size=2)
    assert seen == [(256, 200), (192, 130), (192, 160)]
    assert eng.last_state.kv[0].k_store.shape[2] == \
        plan_zones(256, cfg.retro, 1024).m_max


def test_engine_rejects_bad_runtime_options(serve_models):
    _, _, cfg, params = serve_models
    with pytest.raises(ValueError, match="offload"):
        ServeEngine(cfg, params, runtime="full", offload=True, device="cpu")
    with pytest.raises(ValueError, match="admission"):
        ServeEngine(cfg, params, admission="eager", device="cpu")
    eng = ServeEngine(cfg, params, runtime="full", max_context=SERVE_CTX,
                      device="cpu")
    with pytest.raises(ValueError, match="outside"):      # min_len 1: ok
        eng.serve([Request(np.arange(SERVE_CTX + 1, dtype=np.int32), 1)], 1)
    m = eng.serve([Request(np.arange(3, dtype=np.int32), 2)], 1)
    assert m.tokens_out == 2
    with pytest.raises(ValueError, match="outside"):      # retro: sink + 1
        ServeEngine(cfg, params, device="cpu").serve(
            [Request(np.arange(3, dtype=np.int32), 2)], 1)


def test_run_wave_serves_one_slot_each(serve_models):
    _, _, cfg, params = serve_models
    eng = ServeEngine(cfg, params, admission="blocking", device="cpu")
    reqs = [Request(p, 3) for p in _serve_prompts(cfg.vocab)]
    m = eng.run_wave(reqs)
    assert m.n_slots == 3 and m.tokens_out == 9
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)


@pytest.mark.parametrize("offload", [False, True], ids=["direct", "offload"])
def test_serve_call_freed_with_the_engine_hooks(serve_models, offload):
    """Once the engine's hooks on a call (``last_state``, ``last_graph``,
    ``last_plane``) are dropped, as a benchmark does between calls, nothing
    holds the call's serve state or, under offload, its host stores: no
    store outlives its call to add a whole serve state to the next call's
    peak memory."""
    import gc
    import weakref
    _, _, cfg, params = serve_models
    eng = ServeEngine(cfg, params, admission="blocking", gen_headroom=64,
                      max_context=SERVE_CTX, offload=offload, device="cpu")
    eng.serve([Request(p, 3) for p in _serve_prompts(cfg.vocab)], 2)
    refs = [weakref.ref(eng.last_state.kv[0].k_store)]
    if offload:
        refs.append(weakref.ref(eng.last_plane.layers[0]))
    eng.last_state = eng.last_graph = eng.last_plane = None
    gc.collect()
    assert all(r() is None for r in refs)


def test_serve_launcher_runtime_and_admission(capsys):
    """``--runtime``, ``--admission`` and ``--prefill-bucket`` reach the
    engine and the report names the runtime and admission it ran."""
    from repro_torch.launch import serve
    for flags, want in (([], "(retro, chunked admission"),
                        (["--runtime", "full", "--admission", "blocking"],
                         "(full, blocking admission"),
                        (["--admission", "blocking", "--prefill-bucket",
                          "32"], "(retro, blocking admission")):
        serve.main(["--arch", "gemma2_2b", "--reduced", "--device", "cpu",
                    "--requests", "2", "--prompt-lens", "40,50",
                    "--new-tokens", "2", *flags])
        out = capsys.readouterr().out
        assert want in out and "req 1: prompt 50, out 2," in out, flags


# ---------------------------------------------------------------------------
# The other dense configs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_models():
    from repro.configs import registry as ref_registry
    from repro_torch.configs import registry
    out = {}
    for arch in ("gemma3_1b", "minitron_8b"):
        ref_cfg = ref_registry.reduced_config(arch)
        cfg = registry.reduced_config(arch)
        ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(5))
        out[arch] = (ref_cfg, ref_params, cfg,
                     params_from_numpy(_np_tree(ref_params), cfg, "cpu"))
    return out


@pytest.mark.parametrize("attn_impl", ["fused", "jnp", "pallas"])
@pytest.mark.parametrize("arch", ["gemma3_1b", "minitron_8b"])
def test_dense_config_decode_matches_reference(dense_models, arch,
                                               attn_impl):
    """Reduced gemma3-1b (one KV head, G 4, a 5:1 local:global pattern
    reduced to l/g) and minitron-8b (no softcap or window, untied head):
    the reference's blocking prefill carried across, then six decode steps
    under each impl, logits within 1e-4."""
    ref_cfg, ref_params, cfg, params = dense_models[arch]
    assert params["window"] == PT.layer_windows(cfg)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    S = 200
    toks = np.random.default_rng(6).integers(0, 512, (1, S)).astype(np.int32)
    ref_plan = ref_plan_zones(S, ref_cfg.retro, 64)
    _, ref_state = RM.apply_prefill(ref_params, ref_cfg,
                                    {"tokens": jnp.asarray(toks)},
                                    plan=ref_plan, gen_headroom=64)
    state = serve_state_from_numpy(_np_tree(ref_state.kv._asdict()), "cpu")
    dec = jax.jit(functools.partial(RT.decode_step, cfg=ref_cfg,
                                    plan=ref_plan, attn_impl=attn_impl))
    plan = plan_zones(S, cfg.retro, 64)
    rng = np.random.default_rng(7)
    for t in range(6):
        tok = rng.integers(0, 512, (1,)).astype(np.int32)
        ref_lg, ref_state = dec(ref_params, state=ref_state,
                                token=jnp.asarray(tok))
        lg, state = PT.decode_step(params, cfg, state, torch.from_numpy(tok),
                                   plan=plan, attn_impl=attn_impl)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL,
                                   err_msg=f"step {t}")
