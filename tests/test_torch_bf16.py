"""The bf16 model path against the JAX package: reduced gemma2-2b (gelu
MLP) with ``dtype="bfloat16"``, the port and the reference on the same
numpy parameters on the CPU, for ``prefill``, ``prefill_chunk``,
``decode_step`` under each decode impl and the full runtime's
``decode_step``; reduced minitron-8b (silu MLP) for ``prefill`` and
``decode_step``; and, on a CUDA card (marked ``cuda``), the full runtime's
storage-dtype products against the upcast formulation.

The reference is compiled with ``xla_allow_excess_precision=False``, so it
rounds at every bf16 cast point its source writes, as the port does. Its
default compile may drop any of those roundings where XLA's fusion allows
(e.g. a bf16 product that feeds an elementwise op or a cast to f32, such
as the logits, or the ops inside an activation), which depends on the
backend's fusion choices; the cast points of the source are what both
packages share. The gap between the reference's two compiles is measured
and reported below.

Tolerance: logits within one bf16 ulp of the row's largest logit
(``row_ulps``). Most products are bit-equal; where an f32 sum runs in
another order (prefill's flash and chunk attention, now and then a
matmul), a bf16 rounding of the residual stream moves by one ulp, and that
moves many logits by one ulp of their own size, never more than one of
the largest. The first chunk and gemma2-2b's first decode step from the
carried state are held bit for bit. Run ``-s`` to see the numbers. The reference is
imported in a fixture, so the ``cuda`` case also runs on a machine without
JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import attention as PA
from repro_torch.core.zones import plan_zones
from repro_torch.models import model as M

torch.set_num_threads(2)
S, CHUNK, HEADROOM, LENS = 320, 64, 128, (300, 200)
NO_EXCESS = {"xla_allow_excess_precision": False}


def bf16_ulp(x):
    """The bf16 ulp at magnitude ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def row_ulps(port, want):
    """max |port - want| per row in bf16 ulps of the row's largest |want|;
    the largest over the rows."""
    port, want = np.asarray(port, np.float32), np.asarray(want, np.float32)
    d = np.abs(port - want).max(-1)
    return float((d / bf16_ulp(np.abs(want).max(-1))).max())


def _make_ref(arch):
    """The reference's modules and its bf16 reduced ``arch``, with the
    port's parameters from the same numpy leaves."""
    import importlib

    import jax
    import jax.numpy as jnp

    from repro.models import model as RM
    from repro.models import transformer as RT
    from repro_torch.interop import params_from_numpy
    ref_cfg = importlib.import_module(f"repro.configs.{arch}").reduced() \
        .replace(dtype="bfloat16")
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").reduced() \
        .replace(dtype="bfloat16")
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    assert params["embed"].dtype == torch.bfloat16

    def compile_(fn, *args, options=NO_EXCESS):
        return jax.jit(fn).lower(*args).compile(compiler_options=options)

    toks = np.random.default_rng(0).integers(0, 512, (2, S)).astype(np.int32)
    return dict(jax=jax, jnp=jnp, RM=RM, RT=RT, ref_cfg=ref_cfg, cfg=cfg,
                ref_params=ref_params, params=params, compile=compile_,
                toks=toks, plan=plan_zones(S, cfg.retro, HEADROOM))


@pytest.fixture(scope="module")
def ref():
    """gemma2-2b: the gelu (tanh) MLP."""
    return _make_ref("gemma2_2b")


@pytest.fixture(scope="module")
def ref_silu():
    """minitron-8b: the silu MLP, no softcap or window, untied head."""
    return _make_ref("minitron_8b")


def _report(name, port, want):
    d = np.abs(np.asarray(port, np.float32) - want)
    u = row_ulps(port, want)
    print(f"{name}: max|d| {d.max():.4e} ({u:.2f} ulp of the largest "
          f"logit), {(d > 0).mean():.4f} of logits differ")
    return u


def _ref_prefill(r, runtime="retro", options=NO_EXCESS):
    jnp = r["jnp"]

    def fn(p, t, lens):
        return r["RM"].apply_prefill(p, r["ref_cfg"], {"tokens": t},
                                     runtime=runtime, plan=r["plan"],
                                     gen_headroom=HEADROOM, lengths=lens)
    args = (r["ref_params"], jnp.asarray(r["toks"]), jnp.asarray(LENS))
    return r["compile"](fn, *args, options=options)(*args)


def _ref_chunks(r, options=NO_EXCESS):
    """The reference's chunked admission of both prompts: each chunk's
    logits."""
    jnp, RM, cfg = r["jnp"], r["RM"], r["ref_cfg"]

    def fn(p, t, st, clens):
        return RM.apply_prefill_chunk(p, cfg, {"tokens": t}, st,
                                      chunk_lens=clens)
    st = RM.make_prefill_chunk_state(cfg, 2, S, chunk=CHUNK,
                                     gen_headroom=HEADROOM)
    step, out = None, []
    for c0 in range(0, S, CHUNK):
        args = (r["ref_params"], jnp.asarray(r["toks"][:, c0:c0 + CHUNK]), st,
                jnp.asarray(np.clip(np.asarray(LENS) - c0, 0, CHUNK)
                            .astype(np.int32)))
        step = step or r["compile"](fn, *args, options=options)
        lg, st = step(*args)
        out.append(np.asarray(lg))
    return out


def _port_chunks(r):
    cfg, params = r["cfg"], r["params"]
    cs = M.make_prefill_chunk_state(cfg, 2, S, chunk=CHUNK,
                                    gen_headroom=HEADROOM, device="cpu")
    out = []
    for c0 in range(0, S, CHUNK):
        clens = np.clip(np.asarray(LENS) - c0, 0, CHUNK).astype(np.int32)
        lg, cs = M.apply_prefill_chunk(
            params, cfg,
            {"tokens": torch.from_numpy(r["toks"][:, c0:c0 + CHUNK])}, cs,
            chunk_lens=torch.from_numpy(clens))
        out.append(lg.numpy())
    return out


def test_bf16_prefill_matches_reference(ref):
    """Blocking admission of two ragged prompts: first-token logits within
    one bf16 ulp of the largest logit of the reference's, the same greedy
    tokens, and the first layer's zones as the reference's: V and the
    counters bit for bit (V is a projection of the embedding), K within one
    ulp of each element (after RoPE, whose sin and cos differ from XLA's in
    the last bit now and then). Later layers follow an attention output
    that may round one ulp apart."""
    _check_prefill(ref)


def _check_prefill(r):
    want, want_st = _ref_prefill(r)
    lg, st = M.apply_prefill(r["params"], r["cfg"],
                             {"tokens": torch.from_numpy(r["toks"])},
                             plan=r["plan"], gen_headroom=HEADROOM,
                             lengths=torch.tensor(LENS, dtype=torch.int32))
    assert _report("prefill", lg.numpy(), np.asarray(want)) <= 1
    assert (lg.argmax(-1).numpy() == np.asarray(want).argmax(-1)).all()
    for f in ("sink_k", "sink_v", "local_k", "local_v", "length",
              "local_len"):
        got = getattr(st.kv[0], f).float().numpy()
        exp = np.asarray(getattr(want_st.kv, f)[0]).astype(np.float32)
        if f.endswith("_k"):
            assert (np.abs(got - exp) <= bf16_ulp(exp)).all(), f
        else:
            np.testing.assert_array_equal(got, exp, err_msg=f)


def test_bf16_prefill_chunk_matches_reference(ref):
    """Chunked admission, 64-token chunks: every chunk's logits (rows with
    tokens in that chunk) within one bf16 ulp of the largest logit of the
    reference's, the first chunk's bit for bit."""
    want, got = _ref_chunks(ref), _port_chunks(ref)
    for i, (a, b) in enumerate(zip(got, want)):
        live = np.asarray(LENS) > i * CHUNK
        assert _report(f"chunk {i}", a[live], b[live]) <= 1, i
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("case", ["jnp", "fused", "pallas", "full"])
def test_bf16_decode_matches_reference(ref, case):
    """Six decode steps from the reference's blocking-prefill state carried
    across, with the same tokens and one row inactive on some: the first
    step's logits bit for bit, every step's within one bf16 ulp of the
    largest logit of the reference's (the full runtime reads the whole
    cache, as the reference's step does)."""
    _check_decode(ref, case, exact_steps=1)


def _check_decode(r, case, exact_steps):
    """Six steps within one bf16 ulp of the largest logit; the first
    ``exact_steps`` bit for bit."""
    from repro_torch.interop import serve_state_from_numpy
    jax, jnp, RT = r["jax"], r["jnp"], r["RT"]
    runtime, impl = ("full", "jnp") if case == "full" else ("retro", case)
    _, ref_st = _ref_prefill(r, runtime)
    state = serve_state_from_numpy(jax.tree.map(np.asarray,
                                                ref_st.kv._asdict()), "cpu")

    def fn(p, st, tok, act):
        return RT.decode_step(p, r["ref_cfg"], st, tok, runtime=runtime,
                              plan=r["plan"], active=act, attn_impl=impl)
    rng, step, worst = np.random.default_rng(1), None, 0.0
    for t in range(6):
        tok = rng.integers(0, 512, (2,)).astype(np.int32)
        act = np.array([True, t % 3 != 1])
        args = (r["ref_params"], ref_st, jnp.asarray(tok), jnp.asarray(act))
        step = step or r["compile"](fn, *args)
        want, ref_st = step(*args)
        lg, state = M.apply_decode(r["params"], r["cfg"], state,
                                   torch.from_numpy(tok), runtime=runtime,
                                   plan=r["plan"], active=torch.from_numpy(act),
                                   attn_impl=impl)
        worst = max(worst, _report(f"decode {case} step {t}", lg.numpy(),
                                   np.asarray(want)))
        if t < exact_steps:
            np.testing.assert_array_equal(lg.numpy(), np.asarray(want),
                                          err_msg=f"step {t}")
    assert worst <= 1


@pytest.mark.parametrize("case", ["prefill", "jnp", "fused"])
def test_bf16_silu_model_matches_reference(ref_silu, case):
    """Reduced minitron-8b, whose MLP is silu's: the blocking prefill and
    six decode steps, with the tolerance above. Under "jnp", whose
    attention sums in the reference's order, every step is bit for bit
    (torch's fused silu, which rounds once, moves 72% of the prefill's
    logits, by up to 1.25 ulp of the largest); under "fused" the paged
    kernel's twin sums in its own order, so no step is held bit for bit."""
    if case == "prefill":
        _check_prefill(ref_silu)
    else:
        _check_decode(ref_silu, case,
                      exact_steps=6 if case == "jnp" else 0)


def test_bf16_gaps_beside_the_reference(ref):
    """The reference's own gaps beside the port's, on the first token of
    the 300-token prompt: blocking vs chunked admission (flash attention
    against chunk attention, each rounding its bf16 output at its own
    place), for the reference and for the port; and the reference's
    default compile against its no-excess-precision compile. The port's
    blocking-vs-chunked gap is the reference's within one bf16 ulp of the
    largest logit, every run keeps the greedy token, and the gaps are
    printed."""
    r = ref
    blk = {"ref": np.asarray(_ref_prefill(r)[0])[0],
           "ref_default": np.asarray(_ref_prefill(r, options=None)[0])[0],
           "port": M.apply_prefill(
               r["params"], r["cfg"], {"tokens": torch.from_numpy(r["toks"])},
               plan=r["plan"], gen_headroom=HEADROOM,
               lengths=torch.tensor(LENS, dtype=torch.int32))[0].numpy()[0]}
    last = (LENS[0] - 1) // CHUNK
    chk = {"ref": _ref_chunks(r)[last][0],
           "ref_default": _ref_chunks(r, options=None)[last][0],
           "port": _port_chunks(r)[last][0]}
    gap = {k: np.abs(blk[k] - chk[k]).max() for k in blk}
    print(f"blocking vs chunked first-token max|d|: reference {gap['ref']:.4e}"
          f" (default compile {gap['ref_default']:.4e}), port "
          f"{gap['port']:.4e}; reference default vs no-excess compile: "
          f"blocking {np.abs(blk['ref'] - blk['ref_default']).max():.4e}, "
          f"chunked {np.abs(chk['ref'] - chk['ref_default']).max():.4e}")
    for k in blk:
        assert blk[k].argmax() == chk[k].argmax(), k
    assert abs(gap["port"] - gap["ref"]) <= bf16_ulp(np.abs(blk["ref"]).max())


# ---------------------------------------------------------------------------
# On the card: the full runtime's storage-dtype products
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the storage-dtype product runs on "
                    "the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(), dict(window=300.0, softcap=50.0)])
def test_full_attention_bf16_operands_match_upcast(cuda, case):
    """On the card, ``full_attention_decode`` reads the bf16 cache as it is
    (both products f32 from bf16 operands, no f32 copy) and agrees within
    2e-3 (1 + |ref|) (phase 8's gate) with the upcast formulation, which
    the CPU computes on copies of the same inputs: the products are exact
    in f32 either way, only the order of the f32 sums differs."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, G, Smax, hd = 2, 4, 2, 2048, 256
    k, v = (torch.randn((B, H, Smax, hd), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((B, H * G, hd), generator=g, device=cuda) \
        .to(torch.bfloat16)
    cache = PA.DenseCache(k, v, torch.tensor([1900, 700], dtype=torch.int32,
                                             device=cuda))
    host = PA.DenseCache(*(t.cpu() for t in cache))
    for span in (None, 1901):
        out = PA.full_attention_decode(q, cache, span=span, **case)
        want = PA.full_attention_decode(q.cpu(), host, span=span, **case)
        assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
        excess = ((out.float().cpu() - want.float()).abs()
                  - 2e-3 * (1 + want.float().abs())).max().item()
        assert excess <= 0, (span, excess)
