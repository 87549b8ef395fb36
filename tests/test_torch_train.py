"""The training path against the JAX package, both on the CPU from the same
numpy parameters and batches: ``lm_loss``, every parameter's grad and one
``make_train_step`` step (AdamW) for the reduced configs of every family
(gemma2-2b, mixtral-8x22b with its aux loss, llava-next-34b with patch
embeddings, rwkv6-3b, zamba2-1.2b, whisper-tiny with frames), f32; a
recurrent scan long enough to run the chunked remat; the loss curve; the
checkpoint in both directions; one bf16 loss.

Tolerances (f32): the loss within 1e-5 (1 + |ref|); every grad leaf within
1e-4 (1 + max |ref| of that leaf) (a grad sums over every token, and the
port's recurrences and projections run batched where the reference runs
them a token at a time); the parameters and both moments after one AdamW
step within 1e-5 (1 + |ref|) elementwise (see
``test_train_step_matches_reference`` for the parameters whose grad is
near AdamW's eps).
The bf16 loss: within 2 bf16 ulps of the loss (the logits are a bf16
product cast to f32, so they carry bf16 rounding; the reference compiled
with ``xla_allow_excess_precision=False`` rounds where its source does).
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.data.pipeline import lm_batches as ref_lm_batches
from repro.models import layers as RL
from repro.models import model as RM
from repro.training import checkpoint as ref_ckpt
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.optimizer import adamw_update as ref_adamw_update
from repro.training.train_loop import (init_train_state as ref_init_state,
                                       make_train_step as ref_make_step)
from repro_torch.configs.registry import reduced_config
from repro_torch.data.pipeline import lm_batches
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.scan_utils import remat_chunked_scan
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig, tree_leaves
from repro_torch.training.train_loop import (TrainState, batch_to_device,
                                             init_train_state,
                                             loss_and_grads, make_train_step,
                                             train, trainable)

torch.set_num_threads(2)
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5
ARCHS = ("gemma2_2b", "mixtral_8x22b", "llava_next_34b", "rwkv6_3b",
         "zamba2_1p2b", "whisper_tiny")
B, T = 2, 160
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20)


def numpy_tree(tree):
    """A JAX pytree -> numpy (bf16 as f32), keeping NamedTuples."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)
                                             if a.dtype == jnp.bfloat16
                                             else a), tree)


def leaves_by_path(tree, path=""):
    """{"a.b.c": leaf} of a nested dict / NamedTuple tree."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves_by_path(v, f"{path}.{k}" if path else k))
        return out
    return {path: np.asarray(tree)}


def assert_trees(got, want, tol, per_leaf_max=False, what=""):
    got, want = leaves_by_path(got), leaves_by_path(want)
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    for k in want:
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        assert np.isfinite(g).all(), (what, k)
        scale = 1 + np.abs(w).max() if per_leaf_max else 1 + np.abs(w)
        err = (np.abs(g - w) / scale).max() if w.size else 0.0
        assert err <= tol, f"{what} {k}: {err:.3e}"


def ref_batch(cfg, seed=0, seq=T, batch=B):
    return next(ref_lm_batches(cfg, batch, seq, seed=seed))


@functools.lru_cache(maxsize=None)
def ref_model(arch, seed=0):
    cfg = ref_reduced(arch)
    return cfg, RM.init_params(cfg, jax.random.PRNGKey(seed))


def port_params(arch, ref_params):
    return params_from_numpy(numpy_tree(ref_params), reduced_config(arch),
                             "cpu")


@functools.lru_cache(maxsize=None)
def ref_step(arch, seq=T):
    """The reference's loss, grads and one train step from the reference's
    own init, on one batch."""
    cfg, params = ref_model(arch)
    batch = ref_batch(cfg, seq=seq)
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RM.lm_loss(p, cfg, jb)))(params)
    state = ref_init_state(cfg, jax.random.PRNGKey(0))
    new, metrics = jax.jit(ref_make_step(cfg, RefAdamWConfig(**OPT)))(
        state, jb)
    return batch, float(loss), numpy_tree(grads), numpy_tree(state), \
        numpy_tree(new), numpy_tree(metrics)


def port_loss_and_grads(arch, batch):
    """The port's loss and grads (reference layout) from the reference's
    initial parameters."""
    _, ref_params = ref_model(arch)
    loss, grads = loss_and_grads(reduced_config(arch),
                                 trainable(port_params(arch, ref_params)),
                                 batch_to_device(batch, "cpu"))
    return float(loss), params_to_numpy(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    cfg = reduced_config(arch)
    _, ref_params = ref_model(arch)
    batch, ref_loss, *_ = ref_step(arch)
    with torch.no_grad():
        loss = M.lm_loss(port_params(arch, ref_params), cfg,
                         batch_to_device(batch, "cpu"))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - ref_loss) <= LOSS_TOL * (1 + abs(ref_loss)), \
        (float(loss), ref_loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    batch, ref_loss, ref_grads, *_ = ref_step(arch)
    loss, grads = port_loss_and_grads(arch, batch)
    assert abs(loss - ref_loss) <= LOSS_TOL * (1 + abs(ref_loss))
    assert_trees(grads, ref_grads, GRAD_TOL, per_leaf_max=True,
                 what=f"{arch} grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step from the reference's initial state
    (carried over by ``train_state_from_numpy``): both moments, the step
    and the metrics against the reference's step; the parameters against
    the reference's ``adamw_update`` of the port's own grads (which
    ``test_grads_match_reference`` holds to the reference's), and against
    the reference's step wherever its grad is 0 or at least 100 eps. (The first
    step moves a parameter by ~lr · g / (|g| + eps): at |g| near eps the
    grads' last-place rounding moves it by up to ~lr / 30.)"""
    cfg = reduced_config(arch)
    batch, _, _, ref_state, ref_new, ref_metrics = ref_step(arch)
    state = train_state_from_numpy(ref_state, cfg, "cpu")
    new, metrics = make_train_step(cfg, AdamWConfig(**OPT))(
        state, batch_to_device(batch, "cpu"))
    got = train_state_to_numpy(new)
    assert int(got.opt.step) == int(ref_new.opt.step) == 1
    assert_trees(got.opt.mu, ref_new.opt.mu, STEP_TOL, what="mu")
    assert_trees(got.opt.nu, ref_new.opt.nu, STEP_TOL, what="nu")
    _, grads = port_loss_and_grads(arch, batch)
    want, _, _ = ref_adamw_update(
        RefAdamWConfig(**OPT), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, ref_state.opt),
        jax.tree.map(jnp.asarray, ref_state.params))
    assert_trees(got.params, numpy_tree(want), STEP_TOL,
                 what="params vs the reference's AdamW of the port's grads")
    eps = RefAdamWConfig().eps
    conditioned = {k: (np.abs(g) >= 100 * eps) | (g == 0)
                   for k, g in leaves_by_path(ref_step(arch)[2]).items()}
    have, ref = leaves_by_path(got.params), leaves_by_path(ref_new.params)
    for k, ok in conditioned.items():
        err = np.abs(have[k] - ref[k]) / (1 + np.abs(ref[k]))
        assert err[ok].max(initial=0.0) <= STEP_TOL, (k, err[ok].max())
        assert ok.mean() > 0.5, (k, ok.mean())
    for k in ("loss", "lr", "grad_norm"):
        assert metrics[k].dim() == 0
        assert abs(float(metrics[k]) - float(ref_metrics[k])) \
            <= LOSS_TOL * (1 + abs(float(ref_metrics[k]))), k


def test_loss_mask_matches_reference():
    """``loss_mask`` weights the NLL and floors its sum at 1."""
    arch = "gemma2_2b"
    cfg, ref_params = ref_model(arch)
    batch = dict(ref_batch(cfg, seed=5))
    batch["loss_mask"] = (np.random.default_rng(0).random((B, T)) < 0.3) \
        .astype(np.float32)
    ref = float(RM.lm_loss(ref_params, cfg, jax.tree.map(jnp.asarray,
                                                         batch)))
    with torch.no_grad():
        got = float(M.lm_loss(port_params(arch, ref_params),
                              reduced_config(arch),
                              batch_to_device(batch, "cpu")))
    assert abs(got - ref) <= LOSS_TOL * (1 + abs(ref)), (got, ref)


@pytest.mark.parametrize("arch", ("rwkv6_3b", "zamba2_1p2b"))
def test_recurrent_grads_through_chunked_remat(arch):
    """T 512 (two 256-step chunks): the reference checkpoints each chunk of
    its scan, and so does the port; loss and grads as above."""
    cfg, _ = ref_model(arch)
    batch = ref_batch(cfg, seed=3, seq=512, batch=1)
    _, ref_params = ref_model(arch)
    jb = jax.tree.map(jnp.asarray, batch)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: RM.lm_loss(p, cfg, jb)))(ref_params)
    loss, grads = port_loss_and_grads(arch, batch)
    assert abs(loss - float(ref_loss)) <= LOSS_TOL * (1 + abs(float(ref_loss)))
    assert_trees(grads, numpy_tree(ref_grads), GRAD_TOL, per_leaf_max=True,
                 what=f"{arch} T 512 grads")


def test_remat_scan_grads_equal_plain_loop():
    """The chunk-checkpointed scan gives the plain loop's grads bit for
    bit (the backward pass recomputes the same ops)."""
    xs = torch.randn(512, 3, 4, generator=torch.Generator().manual_seed(0))

    def body(c, x):
        c = torch.addcmul(c * 0.9, x[0], x[0])
        return c, c.sum(-1)

    def run(chunk):
        x = xs.clone().requires_grad_(True)
        c, ys = remat_chunked_scan(body, torch.zeros(3, 4), (x,),
                                   chunk=chunk)
        g, = torch.autograd.grad((c.sum() + (ys ** 2).sum()), x)
        return c.detach(), ys.detach(), g

    plain, remat = run(1024), run(256)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def test_flash_attention_grads_match_reference():
    """Several key blocks, a sliding window and rows with no valid key in
    a block: finite grads equal to the reference's."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 96, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    w = rng.standard_normal((2, 96, 4, 16)).astype(np.float32)

    def ref_fn(q, k, v):
        o = RL.flash_attention_jnp(q, k, v, causal=True,
                                   window=jnp.float32(40.0), softcap=20.0,
                                   block=32)
        return jnp.sum(o * w)

    ref = jax.grad(ref_fn, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = L.flash_attention_jnp(tq, tk, tv, causal=True,
                              window=torch.tensor(40.0), softcap=20.0,
                              block=32)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        r = np.asarray(r)
        err = np.abs(g.numpy() - r).max() / (1 + np.abs(r).max())
        assert err <= GRAD_TOL, err


def test_loss_decreases():
    """Mirror of the reference's ``test_loss_decreases``: the tiny dense
    config, 60 steps."""
    from repro_torch.configs.base import AttnConfig, ModelConfig
    from repro_torch.configs.registry import SMOKE_RETRO
    tiny = ModelConfig(
        arch_id="tiny", family="dense", n_layers=2, d_model=64, d_ff=128,
        vocab=256, attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        dtype="float32", retro=SMOKE_RETRO)
    data = lm_batches(tiny, batch=8, seq=64, seed=0)
    _, hist = train(tiny, AdamWConfig(lr=3e-3, warmup_steps=5,
                                      total_steps=60), data, steps=60,
                    generator=torch.Generator().manual_seed(0), log_every=5,
                    device="cpu")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first - 0.5, (first, last)


def _small_state(arch="gemma2_2b"):
    return init_train_state(reduced_config(arch),
                            torch.Generator().manual_seed(0), "cpu")


def test_checkpoint_roundtrip():
    state = _small_state("zamba2_1p2b")
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, state, step=7)
        restored, step = ckpt.restore(d, state)
    assert step == 7
    a, b = tree_leaves(state), tree_leaves(restored)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
        assert x.requires_grad == y.requires_grad


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, {"w": torch.ones(2, 2)})
        with pytest.raises(AssertionError):
            ckpt.restore(d, {"w": torch.ones(3, 3)})
        with pytest.raises(AssertionError):
            ckpt.restore(d, {"w": torch.ones(2, 2), "x": torch.ones(1)})


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_reference_checkpoint_restores_in_port(dtype):
    """A ``TrainState`` the reference saved restores into the port's, leaf
    for leaf and bit for bit."""
    arch = "mixtral_8x22b"
    cfg = ref_reduced(arch).replace(dtype=dtype)
    ref_state = ref_init_state(cfg, jax.random.PRNGKey(4))
    like = init_train_state(reduced_config(arch).replace(dtype=dtype),
                            torch.Generator().manual_seed(1), "cpu")
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(d, ref_state, step=3)
        got, step = ckpt.restore(d, like)
    assert step == 3
    want = leaves_by_path(numpy_tree(ref_state))
    have = leaves_by_path(train_state_to_numpy(got))
    assert set(want) == set(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert got.params["layers"][0]["attn"]["wq"].dtype == getattr(torch,
                                                                  dtype)


def test_port_checkpoint_restores_in_reference():
    arch = "whisper_tiny"
    state = _small_state(arch)
    ref_like = ref_init_state(ref_reduced(arch), jax.random.PRNGKey(9))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, state, step=5)
        got, step = ref_ckpt.restore(d, ref_like)
    assert step == 5
    want = leaves_by_path(train_state_to_numpy(state))
    have = leaves_by_path(numpy_tree(got))
    assert set(want) == set(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    _, ref_params = ref_model(arch)
    want = leaves_by_path(numpy_tree(ref_params))
    have = leaves_by_path(params_to_numpy(port_params(arch, ref_params)))
    assert set(want) == set(have)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_bf16_loss_matches_reference():
    """Reduced gemma2-2b in bf16 against the reference compiled with
    ``xla_allow_excess_precision=False``."""
    arch = "gemma2_2b"
    cfg = ref_reduced(arch).replace(dtype="bfloat16")
    params = RM.init_params(cfg, jax.random.PRNGKey(2))
    batch = ref_batch(cfg, seed=6)
    jb = jax.tree.map(jnp.asarray, batch)
    fn = jax.jit(lambda p, b: RM.lm_loss(p, cfg, b)).lower(params, jb) \
        .compile(compiler_options={"xla_allow_excess_precision": False})
    ref = float(fn(params, jb))
    pcfg = reduced_config(arch).replace(dtype="bfloat16")
    with torch.no_grad():
        got = float(M.lm_loss(params_from_numpy(
            jax.tree.map(np.asarray, params), pcfg, "cpu"), pcfg,
            batch_to_device(batch, "cpu")))
    ulp = 2.0 ** (np.floor(np.log2(abs(ref))) - 7)
    assert abs(got - ref) <= 2 * ulp, (got, ref, ulp)


def test_train_launcher_cpu(capsys, tmp_path):
    train_launcher.main(["--arch", "rwkv6_3b", "--reduced", "--device",
                         "cpu", "--steps", "3", "--batch", "2", "--seq",
                         "32", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith('{"step": 0') and "final loss" in out[-1]
    assert (tmp_path / "ck" / "arrays.npz").exists()


def test_train_state_is_updated_in_place():
    """The step writes the parameters and moments where they are (the
    memory of one copy each) and returns device scalars."""
    cfg = reduced_config("llava_next_34b")
    state = _small_state("llava_next_34b")
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    before = [t.detach().clone() for t in tree_leaves(state.params)]
    batch = batch_to_device(next(lm_batches(cfg, 2, 96, seed=1)), "cpu")
    new, metrics = make_train_step(cfg, AdamWConfig(**OPT))(state, batch)
    assert [t.data_ptr() for t in tree_leaves(new)] == ptrs
    assert isinstance(new, TrainState)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(new.params)))
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
