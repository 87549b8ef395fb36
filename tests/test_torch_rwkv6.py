"""The rwkv6 (ssm) family against the JAX package on reduced rwkv6-3b, f32,
both on the CPU from the same numpy parameters: the time loop
(``scan_utils.remat_chunked_scan``) against the reference's scan, the
prefill's logits and every layer's final ``RwkvLayerState``, then six
decode steps of logits and states from the port's own prefill state.

Tolerance: f32 logits and the token-shift states within 1e-5 (1 + |ref|):
the projections run batched over the prompt where the reference runs them
a token at a time, and products sum in other orders than XLA's. The
(hd x hd) ``wkv`` state sums a hundred outer products of entries up to ~40
in size, and that rounding noise is absolute: it is held within
1e-6 (1 + max |ref|) of its layer (about 8 f32 ulps of its largest entry;
1e-5 (1 + |ref|) elementwise fails by 5% on entries near 1 after six
decode steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_3b as ref_rwkv
from repro.models import model as RM
from repro.models import rwkv6 as RR
from repro.models import scan_utils as RS
from repro_torch.configs import rwkv6_3b
from repro_torch.interop import params_from_numpy, serve_state_from_numpy
from repro_torch.models import model as M
from repro_torch.models import rwkv6
from repro_torch.models.scan_utils import remat_chunked_scan

torch.set_num_threads(2)
RTOL, STATE_TOL = 1e-5, 1e-6
T = 96


def assert_close(got, want, what, per_layer=False):
    """|got - want| <= 1e-5 (1 + |want|); ``per_layer``: <= 1e-6 (1 + the
    largest |want| of each leading-axis entry)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if per_layer:
        scale = 1 + np.abs(want).reshape(len(want), -1).max(-1)
        err = (np.abs(got - want).reshape(len(want), -1).max(-1)
               / scale).max()
        assert err <= STATE_TOL, f"{what}: {err:.3e}"
        return
    err = (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err <= RTOL, f"{what}: {err:.3e}"


def assert_state(state, ref_state):
    """Per-layer ``RwkvLayerState``s against the reference's stacked one."""
    for f in RR.RwkvLayerState._fields:
        assert_close(np.stack([getattr(st, f).numpy() for st in state]),
                     getattr(ref_state, f), f, per_layer=f == "wkv")


@pytest.fixture(scope="module")
def models():
    ref_cfg, cfg = ref_rwkv.reduced(), rwkv6_3b.reduced()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(3))
    return ref_cfg, ref_params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")


def test_time_loop_matches_lax_scan():
    """A carry updated in place and a per-step output, against the
    reference's ``remat_chunked_scan`` (a chunked ``lax.scan``) on a
    length it chunks."""
    xs = np.random.default_rng(0).standard_normal((512, 3, 4)) \
        .astype(np.float32)

    def ref_body(c, x):
        c = 0.9 * c + x
        return c, c.sum(-1)

    def body(c, x):
        c.mul_(0.9).add_(x[0])
        return c, c.sum(-1)

    ref_c, ref_ys = RS.remat_chunked_scan(ref_body, jnp.zeros((3, 4)),
                                          jnp.asarray(xs))
    c, ys = remat_chunked_scan(body, torch.zeros((3, 4)),
                               (torch.from_numpy(xs),))
    assert_close(c.numpy(), ref_c, "carry")
    assert_close(ys.numpy(), ref_ys, "outputs")


def test_prefill_matches_reference(models):
    ref_cfg, ref_params, cfg, params = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, T)) \
        .astype(np.int32)
    ref_lg, ref_state = jax.jit(lambda p, t: RR.prefill(p, ref_cfg, t))(
        ref_params, jnp.asarray(toks))
    lg, state = M.apply_prefill(params, cfg,
                                {"tokens": torch.from_numpy(toks)})
    assert lg.dtype == torch.float32 and lg.shape == (2, cfg.vocab)
    assert_close(lg.numpy(), ref_lg, "prefill logits")
    assert len(state) == cfg.n_layers
    assert_state(state, ref_state)


def test_decode_matches_reference(models):
    """Six decode steps from one prefill state: the reference from its own
    state, the port from its own; the port's state is updated in place."""
    ref_cfg, ref_params, cfg, params = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, T)).astype(np.int32)
    _, ref_state = RR.prefill(ref_params, ref_cfg, jnp.asarray(toks))
    _, state = M.apply_prefill(params, cfg,
                               {"tokens": torch.from_numpy(toks)})
    dec = jax.jit(lambda p, s, t: RM.apply_decode(p, ref_cfg, s, t))
    ptrs = [t.data_ptr() for st in state for t in st]
    for step in range(6):
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        ref_lg, ref_state = dec(ref_params, ref_state, jnp.asarray(tok))
        lg, state = M.apply_decode(params, cfg, state, torch.from_numpy(tok),
                                   plan=None)
        assert_close(lg.numpy(), ref_lg, f"step {step} logits")
        assert_state(state, ref_state)
    assert [t.data_ptr() for st in state for t in st] == ptrs


def test_decode_from_the_reference_state(models):
    """The reference's prefill state carried over as numpy
    (``serve_state_from_numpy``) decodes as the reference does."""
    ref_cfg, ref_params, cfg, params = models
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 40)) \
        .astype(np.int32)
    _, ref_state = RR.prefill(ref_params, ref_cfg, jnp.asarray(toks))
    state = serve_state_from_numpy(ref_state._asdict(), "cpu")
    tok = np.array([7, 9], np.int32)
    ref_lg, ref_state = RR.decode_step(ref_params, ref_cfg, ref_state,
                                       jnp.asarray(tok))
    lg, state = rwkv6.decode_step(params, cfg, state, torch.from_numpy(tok))
    assert_close(lg.numpy(), ref_lg, "logits")
    assert_state(state, ref_state)


def test_serve_state_is_zero_and_refuses_ragged_prefill(models):
    _, _, cfg, params = models
    state = M.make_serve_state(cfg, 3, 64, zero_fill=True, device="cpu")
    assert len(state) == cfg.n_layers
    assert all(not t.any() for st in state for t in st)
    assert state[0].wkv.shape == (3, 4, 32, 32)
    with pytest.raises(ValueError, match="ragged"):
        M.apply_prefill(params, cfg, {"tokens": torch.zeros((1, 8),
                                                            dtype=torch.long)},
                        lengths=torch.tensor([5]))
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        M.make_prefill_chunk_state(cfg, 1, 64, chunk=16, device="cpu")
