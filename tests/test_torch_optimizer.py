"""The port's AdamW (``training/optimizer.py``) against the JAX package's
on the CPU: the schedule and the clip (mirrors of the reference's
``test_cosine_schedule`` and ``test_grad_clip_bounds_update``), and
``adamw_update`` on one tree of f32 and bf16 leaves over several steps.

Tolerance: the update within 1e-6 (1 + |ref|) elementwise, the moments and
the metrics too (the same f32 ops; ``add_`` with ``alpha`` may round the
product differently in the last place); bf16 parameters within one bf16
ulp of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as RO
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            clip_by_global_norm, cosine_lr,
                                            global_norm, init_adamw,
                                            tree_leaves, tree_map)

TOL = 1e-6


def test_cosine_schedule():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(cosine_lr(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(cosine_lr(cfg, torch.tensor(10))) == pytest.approx(
        1.0, abs=0.01)
    assert float(cosine_lr(cfg, torch.tensor(100))) == pytest.approx(
        0.1, abs=0.01)


@pytest.mark.parametrize("step", (0, 1, 7, 50, 99, 100, 150))
def test_cosine_schedule_matches_reference(step):
    cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    want = float(RO.cosine_lr(RO.AdamWConfig(*cfg), jnp.asarray(step)))
    assert float(cosine_lr(cfg, torch.tensor(step))) == pytest.approx(
        want, rel=TOL, abs=1e-12)


def test_grad_clip_bounds_update():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    st = init_adamw(params)
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0, total_steps=1,
                      weight_decay=0.0)
    _, _, m = adamw_update(cfg, grads, st, params)
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    assert float(global_norm({"w": grads["w"] / 400.0})) <= 1.0 + 1e-5
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(400.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


def _tree(rng, dtype):
    shapes = {"a": (8, 16), "b": {"c": (5,), "d": (3, 4, 2)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    params = make(shapes)
    grads = [make(shapes) for _ in range(4)]
    return params, grads


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dtype)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("clip", (1.0, 100.0))
def test_adamw_update_matches_reference(dtype, clip):
    """Four steps of ``adamw_update`` on one tree (the grads clipped at
    ``clip``: 1.0 clips every step, 100.0 none), in place, against the
    reference's functional update."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, dtype)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                      clip_norm=clip)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    p, rp = _torch(params, tdt), _jax(params, jdt)
    st, rst = init_adamw(p), RO.init_adamw(rp)
    for g in grads:
        p, st, m = adamw_update(cfg, _torch(g, tdt), st, p)
        rp, rst, rm = RO.adamw_update(RO.AdamWConfig(*cfg), _jax(g, jdt),
                                      rst, rp)
    assert int(st.step) == int(rst.step) == len(grads)
    for k in ("lr", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=TOL)
    for got, want in ((st.mu, rst.mu), (st.nu, rst.nu)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            assert (np.abs(a.numpy() - b) / (1 + np.abs(b))).max() <= TOL
    for a, b in zip(tree_leaves(p), jax.tree.leaves(rp)):
        assert a.dtype == tdt
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            assert (np.abs(a - b) / (1 + np.abs(b))).max() <= TOL
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30)))
                          - 7)
            assert (np.abs(a - b) <= ulp).all()


def test_adamw_update_in_place():
    """The step writes its arguments (one copy of the parameters and the
    moments) and leaves the grads as they were."""
    params = {"w": torch.randn(3, 3), "v": [torch.randn(2), torch.randn(2)]}
    grads = tree_map(torch.randn_like, params)
    g0 = tree_map(torch.clone, grads)
    st = init_adamw(params)
    ptrs = [t.data_ptr() for t in tree_leaves((params, st))]
    before = tree_map(torch.clone, params)
    p, st2, _ = adamw_update(AdamWConfig(warmup_steps=0), grads, st, params)
    assert p is params and st2 is st
    assert [t.data_ptr() for t in tree_leaves((p, st2))] == ptrs
    assert all(not torch.equal(a, b) for a, b in
               zip(tree_leaves(before), tree_leaves(p)))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g0), tree_leaves(grads)))
    assert all(m.dtype == torch.float32 for m in tree_leaves(st.mu))
