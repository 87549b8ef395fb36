"""The CUDA kernels against their plain twins, on a CUDA card (marked
``cuda``; skipped without a card: a CUDA kernel has no CPU mode): the paged
and the gathered-buffer wave attention (including many splits, several
tiles per split through the cp.async ring, an all-empty row, the same
bits from two calls, group sizes mixed in one process, G 3, 5, 6 and 7
between the powers of two, and G 1 at hd 64 at the shapes zamba2-1.2b and
whisper-tiny serve), the block gather (chunked blocks,
out-of-range ids, refused views), the k-means step (ragged tiles, exact
ties, bit-equal sums run to run) and the prefill attention (mistral's and
mixtral's admission shapes, ragged and tiny prompts, a prefix offset, a
padded row, p kept in f32, the dispatch of ``flash_attention_jnp``, one
launch a layer from ``apply_prefill``). Imports no JAX, so it also runs on a
machine with the card and without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from repro_torch.kernels.gather import ops as gather_ops
from repro_torch.kernels.kmeans import ops as kmeans_ops
from repro_torch.kernels.kmeans.ref import (kmeans_step_check,
                                            ordered_update_ref)
from repro_torch.kernels.prefill_attention import ops as pa_ops
from repro_torch.kernels.wave_attention import ops
from repro_torch.kernels.wave_attention.ref import (random_decode_inputs,
                                                   random_merge_inputs)
from repro_torch.models import layers as L
from repro_torch.models.transformer import GLOBAL_WINDOW

torch.set_num_threads(2)
SMALL = dict(H=2, hd=32, M=48, cap=16, lbuf=160, r=3, e=10, q_pos=(900, 300),
             local_len=(40, 160))
CASES = {
    "f32_global": dict(SMALL, dtype="float32"),
    "bf16_window": dict(SMALL, window=128.0, live_frac=0.7),
    "hd256_bf16": dict(SMALL, hd=256, cap=32, M=40),
    "G8_hd64": dict(SMALL, G=8, hd=64),
    "G1_dead_slot": dict(SMALL, G=1, r0=True),
    # 1 + 63 + 12 tiles per row: one split per tile, ~80 splits per row
    "many_splits": dict(SMALL, hd=64, lbuf=2000, r=12,
                        local_len=(1500, 2000), q_pos=(2500, 2100)),
    # 128 rows: eight tiles per split, walked through the two-stage ring
    "ring_tps8_bf16": dict(SMALL, B=2, H=64, hd=64, lbuf=1024, e=290,
                           local_len=(700, 1024), q_pos=(1500, 1100)),
    "empty_row": dict(SMALL, empty_row=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_twin(cuda, case, softcap):
    kw = dict(CASES[case])
    empty_row = kw.pop("empty_row", False)
    args = [a.to(cuda) for a in random_decode_inputs(**kw)]
    if empty_row:             # row (0, 0): no position passes, estimation dead
        rowb, est = ops.ARG_NAMES.index("rowb"), ops.ARG_NAMES.index(
            "est_logit")
        args[rowb][0, 0, 0] = args[rowb][0, 0, 1]
        args[est][0, 0] = -1e30
    before = ops.paged_wave_attention.launches
    out = ops.paged_wave_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.paged_wave_attention.launches == before + 1
    ref = ops.paged_wave_attention_plain(*args, softcap=softcap)
    tol = 2e-5 * (1 + ref.abs().max().item())
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(ops.paged_wave_attention(*args, softcap=softcap), out)
    if empty_row:
        assert (out[0, 0] == 0).all()
    if case == "ring_tps8_bf16":
        assert ops.paged_grid(*args)["tiles_per_split"] == ops.MAX_TPS
    if case == "many_splits":
        assert ops.paged_grid(*args)["splits"] >= 70


def test_cpu_tensors_use_the_twin_without_counting():
    args = random_decode_inputs(**CASES["bf16_window"])
    before = ops.paged_wave_attention.launches
    out = ops.paged_wave_attention(*args, softcap=50.0)
    assert ops.paged_wave_attention.launches == before
    torch.testing.assert_close(
        out, ops.paged_wave_attention_plain(*args, softcap=50.0),
        rtol=0, atol=0)


MERGE_SMALL = dict(H=2, hd=32, T=300, E=24)
MERGE_CASES = {
    "f32": dict(MERGE_SMALL, dtype="float32"),
    "bf16": dict(MERGE_SMALL),
    "hd256_G4_T77": dict(MERGE_SMALL, hd=256, G=4, T=77, E=5),
    "G8_hd64_all_dead_est": dict(MERGE_SMALL, G=8, hd=64, dead_frac=1.0),
    "G1_empty_rows": dict(MERGE_SMALL, G=1, keep_min=0.0, seed=3),
    "many_splits": dict(MERGE_SMALL, hd=64, T=3000, E=300),
    "ring_tps8_bf16": dict(MERGE_SMALL, B=2, H=64, hd=64, T=1100, E=300),
    "empty_row": dict(MERGE_SMALL, empty_row=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_cuda_merge_kernel_matches_twin(cuda, case, softcap):
    kw = dict(MERGE_CASES[case])
    empty_row = kw.pop("empty_row", False)
    args = [a.to(cuda) for a in random_merge_inputs(**kw)]
    if empty_row:             # row (0, 0): no valid token, estimation dead
        args[3][0, 0] = False
        args[4][0, 0] = -1e30
    before = ops.wave_attention_merge.launches
    out = ops.wave_attention_merge(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.wave_attention_merge.launches == before + 1
    ref = ops.wave_attention_merge_plain(*args, softcap=softcap)
    tol = 2e-5 * (1 + ref.abs().max().item())
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(ops.wave_attention_merge(*args, softcap=softcap), out)
    if empty_row:
        assert (out[0, 0] == 0).all()
    if case == "ring_tps8_bf16":
        assert ops.merge_grid(*args)["tiles_per_split"] == ops.MAX_TPS
    if case == "many_splits":
        assert ops.merge_grid(*args)["splits"] >= 90


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["paged_wave_attention", "wave_attention_merge"])
def test_cuda_attention_across_group_sizes(cuda, op):
    """G 2 with many splits, G 4 with few, G 2 with many again, in one
    process (as a serving run of one config after another's shapes): the
    combine kernel is shared by every G, so a G-4 call must not lower the
    shared-memory limit that the G-2 call needs."""
    make = random_decode_inputs if op == "paged_wave_attention" \
        else random_merge_inputs
    many = dict(CASES["many_splits"]) if op == "paged_wave_attention" \
        else dict(MERGE_CASES["many_splits"])
    few = dict(SMALL, G=4) if op == "paged_wave_attention" \
        else dict(MERGE_SMALL, G=4, seed=7)
    kern, plain = getattr(ops, op), getattr(ops, op + "_plain")
    for kw in (many, few, many):
        args = [a.to(cuda) for a in make(**kw)]
        out = kern(*args, softcap=50.0)
        torch.cuda.synchronize()
        ref = plain(*args, softcap=50.0)
        assert (out - ref).abs().max().item() <= \
            2e-5 * (1 + ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [3, 5, 6, 7])
@pytest.mark.parametrize("op", ["paged_wave_attention", "wave_attention_merge"])
def test_cuda_attention_at_group_sizes_between_powers_of_two(cuda, op, G, hd,
                                                             dtype):
    """Both attention kernels at G 3, 5, 6 and 7 query heads per KV head
    (mixtral-8x22b has 6, llava-next-34b 7), hd 64 and 128, against their
    twins within the kernels' gate, the same bits from two calls."""
    if op == "paged_wave_attention":
        args = random_decode_inputs(**dict(SMALL, G=G, hd=hd, dtype=dtype,
                                           window=128.0), device="cuda")
    else:
        args = random_merge_inputs(**dict(MERGE_SMALL, G=G, hd=hd,
                                          dtype=dtype), device="cuda")
    kern, plain = getattr(ops, op), getattr(ops, op + "_plain")
    out = kern(*args, softcap=50.0)
    again = kern(*args, softcap=50.0)
    torch.cuda.synchronize()
    ref = plain(*args, softcap=50.0)
    assert out.shape == ref.shape and out.shape[2] == G
    assert (out - ref).abs().max().item() <= \
        2e-5 * (1 + ref.abs().max().item())
    assert torch.equal(out, again)


def _served_g1_inputs(op, H, ctx, q_pos, local_len):
    """Inputs at a G-1, hd-64 model's served decode geometry, sized by the
    default RetroConfig's plan at ``ctx`` tokens (gen headroom 1024, the
    engine's): zamba2-1.2b's shared-attention sites (32 KV heads) at 8192
    tokens, whisper-tiny's decoder (6) at its 448-token context."""
    from repro_torch.configs.base import RetroConfig
    from repro_torch.core.zones import plan_zones
    retro = RetroConfig()
    plan = plan_zones(ctx, retro, 1024)
    if op == "paged_wave_attention":
        return random_decode_inputs(
            B=2, H=H, G=1, hd=64, M=plan.m_max, cap=retro.cluster_cap,
            sink=retro.sink, lbuf=plan.local_buf, r=plan.r, e=plan.e,
            q_pos=q_pos, local_len=local_len, device="cuda")
    return random_merge_inputs(
        B=2, H=H, G=1, hd=64,
        T=retro.sink + plan.local_buf + plan.r * retro.cluster_cap,
        E=plan.e + plan.r, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["zamba2", "whisper"])
@pytest.mark.parametrize("op", ["paged_wave_attention", "wave_attention_merge"])
def test_cuda_attention_at_served_g1_geometries(cuda, op, model):
    """Both attention kernels at G 1, hd 64, bf16 stores, at the decode
    shapes zamba2-1.2b (H 32) and whisper-tiny (H 6) serve, against their
    twins within the kernels' gate, the same bits from two calls."""
    args = _served_g1_inputs(op, *dict(
        zamba2=(32, 8192, (8200, 6010), (72, 1088)),
        whisper=(6, 448, (460, 310), (76, 60)))[model])
    kern, plain = getattr(ops, op), getattr(ops, op + "_plain")
    out = kern(*args, softcap=None)
    again = kern(*args, softcap=None)
    torch.cuda.synchronize()
    ref = plain(*args, softcap=None)
    assert out.shape == ref.shape and out.shape[2] == 1
    assert (out - ref).abs().max().item() <= \
        2e-5 * (1 + ref.abs().max().item())
    assert torch.equal(out, again)


def _stores(cuda, shape, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=cuda).to(dtype)
                 for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("cap,hd,r", [(16, 32, 9), (33, 256, 5), (32, 256, 1),
                                      (1, 8, 4)])
def test_cuda_block_gather_is_exact(cuda, dtype, cap, hd, r):
    """Bit-exact against the twin and the same bits twice: blocks smaller
    than, equal to and not a multiple of the kernel's chunk (cap 33, hd 256
    in f32 is 33 KB: four 8 KB chunks and a short one), one slot (r 1),
    and blocks of 16 bytes (cap 1, hd 8 in f16/bf16)."""
    kst, vst = _stores(cuda, (2, 2, 64, cap, hd), dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    idx = torch.randint(0, 64, (2, 2, r), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[0, 0, :3] = 5                                  # repeated ids
    before = gather_ops.block_gather_op.launches
    ko, vo = gather_ops.block_gather_op(idx, kst, vst)
    torch.cuda.synchronize()
    assert gather_ops.block_gather_op.launches == before + 1
    kr, vr = gather_ops.block_gather_plain(idx, kst, vst)
    assert torch.equal(ko, kr) and torch.equal(vo, vr)
    ko2, vo2 = gather_ops.block_gather_op(idx, kst, vst)
    assert torch.equal(ko2, ko) and torch.equal(vo2, vo)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_block_gather_zero_fills_out_of_range_ids(cuda, dtype):
    """Ids below 0 or at or above M give zero blocks (every chunk of them);
    the other slots are copied exactly."""
    kst, vst = _stores(cuda, (1, 2, 40, 33, 256), dtype)
    idx = torch.tensor([[[3, -1, 40, 7, 1000], [39, 39, -5, 0, 2]]],
                       dtype=torch.int32, device=cuda)
    bad = (idx < 0) | (idx >= 40)
    # leave NaNs where the outputs will be allocated: the zero fill must
    # write every byte
    poison = [torch.full((1, 2, 5, 33, 256), float("nan"), dtype=dtype,
                         device=cuda) for _ in range(2)]
    del poison
    ko, vo = gather_ops.block_gather_op(idx, kst, vst)
    torch.cuda.synchronize()
    kr, vr = gather_ops.block_gather_plain(idx.clamp(0, 39), kst, vst)
    for got, want in ((ko, kr), (vo, vr)):
        assert (got[bad] == 0).all()
        assert torch.equal(got[~bad], want[~bad])


@pytest.mark.cuda
def test_cuda_block_gather_refuses_misaligned_and_odd_blocks(cuda):
    flat = torch.zeros(2 * 2 * 8 * 4 * 16 + 1, dtype=torch.bfloat16,
                       device=cuda)
    shifted = flat[1:].view(2, 2, 8, 4, 16)            # 2 bytes off
    good = torch.zeros((2, 2, 8, 4, 16), dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros((2, 2, 3), dtype=torch.int32, device=cuda)
    before = gather_ops.block_gather_op.launches
    with pytest.raises(ValueError, match="aligned"):
        gather_ops.block_gather_op(idx, shifted, good)
    with pytest.raises(ValueError, match="aligned"):
        gather_ops.block_gather_op(idx, good, torch.zeros(
            (2, 2, 8, 4, 32), dtype=torch.bfloat16, device=cuda)[..., ::2])
    odd = torch.zeros((2, 2, 8, 1, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        gather_ops.block_gather_op(idx, odd, odd)
    assert gather_ops.block_gather_op.launches == before


def _kmeans_case(cuda, S, n, d, k):
    g = torch.Generator(device=cuda).manual_seed(n * d + k)
    x = torch.randn((S, n, d), generator=g, device=cuda)
    if k > n:
        return x, torch.randn((S, k, d), generator=g, device=cuda)
    return x, x[:, :k].clone()


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,d,k", [
    (4, 256, 32, 16), (2, 1000, 256, 70), (1, 64, 16, 1),
    (3, 1000, 72, 70),          # n, d, k all off the 128 x 128 x 32 tiles
    (2, 300, 8, 5),             # d below one dim chunk
    (2, 50, 40, 7),             # n below one point tile
    (1, 200, 30, 9),            # d % 4 != 0: the 4-byte copy path
    (2, 700, 64, 1100),         # k > 1024: two passes of the order kernel
])
def test_cuda_kmeans_step_matches_twin(cuda, S, n, d, k):
    """``kmeans_step_check``; the sums equal, bit for bit, the point-order
    sums over the kernel's own assignments; two calls give the same bits."""
    x, cent = _kmeans_case(cuda, S, n, d, k)
    before = kmeans_ops.kmeans_step.launches
    sums, counts, assign = kmeans_ops.kmeans_step(x, cent)
    torch.cuda.synchronize()
    assert kmeans_ops.kmeans_step.launches == before + 1
    res = kmeans_step_check(x, cent, sums, counts, assign)
    assert res["ok"], res
    os_, oc = ordered_update_ref(x, assign, k)
    assert torch.equal(sums, os_) and torch.equal(counts, oc)
    again = kmeans_ops.kmeans_step(x, cent)
    for a, b in zip(again, (sums, counts, assign)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 200])
def test_cuda_kmeans_exact_ties_take_the_lowest_index(cuda, k):
    """Duplicated centroids give exactly equal similarities: every point
    goes to the lower index, within a tile and across centroid tiles
    (k 200: columns 3 and 130); identical centroids all go to 0."""
    x, cent = _kmeans_case(cuda, 2, 500, 64, k)
    dup = {2: 5, 0: k - 1} if k == 8 else {3: 130, 0: 199, 64: 65}
    for lo, hi in dup.items():
        cent[:, hi] = cent[:, lo]
    _, counts, assign = kmeans_ops.kmeans_step(x, cent)
    for lo, hi in dup.items():
        assert (assign != hi).all() and (counts[:, hi] == 0).all()
        assert (counts[:, lo] > 0).any()
    res = kmeans_step_check(x, cent, *kmeans_ops.kmeans_step(x, cent)[:2],
                            assign)
    assert res["ok"], res
    same = torch.ones_like(cent)
    _, counts, assign = kmeans_ops.kmeans_step(x, same)
    assert (assign == 0).all() and (counts[:, 0] == 500).all()


# ---------------------------------------------------------------------------
# prefill attention (blocking admission's causal attention)
# ---------------------------------------------------------------------------

# (B, Tq, Hq, Hkv, q_offset): mistral's long-cell prompts (G 4) at a whole
# and a ragged length, mixtral's (G 6) at both ends of its mix, prompts
# below one 128-row block and one 64-key tile, and queries past a prefix
PREFILL_CASES = {
    "long_16384": (1, 16384, 32, 8, 0),
    "long_ragged_12289": (1, 12289, 32, 8, 0),
    "mixtral_2049": (1, 2049, 48, 8, 0),
    "mixtral_6143": (1, 6143, 48, 8, 0),
    "below_one_tile": (2, 5, 32, 8, 0),
    "q_offset_77": (1, 300, 32, 8, 77),
}
# Kernel against twin, both f32 out of the same bf16 inputs: they differ by
# f32 rounding alone (the kernel sums q k exactly in the tensor cores and
# scales after, adds p v a tile at a time and in another order, and the
# tensor cores' f32 accumulation truncates), ~1e-6 of the output's scale;
# a bf16 p (2^-9 relative) misses by ~1e-3 where few keys dominate.
PREFILL_TOL = 2e-5


def _prefill_inputs(cuda, B, Tq, Hq, Hkv, q_offset, seed=0, qk_scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    Tk = q_offset + Tq

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * s).bfloat16()
    return (randn(B, Tq, Hq, 128, s=qk_scale), randn(B, Tk, Hkv, 128,
                                                      s=qk_scale),
            randn(B, Tk, Hkv, 128))


def _prefill_err(out, ref):
    return ((out - ref).abs().max().item(),
            PREFILL_TOL * (1 + ref.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_cuda_prefill_attention_matches_twin(cuda, case):
    B, Tq, Hq, Hkv, off = PREFILL_CASES[case]
    q, k, v = _prefill_inputs(cuda, B, Tq, Hq, Hkv, off)
    before = pa_ops.prefill_attention.launches
    out = pa_ops.prefill_attention(q, k, v, q_offset=off,
                                   out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert pa_ops.prefill_attention.launches == before + 1
    ref = pa_ops.prefill_attention_plain(q, k, v, q_offset=off,
                                         out_dtype=torch.float32)
    err, tol = _prefill_err(out, ref)
    assert torch.isfinite(out).all()
    assert err <= tol, (err, tol)
    assert torch.equal(pa_ops.prefill_attention(
        q, k, v, q_offset=off, out_dtype=torch.float32), out)
    # bf16 out is the f32 result rounded once
    assert torch.equal(pa_ops.prefill_attention(q, k, v, q_offset=off),
                       out.bfloat16())


@pytest.mark.cuda
def test_cuda_prefill_attention_padded_row(cuda):
    """A right-padded row (pads after its real tokens, as blocking admission
    batches ragged prompts) gives its real rows the bits of the same prompt
    alone: causality hides the pads."""
    q, k, v = _prefill_inputs(cuda, 2, 1000, 32, 8, 0, seed=1)
    n = 613
    out = pa_ops.prefill_attention(q, k, v, out_dtype=torch.float32)
    alone = pa_ops.prefill_attention(q[1:, :n], k[1:, :n], v[1:, :n],
                                     out_dtype=torch.float32)
    assert torch.equal(out[1, :n], alone[0])
    ref = pa_ops.prefill_attention_plain(q, k, v, out_dtype=torch.float32)
    err, tol = _prefill_err(out, ref)
    assert err <= tol, (err, tol)


def _bf16_p_attention(q, k, v):
    """Causal attention whose p is rounded to bf16 before p v (l from the
    f32 p): the single-pass variant the kernel's three-way split avoids."""
    B, T, Hq, d = q.shape
    G = Hq // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / d ** 0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vf)
    return (o / p.sum(dim=-1)[..., None]).transpose(1, 2)


@pytest.mark.cuda
def test_cuda_prefill_attention_keeps_p_in_f32(cuda):
    """Scores spread wide (q, k at 3x unit scale) let a few keys share each
    row's weight with p far from bf16 values: the kernel stays within the
    f32 tolerance of the twin, and p rounded to bf16 does not."""
    q, k, v = _prefill_inputs(cuda, 1, 256, 32, 8, 0, seed=2, qk_scale=3.0)
    ref = pa_ops.prefill_attention_plain(q, k, v, out_dtype=torch.float32)
    err, tol = _prefill_err(pa_ops.prefill_attention(
        q, k, v, out_dtype=torch.float32), ref)
    assert err <= tol, (err, tol)
    err16, _ = _prefill_err(_bf16_p_attention(q, k, v), ref)
    assert err16 > 10 * tol, (err16, tol)


@pytest.mark.cuda
def test_cuda_flash_attention_routes_covered_calls(cuda):
    """``flash_attention_jnp`` launches the kernel for causal bf16 hd-128
    calls with no soft cap and the global layers' window sentinel, with the
    kernel's bits; a soft cap, a window that masks, hd 64, f32 inputs or a
    gradient keep the plain body."""
    q, k, v = _prefill_inputs(cuda, 1, 700, 32, 8, 0, seed=3)
    before = pa_ops.prefill_attention.launches
    out = L.flash_attention_jnp(q, k, v, causal=True, window=GLOBAL_WINDOW)
    assert pa_ops.prefill_attention.launches == before + 1
    assert torch.equal(out, pa_ops.prefill_attention(q, k, v))
    before = pa_ops.prefill_attention.launches
    plain = [dict(softcap=50.0), dict(window=256.5), dict(causal=False)]
    for kw in plain:
        L.flash_attention_jnp(q, k, v, **{"causal": True, **kw})
    L.flash_attention_jnp(q[..., :64], k[..., :64], v[..., :64])
    L.flash_attention_jnp(q.float(), k.float(), v.float())
    with torch.enable_grad():
        L.flash_attention_jnp(q.requires_grad_(), k, v)
    torch.cuda.synchronize()
    assert pa_ops.prefill_attention.launches == before


# (Tq, Hq, Hkv, window): K-EXAONE's sliding layers (W 128) and a wide
# window (W 4096) at a 16k prompt, G 8; a masking window across a q_offset
PREFILL_WINDOW_CASES = {
    "kexaone_w128": (16384, 64, 8, 0, 128),
    "w4096": (16384, 64, 8, 0, 4096),
    "w100_q_offset_77": (300, 32, 8, 77, 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PREFILL_WINDOW_CASES))
def test_cuda_prefill_attention_window_matches_twin(cuda, case):
    """The windowed instantiation against the twin's windowed body: only
    the keys p - W < j <= p count. The twin (f32 scores a key block at a
    time for every query) runs on the first and the last 2048 queries of a
    long prompt, as queries at their offset: the window's growth from the
    prompt's start and its steady lower edge."""
    Tq, Hq, Hkv, off, W = PREFILL_WINDOW_CASES[case]
    q, k, v = _prefill_inputs(cuda, 1, Tq, Hq, Hkv, off, seed=4)
    out = pa_ops.prefill_attention(q, k, v, q_offset=off, window=W,
                                   out_dtype=torch.float32)
    assert torch.isfinite(out).all()
    n = min(Tq, 2048)
    for lo in sorted({0, Tq - n}):
        hi = off + lo + n
        ref = pa_ops.prefill_attention_plain(
            q[:, lo:lo + n], k[:, :hi], v[:, :hi], q_offset=off + lo,
            window=W, out_dtype=torch.float32)
        err, tol = _prefill_err(out[:, lo:lo + n], ref)
        assert err <= tol, (lo, err, tol)
    assert torch.equal(pa_ops.prefill_attention(
        q, k, v, q_offset=off, window=W, out_dtype=torch.float32), out)


@pytest.mark.cuda
def test_cuda_prefill_attention_window_wider_than_the_prompt(cuda):
    """A window wider than every query-key distance masks nothing: the
    windowed instantiation gives the unwindowed kernel's bits, and
    ``flash_attention_jnp`` routes such a window to the unwindowed one;
    a masking window goes to the windowed one, with its bits."""
    q, k, v = _prefill_inputs(cuda, 1, 3000, 64, 8, 0, seed=5)
    plain = pa_ops.prefill_attention(q, k, v, out_dtype=torch.float32)
    wide = pa_ops.prefill_attention(q, k, v, window=3000 + 17,
                                    out_dtype=torch.float32)
    assert torch.equal(wide, plain)
    assert pa_ops.kernel_window(5000.0, 0, 3000) == 0
    assert torch.equal(L.flash_attention_jnp(q, k, v, window=5000.0),
                       plain.bfloat16())
    assert torch.equal(L.flash_attention_jnp(q, k, v, window=128.0),
                       pa_ops.prefill_attention(q, k, v, window=128))


@pytest.mark.cuda
def test_cuda_apply_prefill_launches_once_per_layer(cuda):
    """Blocking admission at mistral's attention widths (d_model 4096, Hq
    32, Hkv 8, hd 128, bf16; two layers, a small vocabulary and FFN) runs
    the kernel once per layer per admission, ragged batch included."""
    from repro_torch.configs.minitron_8b import CONFIG
    from repro_torch.models import model as M
    cfg = CONFIG.replace(n_layers=2, d_ff=2048, vocab=1024)
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    before = pa_ops.prefill_attention.launches
    for T in (1500, 777):
        toks = torch.randint(0, cfg.vocab, (1, T), generator=g, device=cuda)
        logits, _ = M.apply_prefill(params, cfg, {"tokens": toks},
                                    gen_headroom=256)
        assert torch.isfinite(logits).all()
    toks = torch.randint(0, cfg.vocab, (2, 900), generator=g, device=cuda)
    lens = torch.tensor([900, 640], device=cuda)
    logits, _ = M.apply_prefill(params, cfg, {"tokens": toks}, lengths=lens,
                                gen_headroom=256)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert pa_ops.prefill_attention.launches == before + 3 * cfg.n_layers
