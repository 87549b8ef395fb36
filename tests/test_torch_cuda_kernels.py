"""The CUDA paged wave-attention kernel against its plain twin, on a CUDA
card (marked ``cuda``; skipped without a card: a CUDA kernel has no CPU
mode). Imports no JAX, so it also runs on a machine with the card and
without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from repro_torch.kernels.wave_attention import ops
from repro_torch.kernels.wave_attention.ref import random_decode_inputs

torch.set_num_threads(2)
SMALL = dict(H=2, hd=32, M=48, cap=16, lbuf=160, r=3, e=10, q_pos=(900, 300),
             local_len=(40, 160))
CASES = {
    "f32_global": dict(SMALL, dtype="float32"),
    "bf16_window": dict(SMALL, window=128.0, live_frac=0.7),
    "hd256_bf16": dict(SMALL, hd=256, cap=32, M=40),
    "G8_hd64": dict(SMALL, G=8, hd=64),
    "G1_dead_slot": dict(SMALL, G=1, r0=True),
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
    args = [a.to(cuda) for a in random_decode_inputs(**CASES[case])]
    before = ops.paged_wave_attention.launches
    out = ops.paged_wave_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.paged_wave_attention.launches == before + 1
    ref = ops.paged_wave_attention_plain(*args, softcap=softcap)
    tol = 2e-5 * (1 + ref.abs().max().item())
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= tol


def test_cpu_tensors_use_the_twin_without_counting():
    args = random_decode_inputs(**CASES["bf16_window"])
    before = ops.paged_wave_attention.launches
    out = ops.paged_wave_attention(*args, softcap=50.0)
    assert ops.paged_wave_attention.launches == before
    torch.testing.assert_close(
        out, ops.paged_wave_attention_plain(*args, softcap=50.0),
        rtol=0, atol=0)
