"""The frozen yardstick against hand counts, and against the program's
own zone plan as it stands today."""
import pytest

from perfbench.roofline import bounds


def test_bound_picks_the_larger_term():
    assert bounds.bound(3.35e12, 0) == (1.0, "bytes")
    assert bounds.bound(0, 67e12) == (1.0, "operations")
    t, by = bounds.bound(3.35e9, 989e12, bounds.BF16_FLOPS)
    assert by == "operations" and t == pytest.approx(1.0)


def test_zone_plan_hand_count():
    # 16384 tokens: (16384 - 68) = 16316 clustered: one 8192 segment (512
    # clusters) and an 8124-token tail (507); headroom 1024 adds 64
    p = bounds.zone_plan(16384, 1024)
    assert bounds.prefill_clusters(16384) == 1019
    assert p == bounds.Plan(m_max=1280, r=18, e=238, sink=4, local_buf=1088)


@pytest.mark.parametrize("ctx", [100, 1536, 6144, 16384, 40000])
@pytest.mark.parametrize("headroom", [256, 1024, 4096])
def test_zone_plan_matches_the_program(ctx, headroom):
    from repro_torch.configs.base import RetroConfig
    from repro_torch.core.zones import plan_zones
    want = plan_zones(ctx, RetroConfig(), headroom)
    assert tuple(bounds.zone_plan(ctx, headroom)) == tuple(want)


def test_paged_call_terms_hand_count():
    plan = bounds.Plan(m_max=256, r=2, e=3, sink=4, local_buf=1088)
    # one row holding 144 staged tokens (local 64 + 80 decoded)
    nbytes, flops = bounds.paged_call_terms(1, 144, 1, 4, 128, plan)
    n_tok = 4 + 144 + 2 * 16                            # 180 tokens
    E = 3 + 2
    per = (n_tok * 2 * 128 * 2 + 144 * 4 + 2 * 32 * 4 + (2 * 2 + 2) * 4
           + 4 * 128 * 4 + 2 * 4 * E * 4 + E * 128 * 4 + 4 * 128 * 4)
    assert nbytes == per
    assert flops == n_tok * 4 * 4 * 128 + 4 * E * 2 * 128
    # 3 rows holding 144 + 145 + 146 staged tokens, 8 KV heads
    n2, f2 = bounds.paged_call_terms(3, 435, 8, 4, 128, plan)
    assert n2 == 8 * (3 * per + 3 * (2 * 128 * 2 + 4))
    assert f2 == 8 * (3 * flops + 3 * 4 * 4 * 128)


def test_slicer_counts_the_staging_buffer():
    """The slice's staged tokens follow the engine's rule: ``local`` after
    admission, one more a step, ``update_segment`` fewer after the step
    that fills the buffer."""
    import numpy as np
    from perfbench.lib.trace import Slicer
    sl = Slicer(local=4, update_segment=3)
    sl._staged[1] = 4                                   # slot 1 admitted
    both = np.array([True, True])
    assert sl.stage(both) == 5 + 5                      # slot 0: local too
    assert sl.stage(np.array([False, True])) == 6
    assert sl.stage(both) == 6 + 7                      # slot 1 flushes
    assert sl._staged == {0: 6, 1: 4}
    assert sl.stage(both) == 7 + 5                      # slot 0 flushes
    assert sl._staged == {0: 4, 1: 5}


def test_moe_bytes_hand_count():
    # 8 experts of 6144 x 16384 (gate, up, down) in bf16, f32 router,
    # 16 tokens in and out in bf16
    n = bounds.moe_bytes(8, 8, 6144, 16384, 16)
    assert n == 8 * 3 * 6144 * 16384 * 2 + 6144 * 8 * 4 + 16 * 2 * 6144 * 2
    assert bounds.bound(n, 0)[0] == pytest.approx(n / 3.35e12)


def test_served_flops_hand_count():
    pub = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
           "vocab_size": 10}
    blocks, head = bounds.matmul_params(pub)
    assert blocks == 2 * (8 * 4 * 4 + 8 * 8 + 3 * 8 * 16)
    assert head == 80
    plan = bounds.zone_plan(64, 0)
    # a 3-token prompt and one answer token: the prompt only
    f = bounds.served_flops(pub, 3, 1, plan)
    assert f == 2 * blocks * 3 + 2 * head + 2 * 4 * 2 * 4 * 6
    # one decoded token over a 3-token context and itself, no clusters yet
    g = bounds.served_flops(pub, 3, 2, plan) - f
    assert g == 2 * blocks + 2 * head + 2 * 2 * 4 * (4 * 4)
    # a 100-token prompt (local 64, 2 clusters) and 2 decoded tokens
    retro = bounds.Retro(avg_cluster=16, local=64, update_segment=2)
    plan2 = bounds.zone_plan(100, 0, retro)
    assert (bounds.prefill_clusters(100, retro), plan2.r, plan2.e) == (2, 1, 1)
    h = bounds.served_flops(pub, 100, 3, plan2, retro) \
        - bounds.served_flops(pub, 100, 1, plan2, retro)
    step1 = 2 * 2 * 4 * (2 * 2 + 4 * (4 + 65 + 16) + 2 * 2)
    # the second step fills the buffer (66 = 64 + 2), then flushes
    step2 = 2 * 2 * 4 * (2 * 2 + 4 * (4 + 66 + 16) + 2 * 2)
    assert h == 2 * (2 * blocks + 2 * head) + step1 + step2
    moe = dict(pub, num_local_experts=4, num_experts_per_tok=2)
    assert bounds.matmul_params(moe)[0] == 2 * (8 * 4 * 4 + 8 * 8
                                                + 2 * 3 * 8 * 16 + 8 * 4)
