"""K-EXAONE-236B-A23B — 48 layers in the pattern LLLG (36 sliding-window
layers of 128 positions, 12 global ones without RoPE), post-sublayer norms,
a per-head QK RMSNorm, one leading dense layer and 47 MoE layers of 128
experts (sigmoid scores with a selection bias, top 8 renormalised x 2.5,
one shared expert). Source: huggingface.co/LGAI-EXAONE/K-EXAONE-236B-A23B
(config.json); the block as the EXAONE 4.0 technical report (LG AI
Research, 2025) describes it.

Port-only: the JAX package has no such model, so this module is not in
``registry.ARCH_IDS`` (which mirrors the reference's registry);
``registry.get_config("k_exaone_236b_a23b")`` finds it by name. Under the
retro runtime its sliding layers keep a ring of their last 128 keys and
values (``AttnConfig.ring_window``) and its global layers the wave index.
The multi-token-prediction layer (self-speculative decoding) is left out.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="k-exaone-236b-a23b", family="moe",
    n_layers=48, d_model=6144, d_ff=18432, vocab=153600,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0, sliding_window=128,
                    pattern=("l", "l", "l", "g"), ring_window=True,
                    qk_norm=True, rope_layers="l"),
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=2048, scoring="sigmoid",
                  d_shared=2048, routed_scale=2.5, n_routed=128),
    tie_embeddings=False, norm_eps=1e-5, norm_placement="post",
    dense_layers=1,
    source="huggingface.co/LGAI-EXAONE/K-EXAONE-236B-A23B (48L LLLG, SWA 128, "
           "d=6144 64H GQA kv=8 hd=128, dense d_ff=18432, 128e top-8 "
           "sigmoid + 1 shared, expert d_ff=2048, vocab=153600)",
)


def reduced():
    """Five layers of kinds L L L G L (layer 0 the dense one), window 8, 4
    of 8 experts held (from expert 2), top 2, float32: the CPU tests'
    size."""
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=5, d_model=64, d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                        rope_theta=1_000_000.0, sliding_window=8,
                        pattern=("l", "l", "l", "g"), ring_window=True,
                        qk_norm=True, rope_layers="l"),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32, scoring="sigmoid",
                      d_shared=32, routed_scale=2.5, n_routed=8,
                      expert_lo=2),
        dtype="float32", retro=SMOKE_RETRO)
