"""mixtral-8x22b — 8 experts top-2, SWA [arXiv:2401.04088].
Port of ``repro/configs/mixtral_8x22b.py``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, d_ff=16384, vocab=32768,
    attn=AttnConfig(n_heads=48, n_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0, sliding_window=4096,
                    pattern=("l",)),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=16384),
    tie_embeddings=False,
    source="arXiv:2401.04088 (Mixtral 8x22B: 56L d=6144 48H GQA kv=8 "
           "per-expert d_ff=16384 vocab=32768, 8e top-2, SWA)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=128, vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        sliding_window=128, pattern=("l",)),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128),
        dtype="float32", retro=SMOKE_RETRO)
