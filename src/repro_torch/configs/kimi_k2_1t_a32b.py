"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].
Port of ``repro/configs/kimi_k2_1t_a32b.py``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, d_ff=2048, vocab=163840,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048),
    tie_embeddings=False,
    source="arXiv:2501.kimi2 (Kimi K2 paper table: 61L d=7168 64H GQA kv=8 "
           "per-expert d_ff=2048 vocab=163840 MoE 384e top-8)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=128, vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128),
        dtype="float32", retro=SMOKE_RETRO)
