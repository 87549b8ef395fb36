"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].
Port of ``repro/configs/zamba2_1p2b.py``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, d_ff=8192, vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=64),
    ssm=SSMConfig(kind="mamba2", state_size=64, head_dim=64, expand=2),
    shared_attn_every=6,
    source="arXiv:2411.15242 (Zamba2: 38L d=2048 32H MHA d_ff=8192 "
           "vocab=32000 ssm_state=64)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=256, vocab=512, shared_attn_every=2,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32),
        ssm=SSMConfig(kind="mamba2", state_size=16, head_dim=32, expand=2),
        dtype="float32", retro=SMOKE_RETRO)
