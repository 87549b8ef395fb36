"""rwkv6-3b — Finch, attention-free data-dependent decay [arXiv:2404.05892].
Port of ``repro/configs/rwkv6_3b.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, d_ff=8960, vocab=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    source="arXiv:2404.05892 (RWKV-6 Finch 3B: 32L d=2560 d_ff=8960 "
           "vocab=65536, attention-free)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=256, vocab=512,
        ssm=SSMConfig(kind="rwkv6", head_dim=32),
        dtype="float32", retro=SMOKE_RETRO)
