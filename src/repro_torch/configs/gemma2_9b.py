"""gemma2-9b — local/global alternating, logit softcap [arXiv:2408.00118].
Port of ``repro/configs/gemma2_9b.py``."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, d_ff=14336, vocab=256000,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=256,
                    softcap=50.0, sliding_window=4096, pattern=("l", "g")),
    act="gelu",
    source="arXiv:2408.00118 (Gemma2-9B: 42L d=3584 16H GQA kv=8 d_ff=14336 "
           "vocab=256000, alternating SWA+global, attn softcap 50)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=256, vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32, softcap=50.0,
                        sliding_window=128, pattern=("l", "g")),
        dtype="float32", retro=SMOKE_RETRO)
