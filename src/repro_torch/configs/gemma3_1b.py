"""gemma3-1b — 5:1 local:global interleave, 262k vocab [hf:google/gemma-3-1b-pt].
Port of ``repro/configs/gemma3_1b.py``."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, d_ff=6912, vocab=262144,
    attn=AttnConfig(n_heads=4, n_kv_heads=1, head_dim=256,
                    rope_theta=1_000_000.0, sliding_window=512,
                    pattern=("l", "l", "l", "l", "l", "g")),
    act="gelu",
    source="hf:google/gemma-3-1b-pt (26L d=1152 4H GQA kv=1 d_ff=6912 "
           "vocab=262144, 5:1 local:global, 128k ctx)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=256, vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=1, head_dim=32,
                        sliding_window=128, pattern=("l", "g")),
        dtype="float32", retro=SMOKE_RETRO)
