"""minitron-8b — width-pruned Nemotron-4 [arXiv:2407.14679].
Port of ``repro/configs/minitron_8b.py``."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b", family="dense",
    n_layers=32, d_model=4096, d_ff=16384, vocab=256000,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    tie_embeddings=False,
    source="arXiv:2407.14679 (Minitron-8B: 32L d=4096 32H GQA kv=8 "
           "d_ff=16384 vocab=256000)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=256, vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32),
        dtype="float32", retro=SMOKE_RETRO)
