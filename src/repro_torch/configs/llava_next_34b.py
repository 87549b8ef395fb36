"""llava-next-34b — anyres-tiling VLM backbone [hf:llava-hf/llava-v1.6].
Port of ``repro/configs/llava_next_34b.py``.

The vision encoder and projector are stubs, as in the reference: a request
brings precomputed patch embeddings (anyres ~5 tiles x 576 patches) at model
width, which replace the embeddings of its first positions.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, d_ff=20480, vocab=64000,
    attn=AttnConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                    rope_theta=5_000_000.0),
    num_patch_tokens=2880,
    tie_embeddings=False,
    source="hf:llava-hf/llava-v1.6 (34B backbone: 60L d=7168 56H GQA kv=8 "
           "d_ff=20480 vocab=64000, anyres tiling)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=256, vocab=512, num_patch_tokens=64,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32),
        dtype="float32", retro=SMOKE_RETRO)
