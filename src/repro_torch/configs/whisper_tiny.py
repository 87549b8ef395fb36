"""whisper-tiny — enc-dec audio backbone, conv frontend stubbed
[arXiv:2212.04356]. Port of ``repro/configs/whisper_tiny.py``.

The mel-spectrogram and conv feature extractor are stubs, as in the
reference: a request brings precomputed frame embeddings (1, frames,
d_model) in ``Request.extra["frames"]``."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny", family="audio",
    n_layers=4, d_model=384, d_ff=1536, vocab=51865,
    attn=AttnConfig(n_heads=6, n_kv_heads=6, head_dim=64),
    encoder_layers=4, encoder_frames=1500,
    source="arXiv:2212.04356 (Whisper tiny: 4L enc + 4L dec, d=384 6H "
           "d_ff=1536 vocab=51865; mel+conv frontend stubbed)",
)


def reduced():
    from repro_torch.configs.registry import SMOKE_RETRO
    return CONFIG.replace(
        n_layers=2, d_model=128, d_ff=256, vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32),
        encoder_layers=2, encoder_frames=64,
        dtype="float32", retro=SMOKE_RETRO)
