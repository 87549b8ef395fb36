"""Architecture registry. Port of ``repro/configs/registry.py`` without JAX:
every config of the reference — dense (gemma2-2b, gemma2-9b, gemma3-1b,
minitron-8b), moe (mixtral-8x22b, kimi-k2-1t-a32b), vlm (llava-next-34b),
ssm (rwkv6-3b), hybrid (zamba2-1.2b) and audio (whisper-tiny);
``input_specs``/``materialize_batch`` are not ported yet."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, RetroConfig

ALIASES = {
    "gemma3-1b": "gemma3_1b",
    "gemma2-9b": "gemma2_9b",
    "minitron-8b": "minitron_8b",
    "gemma2-2b": "gemma2_2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llava-next-34b": "llava_next_34b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-tiny": "whisper_tiny",
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def reduced_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{arch}").reduced()


# Reduced-scale RetroConfig used by every smoke variant.
SMOKE_RETRO = RetroConfig(avg_cluster=8, cluster_cap=16, prefill_segment=256,
                          update_segment=128, sink=4, local=32,
                          retrieval_frac=0.06, estimation_frac=0.25,
                          kmeans_iters=3)
