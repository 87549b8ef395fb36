"""Architecture registry and the step inputs of the assigned shape suite.
Port of ``repro/configs/registry.py`` without JAX: every config of the
reference — dense (gemma2-2b, gemma2-9b, gemma3-1b, minitron-8b), moe
(mixtral-8x22b, kimi-k2-1t-a32b), vlm (llava-next-34b), ssm (rwkv6-3b),
hybrid (zamba2-1.2b) and audio (whisper-tiny) — ``all_configs``, and the
batch of a step: ``input_specs`` (shape-and-dtype stand-ins on the meta
device) and ``materialize_batch`` (random tensors from a generator)."""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig, RetroConfig

ARCH_IDS = (
    "zamba2_1p2b",
    "kimi_k2_1t_a32b",
    "gemma3_1b",
    "gemma2_9b",
    "minitron_8b",
    "rwkv6_3b",
    "llava_next_34b",
    "whisper_tiny",
    "gemma2_2b",
    "mixtral_8x22b",
)

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


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# Reduced-scale RetroConfig used by every smoke variant.
SMOKE_RETRO = RetroConfig(avg_cluster=8, cluster_cap=16, prefill_segment=256,
                          update_segment=128, sink=4, local=32,
                          retrieval_frac=0.06, estimation_frac=0.25,
                          kmeans_iters=3)


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors (shape and dtype, no storage) standing in for the
    step's batch: ``tokens`` and ``targets`` (train), ``tokens``
    (prefill), ``token`` (decode: the KV state carries the context), plus
    the stubbed modality inputs at model width, ``patch_embeds`` (vlm) and
    ``frames`` (audio), outside decode."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": spec((B, S), i32), "targets": spec((B, S), i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": spec((B, S), i32)}
    else:
        batch = {"token": spec((B,), i32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patch_embeds"] = spec((B, cfg.num_patch_tokens, cfg.d_model),
                                     act)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["frames"] = spec((B, cfg.encoder_frames, cfg.d_model), act)
    return batch


def materialize_batch(cfg: ModelConfig, shape: InputShape,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> Dict[str, torch.Tensor]:
    """A random batch matching ``input_specs`` on ``device`` (default
    ``cuda``): integer inputs uniform in [0, vocab), float inputs standard
    normal drawn in f32 and cast. ``generator`` defaults to one on that
    device seeded with 0. (JAX's random bits differ; the two packages agree
    in shapes, dtypes and ranges.)"""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    dtype=torch.float32,
                                    device=dev).to(spec.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, spec.shape,
                                      generator=generator, dtype=spec.dtype,
                                      device=dev)
    return out
