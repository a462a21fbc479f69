"""Architecture lookups for the archs the port serves, and the per-(arch ×
shape) dry-run cells with their input specs.

``input_specs`` returns shape-only stand-ins for every model input of a
dry-run cell: tensors on the ``meta`` device, or fake tensors when called
under a ``FakeTensorMode`` with its device (``launch/dryrun.py``); nothing
is allocated.  One difference from the reference: a decode cell's
``index`` is ``int32 [B]``, the per-slot positions the port's
``decode.decode_step`` takes, where the reference's serve step takes a
scalar."""

from __future__ import annotations

import re

import torch

from repro_torch.configs import (bitnet_2b, gemma_7b, internvl2_2b,
                                 llama4_maverick_400b, phi3p5_moe,
                                 qwen2p5_14b, qwen3_0p6b, whisper_large_v3,
                                 xlstm_125m, yi_34b, zamba2_2p7b)
from repro_torch.configs.shapes import SHAPES, Shape, cells_for
from repro_torch.models.config import ModelConfig, reduced

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                 for m in [bitnet_2b, phi3p5_moe, zamba2_2p7b,
                                          xlstm_125m, qwen3_0p6b, gemma_7b,
                                          qwen2p5_14b, yi_34b,
                                          whisper_large_v3, internvl2_2b,
                                          llama4_maverick_400b]}


#: the ten assigned architectures, in the reference's order
#: (bitnet-b1.58-2b is the paper-native extra)
ASSIGNED = ["internvl2-2b", "zamba2-2.7b", "yi-34b", "gemma-7b",
            "qwen2.5-14b", "qwen3-0.6b", "llama4-maverick-400b-a17b",
            "phi3.5-moe-42b-a6.6b", "whisper-large-v3", "xlstm-125m"]


def _resolve(name: str) -> str:
    """Accept module-style aliases: ``bitnet_b1p58_2b`` → ``bitnet-b1.58-2b``
    (underscores are hyphens, ``p`` between digits is a decimal point)."""
    if name in ARCHS:
        return name
    cand = re.sub(r"(?<=\d)p(?=\d)", ".", name.replace("_", "-"))
    if cand in ARCHS:
        return cand
    raise KeyError(f"unknown arch {name!r}; the port serves: {sorted(ARCHS)}")


def get_config(name: str) -> ModelConfig:
    return ARCHS[_resolve(name)]


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)


def shape_adapted_config(cfg: ModelConfig, shape: Shape) -> ModelConfig:
    """Per-shape config adjustments: zamba2's shared attention gets a 4096
    sliding window at 500k context (the sub-quadratic adaptation for
    hybrid archs)."""
    if shape.name == "long_500k" and cfg.block_pattern == "zamba2":
        return cfg.with_(window=4096)
    return cfg


def _spec(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def train_input_specs(cfg: ModelConfig, shape: Shape,
                      device: str | torch.device = "meta") -> dict:
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": _spec((B, S), torch.int32, device),
        "labels": _spec((B, S), torch.int32, device),
        "loss_mask": _spec((B, S), torch.float32, device),
    }
    if cfg.frontend == "audio_stub":
        specs["frames"] = _spec((B, cfg.enc_seq, cfg.d_model),
                                torch.bfloat16, device)
    if cfg.frontend == "vit_stub":
        specs["vision_embeds"] = _spec((B, cfg.vision_tokens, cfg.d_model),
                                       torch.bfloat16, device)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: Shape,
                        device: str | torch.device = "meta") -> dict:
    specs = train_input_specs(cfg, shape, device)
    specs.pop("labels")
    specs.pop("loss_mask")
    return specs


def decode_input_specs(cfg: ModelConfig, shape: Shape,
                       device: str | torch.device = "meta") -> dict:
    """Inputs for one decode step: one new token per row against a
    seq_len cache.  ``index`` is ``int32 [B]`` (per-slot positions), where
    the reference's is a scalar."""
    from repro_torch.models.decode import init_cache

    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _spec((B,), torch.int32, device),
            "index": _spec((B,), torch.int32, device),
            "cache": init_cache(cfg, B, S, device=device)}


def input_specs(arch: str, shape_name: str,
                device: str | torch.device = "meta"
                ) -> tuple[ModelConfig, Shape, dict]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cfg = shape_adapted_config(cfg, shape)
    make = {"train": train_input_specs, "prefill": prefill_input_specs,
            "decode": decode_input_specs}[shape.kind]
    return cfg, shape, make(cfg, shape, device)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch × shape) dry-run cell."""
    return [(a, s) for a in ASSIGNED for s in cells_for(a)]
