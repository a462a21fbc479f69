"""Architecture lookups for the archs the port serves."""

from __future__ import annotations

import re

from repro_torch.configs import (bitnet_2b, gemma_7b, internvl2_2b,
                                 phi3p5_moe, qwen2p5_14b, qwen3_0p6b,
                                 whisper_large_v3, xlstm_125m, yi_34b,
                                 zamba2_2p7b)
from repro_torch.models.config import ModelConfig, reduced

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                 for m in [bitnet_2b, phi3p5_moe, zamba2_2p7b,
                                          xlstm_125m, qwen3_0p6b, gemma_7b,
                                          qwen2p5_14b, yi_34b,
                                          whisper_large_v3, internvl2_2b]}


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
