"""Top-level model API of the dense attention family: init and the
forward trunk.

Parameters keep the reference layout: a nested dict whose per-layer leaves
are stacked on a leading layer axis (``p["blocks"]``), so trees convert
leaf for leaf (``repro_torch.convert``).  The reference's scan over that
axis is a loop over the layers here; ``p["blocks"]`` may also be a list of
per-layer dicts (the bound serving form, ``decode.bind_serving_weights``).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention, ffn, rms_norm

Params = dict[str, Any]


def _normal(g: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.bfloat16,
                       device=device) * scale


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random dense-family parameters, drawn from ``generator`` directly on
    ``device`` (the generator must live on that device), in the reference's
    shapes, dtypes and scales."""
    if cfg.block_pattern != "attn" or cfg.n_experts or cfg.is_encdec:
        raise NotImplementedError(
            f"the port serves the dense attention family; {cfg.name} "
            f"(block_pattern={cfg.block_pattern}, experts={cfg.n_experts}) "
            f"is not ported yet")
    g, dev = generator, torch.device(device)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab

    def lin(d_in, d_out, bias=False):
        leaf = {"w": _normal(g, (L, d_in, d_out), 1.0 / math.sqrt(d_in), dev)}
        if bias:
            leaf["b"] = torch.zeros((L, d_out), dtype=torch.bfloat16, device=dev)
        return leaf

    def norm(*stack):
        return {"g": torch.ones((*stack, D), dtype=torch.bfloat16, device=dev)}

    p: Params = {"embed": {"w": _normal(g, (V, D), 0.02, dev)},
                 "final_norm": norm()}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": _normal(g, (D, V), 1.0 / math.sqrt(D), dev)}
    attn = {"wq": lin(D, cfg.q_dim, cfg.qkv_bias),
            "wk": lin(D, cfg.kv_dim, cfg.qkv_bias),
            "wv": lin(D, cfg.kv_dim, cfg.qkv_bias), "wo": lin(cfg.q_dim, D)}
    if cfg.qk_norm:
        attn["q_norm"] = {"g": torch.ones((L, cfg.head_dim), dtype=torch.bfloat16,
                                          device=dev)}
        attn["k_norm"] = {"g": torch.ones((L, cfg.head_dim), dtype=torch.bfloat16,
                                          device=dev)}
    ffn_p = {"wi": lin(D, cfg.d_ff), "wo": lin(cfg.d_ff, D)}
    if cfg.ffn_gated:
        ffn_p["wg"] = lin(D, cfg.d_ff)
    p["blocks"] = {"ln1": norm(L), "attn": attn, "ln2": norm(L), "ffn": ffn_p}
    return p


def layer_blocks(p: Params) -> list[Params]:
    """Per-layer block dicts: the bound list as is, or views into the stacked
    leaves."""
    blocks = p["blocks"]
    if isinstance(blocks, list):
        return blocks

    def index(node, i):
        if isinstance(node, dict):
            return {k: index(v, i) for k, v in node.items()}
        return node[i]

    n = len(blocks["ln1"]["g"])
    return [index(blocks, i) for i in range(n)]


def lm_head_w(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"]["w"].T if cfg.tie_embeddings else p["lm_head"]["w"]


def embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = p["embed"]["w"][tokens]  # [B, S, D]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def _attn_block(blk: Params, x: torch.Tensor, cfg: ModelConfig, positions,
                window: int) -> torch.Tensor:
    hn = rms_norm(blk["ln1"], x, offset=cfg.rmsnorm_offset)
    x = x + attention(blk["attn"], hn, cfg, positions=positions, window=window)
    hn = rms_norm(blk["ln2"], x, offset=cfg.rmsnorm_offset)
    return x + ffn(blk["ffn"], hn, cfg)


def _attn_trunk(p: Params, cfg: ModelConfig, h: torch.Tensor, positions,
                window: int) -> torch.Tensor:
    for blk in layer_blocks(p):
        h = _attn_block(blk, h, cfg, positions, window)
    return h


def forward(p: Params, cfg: ModelConfig, batch: dict, *,
            window: int | None = None):
    """Training/prefill trunk → (hidden [B, S, D], aux_loss)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    win = cfg.window if window is None else window
    h = embed_tokens(p, cfg, tokens)
    h = _attn_trunk(p, cfg, h, positions, win)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset), aux
