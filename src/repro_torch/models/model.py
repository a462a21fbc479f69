"""Top-level model API of the attention family (dense, and MoE with an
expert FFN on every layer): init and the forward trunk.

Parameters keep the reference layout: a nested dict whose per-layer leaves
are stacked on a leading layer axis (``p["blocks"]``), so trees convert
leaf for leaf (``repro_torch.convert``).  The reference's scan over that
axis is a loop over the layers here; ``p["blocks"]`` may also be a list of
per-layer dicts (the bound serving form, ``decode.bind_serving_weights``).
An MoE block carries ``"moe"`` in place of ``"ffn"``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, ffn, init_moe, moe_ffn,
                                       rms_norm)

Params = dict[str, Any]


def _normal(g: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.bfloat16,
                       device=device) * scale


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations the port does not build yet."""
    if cfg.block_pattern != "attn" or cfg.is_encdec:
        raise NotImplementedError(
            f"the port serves the attention family; {cfg.name} "
            f"(block_pattern={cfg.block_pattern}) is not ported yet")
    if cfg.n_experts and cfg.moe_every > 1:
        raise NotImplementedError(
            f"{cfg.name} interleaves dense and MoE layers (moe_every="
            f"{cfg.moe_every}, the dense_blocks stack), which needs "
            f"whole-prompt admission: not ported yet (a later slice brings "
            f"the dense_blocks interleave with prefill_into_slot)")


def init_top(cfg: ModelConfig, generator: torch.Generator,
             device: str | torch.device = "cuda") -> Params:
    """The parameters outside the layer stack (embedding, final norm, LM
    head), drawn from ``generator`` first."""
    g, dev = generator, torch.device(device)
    D, V = cfg.d_model, cfg.padded_vocab
    p: Params = {"embed": {"w": _normal(g, (V, D), 0.02, dev)},
                 "final_norm": {"g": torch.ones((D,), dtype=torch.bfloat16,
                                                device=dev)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": _normal(g, (D, V), 1.0 / math.sqrt(D), dev)}
    return p


def init_layer(cfg: ModelConfig, generator: torch.Generator,
               device: str | torch.device = "cuda") -> Params:
    """One layer's block parameters (no layer axis), drawn from
    ``generator`` in a fixed order: attention, then the FFN or the MoE."""
    g, dev = generator, torch.device(device)
    D = cfg.d_model

    def lin(d_in, d_out, bias=False):
        leaf = {"w": _normal(g, (d_in, d_out), 1.0 / math.sqrt(d_in), dev)}
        if bias:
            leaf["b"] = torch.zeros((d_out,), dtype=torch.bfloat16, device=dev)
        return leaf

    def ones(n):
        return {"g": torch.ones((n,), dtype=torch.bfloat16, device=dev)}

    attn = {"wq": lin(D, cfg.q_dim, cfg.qkv_bias),
            "wk": lin(D, cfg.kv_dim, cfg.qkv_bias),
            "wv": lin(D, cfg.kv_dim, cfg.qkv_bias), "wo": lin(cfg.q_dim, D)}
    if cfg.qk_norm:
        attn["q_norm"] = ones(cfg.head_dim)
        attn["k_norm"] = ones(cfg.head_dim)
    blk = {"ln1": ones(D), "attn": attn, "ln2": ones(D)}
    if cfg.n_experts:
        blk["moe"] = init_moe(g, cfg, dev)
    else:
        blk["ffn"] = {"wi": lin(D, cfg.d_ff), "wo": lin(cfg.d_ff, D)}
        if cfg.ffn_gated:
            blk["ffn"]["wg"] = lin(D, cfg.d_ff)
    return blk


def stack_layers(layers: list[Params]) -> Params:
    """Per-layer dicts → one dict whose leaves carry a leading layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in layers])
                for k in first}
    return torch.stack(layers)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random attention-family parameters, drawn from ``generator`` directly
    on ``device`` (the generator must live on that device), in the
    reference's shapes, dtypes and scales: :func:`init_top`, then
    :func:`init_layer` for each layer, stacked.
    ``decode.init_serving_params`` makes the same draws layer by layer."""
    check_supported(cfg)
    p = init_top(cfg, generator, device)
    p["blocks"] = stack_layers([init_layer(cfg, generator, device)
                                for _ in range(cfg.n_layers)])
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


def block_ffn(blk: Params, x: torch.Tensor, cfg: ModelConfig):
    """The block's feed-forward half: ``(out, aux_loss)`` of its MoE, or of
    its dense FFN with a zero aux loss."""
    if "moe" in blk:
        return moe_ffn(blk["moe"], x, cfg)
    return ffn(blk["ffn"], x, cfg), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def _attn_block(blk: Params, x: torch.Tensor, cfg: ModelConfig, positions,
                window: int):
    """One block → ``(x, aux_loss)``, as the reference's."""
    hn = rms_norm(blk["ln1"], x, offset=cfg.rmsnorm_offset)
    x = x + attention(blk["attn"], hn, cfg, positions=positions, window=window)
    hn = rms_norm(blk["ln2"], x, offset=cfg.rmsnorm_offset)
    f, aux = block_ffn(blk, hn, cfg)
    return x + f, aux


def _attn_trunk(p: Params, cfg: ModelConfig, h: torch.Tensor, positions,
                window: int):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for blk in layer_blocks(p):
        h, a = _attn_block(blk, h, cfg, positions, window)
        aux = aux + a
    return h, aux


def forward(p: Params, cfg: ModelConfig, batch: dict, *,
            window: int | None = None):
    """Training/prefill trunk → (hidden [B, S, D], aux_loss)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    win = cfg.window if window is None else window
    h = embed_tokens(p, cfg, tokens)
    h, aux = _attn_trunk(p, cfg, h, positions, win)
    return rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset), aux
