"""Top-level model API: init and the forward trunk of the families the
port serves.

  * ``attn``: dense and MoE (an expert FFN on every layer) decoder-only LMs;
  * ``zamba2``: a Mamba2 backbone with one shared attention block applied
    after every ``attn_every`` Mamba2 layers;
  * ``xlstm``: alternating mLSTM / sLSTM blocks.

Parameters keep the reference layout: a nested dict whose per-layer leaves
are stacked on a leading layer axis (``p["blocks"]``; zamba2's
``p["mamba_blocks"]`` beside the unstacked ``p["shared_attn"]``; xlstm's
``p["mlstm_blocks"]`` and ``p["slstm_blocks"]``), so trees convert leaf for
leaf (``repro_torch.convert``).  The reference's scan over that axis is a
loop over the layers here; a stack may also be a list of per-layer dicts
(the bound serving form, ``decode.bind_serving_weights``).  An MoE block
carries ``"moe"`` in place of ``"ffn"``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import ssm, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, ffn, init_moe, moe_ffn,
                                       rms_norm)

Params = dict[str, Any]


def _normal(g: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.bfloat16,
                       device=device) * scale


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations the port does not build yet."""
    if cfg.block_pattern not in ("attn", "zamba2", "xlstm") or \
            cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"the port serves the attention, zamba2 and xlstm families; "
            f"{cfg.name} (block_pattern={cfg.block_pattern}, frontend="
            f"{cfg.frontend}, encoder layers {cfg.enc_layers}) is not ported "
            f"yet")
    if cfg.n_experts and cfg.moe_every > 1:
        raise NotImplementedError(
            f"{cfg.name} interleaves dense and MoE layers (moe_every="
            f"{cfg.moe_every}, the dense_blocks stack): not ported yet (a "
            f"later slice brings the dense_blocks interleave)")


def layer_stacks(cfg: ModelConfig) -> dict[str, int]:
    """The stacked entries of ``cfg``'s parameter tree and their depths."""
    if cfg.block_pattern == "zamba2":
        return {"mamba_blocks": cfg.n_layers}
    if cfg.block_pattern == "xlstm":
        half = cfg.n_layers // 2
        return {"mlstm_blocks": half, "slstm_blocks": half}
    return {"blocks": cfg.n_layers}


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


def _ones(n: int, dev) -> Params:
    return {"g": torch.ones((n,), dtype=torch.bfloat16, device=dev)}


def _init_attn_block(cfg: ModelConfig, g: torch.Generator, dev) -> Params:
    """An attention block: attention, then the FFN or the MoE."""
    D = cfg.d_model

    def lin(d_in, d_out, bias=False):
        leaf = {"w": _normal(g, (d_in, d_out), 1.0 / math.sqrt(d_in), dev)}
        if bias:
            leaf["b"] = torch.zeros((d_out,), dtype=torch.bfloat16, device=dev)
        return leaf

    attn = {"wq": lin(D, cfg.q_dim, cfg.qkv_bias),
            "wk": lin(D, cfg.kv_dim, cfg.qkv_bias),
            "wv": lin(D, cfg.kv_dim, cfg.qkv_bias), "wo": lin(cfg.q_dim, D)}
    if cfg.qk_norm:
        attn["q_norm"] = _ones(cfg.head_dim, dev)
        attn["k_norm"] = _ones(cfg.head_dim, dev)
    blk = {"ln1": _ones(D, dev), "attn": attn, "ln2": _ones(D, dev)}
    if cfg.n_experts:
        blk["moe"] = init_moe(g, cfg, dev)
    else:
        blk["ffn"] = {"wi": lin(D, cfg.d_ff), "wo": lin(cfg.d_ff, D)}
        if cfg.ffn_gated:
            blk["ffn"]["wg"] = lin(D, cfg.d_ff)
    return blk


def init_layer(cfg: ModelConfig, generator: torch.Generator,
               device: str | torch.device = "cuda",
               stack: str = "blocks") -> Params:
    """One layer of the stack ``stack`` (no layer axis), drawn from
    ``generator`` in a fixed order: an attention block (attention, then the
    FFN or the MoE), a Mamba2 layer (its norm, then its mixer) or an
    mLSTM/sLSTM layer (its norm, then its cell)."""
    g, dev = generator, torch.device(device)
    if stack == "blocks":
        return _init_attn_block(cfg, g, dev)
    ln = _ones(cfg.d_model, dev)
    if stack == "mamba_blocks":
        return {"ln": ln, "mixer": ssm.init_mamba2(g, cfg, dev)}
    if stack == "mlstm_blocks":
        return {"ln": ln, "cell": xlstm.init_mlstm(g, cfg, dev)}
    if stack == "slstm_blocks":
        return {"ln": ln, "cell": xlstm.init_slstm(g, cfg, dev)}
    raise KeyError(stack)


def init_shared(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """zamba2's shared attention+FFN block (one, unstacked), drawn after
    the Mamba2 stack as the reference draws it."""
    return _init_attn_block(cfg, generator, torch.device(device))


def stack_layers(layers: list[Params]) -> Params:
    """Per-layer dicts → one dict whose leaves carry a leading layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in layers])
                for k in first}
    return torch.stack(layers)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters, drawn from ``generator`` directly on ``device``
    (the generator must live on that device), in the reference's shapes,
    dtypes and scales: :func:`init_top`, then :func:`init_layer` for each
    layer of each stack, stacked, then zamba2's :func:`init_shared`.
    ``decode.init_serving_params`` makes the same draws layer by layer."""
    check_supported(cfg)
    p = init_top(cfg, generator, device)
    for name, depth in layer_stacks(cfg).items():
        p[name] = stack_layers([init_layer(cfg, generator, device, name)
                                for _ in range(depth)])
    if cfg.block_pattern == "zamba2":
        p["shared_attn"] = init_shared(cfg, generator, device)
    return p


def layer_blocks(p: Params, stack: str = "blocks") -> list[Params]:
    """Per-layer dicts of the stack ``stack``: the bound list as is, or
    views into the stacked leaves."""
    blocks = p[stack]
    if isinstance(blocks, list):
        return blocks

    def index(node, i):
        if isinstance(node, dict):
            return {k: index(v, i) for k, v in node.items()}
        return node[i]

    node = blocks
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return [index(blocks, i) for i in range(node.shape[0])]


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
    """Training/prefill trunk of the attention family → (hidden [B, S, D],
    aux_loss).  The recurrent families run through ``decode.prefill`` and
    ``decode.decode_step`` only (their training trunk is not ported)."""
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"forward() covers the attention family; {cfg.name} "
            f"(block_pattern={cfg.block_pattern}) serves through "
            f"decode.prefill and decode_step")
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    win = cfg.window if window is None else window
    h = embed_tokens(p, cfg, tokens)
    h, aux = _attn_trunk(p, cfg, h, positions, win)
    return rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset), aux
