"""Top-level model API: init and the forward trunk of the families the
port serves.

  * ``attn``: dense and MoE (an expert FFN on every layer) decoder-only LMs;
  * ``zamba2``: a Mamba2 backbone with one shared attention block applied
    after every ``attn_every`` Mamba2 layers;
  * ``xlstm``: alternating mLSTM / sLSTM blocks;
  * encoder-decoder (whisper): an encoder over the ``audio_stub``
    frontend's frame embeddings and a decoder with cross-attention, both
    with sinusoidal positions;
  * the ``vit_stub`` frontend (internvl2) on the attention family: vision
    embeddings overwrite the first prompt positions.

Parameters keep the reference layout: a nested dict whose per-layer leaves
are stacked on a leading layer axis (``p["blocks"]``; zamba2's
``p["mamba_blocks"]`` beside the unstacked ``p["shared_attn"]``; xlstm's
``p["mlstm_blocks"]`` and ``p["slstm_blocks"]``; whisper's
``p["enc_blocks"]`` and ``p["dec_blocks"]`` beside ``p["enc_norm"]``), so
trees convert leaf for
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
from repro_torch.models.layers import (attention, cross_kv, ffn, init_moe,
                                       moe_ffn, rms_norm)

Params = dict[str, Any]


def _normal(g: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.bfloat16,
                       device=device) * scale


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations the port does not build yet."""
    if cfg.block_pattern not in ("attn", "zamba2", "xlstm") or \
            cfg.frontend not in ("none", "audio_stub", "vit_stub") or \
            cfg.is_encdec != (cfg.frontend == "audio_stub"):
        raise NotImplementedError(
            f"the port serves the attention (with whisper's encoder-decoder "
            f"and the vit_stub frontend), zamba2 and xlstm families; "
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
    if cfg.is_encdec:
        return {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.n_layers}
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
    if cfg.is_encdec:
        p["enc_norm"] = _ones(D, dev)
    return p


def _ones(n: int, dev) -> Params:
    return {"g": torch.ones((n,), dtype=torch.bfloat16, device=dev)}


def _lin(g: torch.Generator, d_in: int, d_out: int, dev,
         bias: bool = False) -> Params:
    leaf = {"w": _normal(g, (d_in, d_out), 1.0 / math.sqrt(d_in), dev)}
    if bias:
        leaf["b"] = torch.zeros((d_out,), dtype=torch.bfloat16, device=dev)
    return leaf


def _init_attn(cfg: ModelConfig, g: torch.Generator, dev) -> Params:
    D = cfg.d_model
    attn = {"wq": _lin(g, D, cfg.q_dim, dev, cfg.qkv_bias),
            "wk": _lin(g, D, cfg.kv_dim, dev, cfg.qkv_bias),
            "wv": _lin(g, D, cfg.kv_dim, dev, cfg.qkv_bias),
            "wo": _lin(g, cfg.q_dim, D, dev)}
    if cfg.qk_norm:
        attn["q_norm"] = _ones(cfg.head_dim, dev)
        attn["k_norm"] = _ones(cfg.head_dim, dev)
    return attn


def _init_ffn(cfg: ModelConfig, g: torch.Generator, dev) -> Params:
    D = cfg.d_model
    f = {"wi": _lin(g, D, cfg.d_ff, dev), "wo": _lin(g, cfg.d_ff, D, dev)}
    if cfg.ffn_gated:
        f["wg"] = _lin(g, D, cfg.d_ff, dev)
    return f


def _init_attn_block(cfg: ModelConfig, g: torch.Generator, dev) -> Params:
    """An attention block: attention, then the FFN or the MoE."""
    D = cfg.d_model
    blk = {"ln1": _ones(D, dev), "attn": _init_attn(cfg, g, dev),
           "ln2": _ones(D, dev)}
    if cfg.n_experts:
        blk["moe"] = init_moe(g, cfg, dev)
    else:
        blk["ffn"] = _init_ffn(cfg, g, dev)
    return blk


def init_layer(cfg: ModelConfig, generator: torch.Generator,
               device: str | torch.device = "cuda",
               stack: str = "blocks") -> Params:
    """One layer of the stack ``stack`` (no layer axis), drawn from
    ``generator`` in a fixed order: an attention block (attention, then the
    FFN or the MoE), a whisper encoder block (the same with its FFN), a
    whisper decoder block (self-attention, cross-attention, FFN), a Mamba2
    layer (its norm, then its mixer) or an mLSTM/sLSTM layer (its norm,
    then its cell)."""
    g, dev = generator, torch.device(device)
    if stack in ("blocks", "enc_blocks"):
        return _init_attn_block(cfg, g, dev)
    ln = _ones(cfg.d_model, dev)
    if stack == "dec_blocks":
        return {"ln1": ln, "self_attn": _init_attn(cfg, g, dev),
                "ln2": _ones(cfg.d_model, dev),
                "cross_attn": _init_attn(cfg, g, dev),
                "ln3": _ones(cfg.d_model, dev), "ffn": _init_ffn(cfg, g, dev)}
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


def _const_dtype(h: torch.Tensor) -> torch.dtype:
    """The dtype the model's constants (gemma's embedding scale, whisper's
    position table) are rounded to: the activations', or bf16's for the
    f64 yardstick (``layers.acc_dtype``), which runs the bf16 model's
    constants in f64 arithmetic."""
    return torch.bfloat16 if h.dtype == torch.float64 else h.dtype


def embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings ``[B, S, D]`` (gemma's scaled by sqrt(d_model));
    ``vision_embeds`` ``[B, vision_tokens, D]`` (the ``vit_stub``
    frontend) overwrite positions ``[0, vision_tokens)``."""
    h = p["embed"]["w"][tokens]  # [B, S, D]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=_const_dtype(h)).to(h.dtype)
    if vision_embeds is not None and cfg.vision_tokens:
        n = vision_embeds.shape[1]
        if h.shape[1] < n:
            raise ValueError(
                f"{cfg.name}: a prompt of {h.shape[1]} tokens is shorter "
                f"than the vision_tokens = {n} positions the vision prefix "
                f"overwrites")
        h[:, :n] = vision_embeds.to(h.dtype)
    return h


def _sin_cos(ang: torch.Tensor, D: int) -> torch.Tensor:
    pe = torch.zeros((*ang.shape[:-1], D), dtype=torch.float32,
                     device=ang.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang)
    return pe


def _inv_freq(D: int, device) -> torch.Tensor:
    return torch.exp(-math.log(10_000.0) * torch.arange(
        0, D, 2, dtype=torch.float32, device=device) / D)


def sinusoidal_positions(S: int, D: int, device=None) -> torch.Tensor:
    """The ``[S, D]`` f32 sinusoidal table (f32 angles, as the
    reference's); :func:`with_positions` rounds it once."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    return _sin_cos(pos * _inv_freq(D, device), D)


def sinusoidal_position_at(index: torch.Tensor, D: int) -> torch.Tensor:
    """The f32 sinusoidal embedding at each position of ``index`` (``[B]``
    → ``[B, D]``): a decode step's rows, each at its own position."""
    idx = index.to(torch.float32)
    return _sin_cos(idx[..., None] * _inv_freq(D, index.device), D)


def with_positions(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h`` plus a sinusoidal ``table`` rounded once to the model's
    constant dtype (:func:`_const_dtype`; bf16 for bf16 ``h``, as the
    reference), broadcast over the batch."""
    return h + table.to(_const_dtype(h)).to(h.dtype)


def whisper_encode(p: Params, cfg: ModelConfig,
                   frames: torch.Tensor) -> torch.Tensor:
    """The encoder over ``frames`` [B, enc_seq, D] (the ``audio_stub``
    frontend's precomputed frame embeddings): sinusoidal positions, then
    each block's full (bidirectional, unroped) self-attention and FFN, then
    ``enc_norm``.  Returns [B, enc_seq, D]."""
    S = frames.shape[1]
    h = with_positions(frames, sinusoidal_positions(S, cfg.d_model,
                                                    frames.device)[None])
    positions = torch.arange(S, device=frames.device)
    for blk in layer_blocks(p, "enc_blocks"):
        hn = rms_norm(blk["ln1"], h)
        h = h + attention(blk["attn"], hn, cfg, positions=positions,
                          kind="full", use_rope=False)
        h = h + ffn(blk["ffn"], rms_norm(blk["ln2"], h), cfg)
    return rms_norm(p["enc_norm"], h)


def whisper_cross(blk: Params, x: torch.Tensor, cfg: ModelConfig,
                  positions, kv) -> torch.Tensor:
    """A decoder block's cross-attention half: ``x`` plus the attention of
    its ``ln2``-normed queries over the encoder's keys and values ``kv``
    (every frame valid)."""
    enc_pos = torch.arange(kv[0].shape[1], device=x.device)
    return x + attention(blk["cross_attn"], rms_norm(blk["ln2"], x), cfg,
                         positions=positions, k_positions=enc_pos,
                         kind="full", kv=kv, use_rope=False)


def whisper_dec_block(blk: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions, enc_out: torch.Tensor):
    """One decoder block over the whole sequence ``x`` (training, prefill):
    causal unroped self-attention, cross-attention over ``enc_out``'s keys
    and values, the FFN.  Returns ``(x, (k, v), (cross_k, cross_v))``."""
    a, kv = attention(blk["self_attn"], rms_norm(blk["ln1"], x), cfg,
                      positions=positions, use_rope=False, return_kv=True)
    x = x + a
    ckv = cross_kv(blk["cross_attn"], enc_out, cfg)
    x = whisper_cross(blk, x, cfg, positions, ckv)
    return x + ffn(blk["ffn"], rms_norm(blk["ln3"], x), cfg), kv, ckv


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
    """Training/prefill trunk of the attention family (whisper's
    encoder-decoder with ``batch["frames"]``, a VLM with
    ``batch["vision_embeds"]``) → (hidden [B, S, D], aux_loss).  The
    recurrent families run through ``decode.prefill`` and
    ``decode.decode_step`` only (their training trunk is not ported)."""
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"forward() covers the attention family; {cfg.name} "
            f"(block_pattern={cfg.block_pattern}) serves through "
            f"decode.prefill and decode_step")
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    win = cfg.window if window is None else window
    if cfg.is_encdec:
        enc_out = whisper_encode(p, cfg, batch["frames"])
        h = embed_tokens(p, cfg, tokens)
        h = with_positions(h, sinusoidal_positions(S, cfg.d_model,
                                                   h.device)[None])
        for blk in layer_blocks(p, "dec_blocks"):
            h = whisper_dec_block(blk, h, cfg, positions, enc_out)[0]
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        h = embed_tokens(p, cfg, tokens, batch.get("vision_embeds"))
        h, aux = _attn_trunk(p, cfg, h, positions, win)
    return rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset), aux
