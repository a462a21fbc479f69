"""Top-level model API: init and the forward trunk of the families the
port serves.

  * ``attn``: dense and MoE (an expert FFN on every layer) decoder-only LMs,
    and llama4's interleave (groups of ``moe_every - 1`` dense blocks of
    width ``dense_ff``, then one MoE block with a shared expert);
  * ``zamba2``: a Mamba2 backbone with one shared attention block applied
    after every ``attn_every`` Mamba2 layers;
  * ``xlstm``: alternating mLSTM / sLSTM blocks;
  * encoder-decoder (whisper): an encoder over the ``audio_stub``
    frontend's frame embeddings and a decoder with cross-attention, both
    with sinusoidal positions;
  * the ``vit_stub`` frontend (internvl2) on the attention family: vision
    embeddings overwrite the first prompt positions.

Parameters keep the reference layout: a nested dict whose per-layer leaves
are stacked on a leading layer axis (``p["blocks"]``; llama4's
``p["dense_blocks"]`` and ``p["moe_blocks"]``; zamba2's
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

import functools
import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.models import ssm, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, chunked_ce_loss, cross_kv,
                                       ffn, init_moe, moe_ffn, rms_norm)
from repro_torch.parallel.collectives import (current_mesh, join_last,
                                              sum_disjoint)

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


def layer_stacks(cfg: ModelConfig) -> dict[str, int]:
    """The stacked entries of ``cfg``'s parameter tree and their depths
    (llama4's interleave: ``dense_blocks`` and ``moe_blocks``)."""
    if cfg.n_experts and cfg.moe_every > 1:
        moe = cfg.n_layers // cfg.moe_every
        return {"dense_blocks": cfg.n_layers - moe, "moe_blocks": moe}
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


def _init_ffn(cfg: ModelConfig, g: torch.Generator, dev,
              d_ff: int | None = None) -> Params:
    D, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": _lin(g, D, f, dev), "wo": _lin(g, f, D, dev)}
    if cfg.ffn_gated:
        p["wg"] = _lin(g, D, f, dev)
    return p


def _init_attn_block(cfg: ModelConfig, g: torch.Generator, dev, *,
                     moe: bool, d_ff: int | None = None,
                     expert_leaf=None) -> Params:
    """An attention block: attention, then the MoE or the FFN (of width
    ``d_ff``, default ``cfg.d_ff``)."""
    D = cfg.d_model
    blk = {"ln1": _ones(D, dev), "attn": _init_attn(cfg, g, dev),
           "ln2": _ones(D, dev)}
    if moe:
        blk["moe"] = init_moe(g, cfg, dev, expert_leaf=expert_leaf)
    else:
        blk["ffn"] = _init_ffn(cfg, g, dev, d_ff)
    return blk


def init_layer(cfg: ModelConfig, generator: torch.Generator,
               device: str | torch.device = "cuda",
               stack: str = "blocks", expert_leaf=None) -> Params:
    """One layer of the stack ``stack`` (no layer axis), drawn from
    ``generator`` in a fixed order: an attention block (attention, then the
    FFN or the MoE; llama4's ``dense_blocks`` with an FFN of width
    ``dense_ff``, its ``moe_blocks`` with the MoE), a whisper encoder block
    (the same with its FFN), a whisper decoder block (self-attention,
    cross-attention, FFN), a Mamba2 layer (its norm, then its mixer) or an
    mLSTM/sLSTM layer (its norm, then its cell).  ``expert_leaf`` builds
    each MoE expert stack from its per-expert draws
    (``layers.init_moe``)."""
    g, dev = generator, torch.device(device)
    if stack == "dense_blocks":
        return _init_attn_block(cfg, g, dev, moe=False, d_ff=cfg.dense_ff)
    if stack in ("blocks", "enc_blocks", "moe_blocks"):
        return _init_attn_block(cfg, g, dev, moe=bool(cfg.n_experts),
                                expert_leaf=expert_leaf)
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
    return _init_attn_block(cfg, generator, torch.device(device), moe=False)


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
    frontend) overwrite positions ``[0, vision_tokens)``.  Under a mesh a
    rank's table is its slice: of d_model (an untied table), whose lookups
    the model ranks' columns join; or of the vocab (a tied one), where
    only the rank holding a token's row looks it up, the others give
    zeros, and the disjoint sum joins them exactly."""
    table = p["embed"]["w"]
    if current_mesh() is not None and table.shape[0] < cfg.padded_vocab:
        rows = table.shape[0]
        local = tokens - current_mesh().coord("model") * rows
        mine = (local >= 0) & (local < rows)
        h = torch.where(mine[..., None], table[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        h = sum_disjoint(h)
    else:
        h = join_last(table[tokens], cfg.d_model)  # [B, S, D]
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

    def block(blk, x):
        x = x + attention(blk["attn"], rms_norm(blk["ln1"], x), cfg,
                          positions=positions, kind="full", use_rope=False)
        return x + ffn(blk["ffn"], rms_norm(blk["ln2"], x), cfg)

    block = _maybe_remat(block, cfg)
    for blk in layer_blocks(p, "enc_blocks"):
        h = block(blk, h)
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


def layer_groups(p: Params, cfg: ModelConfig) -> list[list[Params]]:
    """llama4's groups in execution order: each ``moe_every - 1`` blocks of
    ``p["dense_blocks"]``, then one of ``p["moe_blocks"]``."""
    dense, moe = layer_blocks(p, "dense_blocks"), layer_blocks(p, "moe_blocks")
    k = cfg.moe_every - 1
    return [dense[g * k:(g + 1) * k] + [blk] for g, blk in enumerate(moe)]


def attn_layers(p: Params, cfg: ModelConfig) -> list[Params]:
    """The attention family's blocks in execution order, the KV cache's
    layer order: ``p["blocks"]``, or llama4's groups one after another."""
    if "dense_blocks" in p:
        return [blk for grp in layer_groups(p, cfg) for blk in grp]
    return layer_blocks(p)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``) when ``cfg.remat`` is set and autograd
    is recording; ``fn`` itself otherwise."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _attn_trunk(p: Params, cfg: ModelConfig, h: torch.Tensor, positions,
                window: int):
    """The attention stack → ``(h, aux)``, each block rematerialized under
    ``cfg.remat``, and llama4's groups each as a whole as well (as the
    reference: without it every group's MoE dispatch buffers stay live for
    backward)."""
    block = _maybe_remat(
        lambda blk, x: _attn_block(blk, x, cfg, positions, window), cfg)

    def run(blocks, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in blocks:
            x, a = block(blk, x)
            aux = aux + a
        return x, aux

    if "dense_blocks" not in p:
        return run(layer_blocks(p), h)
    group = _maybe_remat(run, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for blocks in layer_groups(p, cfg):
        h, a = group(blocks, h)
        aux = aux + a
    return h, aux


def _zamba2_trunk(p: Params, cfg: ModelConfig, h: torch.Tensor, positions,
                  window: int):
    """zamba2's trunk → ``(h, 0)``: groups of ``attn_every`` pre-normed,
    residual Mamba2 blocks, each group followed by the *shared* attention
    and FFN block (one set of parameters, so the gradients of all its uses
    add up).  Each Mamba2 block and each group is rematerialized under
    ``cfg.remat``, as the reference's."""
    shared = p["shared_attn"]
    mamba = _maybe_remat(lambda blk, x: x + ssm.mamba2_block(
        blk["mixer"], rms_norm(blk["ln"], x), cfg)[0], cfg)

    def group(blocks, x):
        for blk in blocks:
            x = mamba(blk, x)
        hn = rms_norm(shared["ln1"], x)
        x = x + attention(shared["attn"], hn, cfg, positions=positions,
                          window=window)
        return x + ffn(shared["ffn"], rms_norm(shared["ln2"], x), cfg)

    group = _maybe_remat(group, cfg)
    blocks, g = layer_blocks(p, "mamba_blocks"), cfg.attn_every
    for i in range(cfg.n_layers // g):
        h = group(blocks[i * g:(i + 1) * g], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _xlstm_trunk(p: Params, cfg: ModelConfig, h: torch.Tensor):
    """xlstm's trunk → ``(h, 0)``: pairs of a pre-normed, residual mLSTM
    block and sLSTM block, each pair rematerialized under ``cfg.remat``, as
    the reference's."""
    def pair(mblk, sblk, x):
        x = x + xlstm.mlstm_block(mblk["cell"], rms_norm(mblk["ln"], x),
                                  cfg)[0]
        return x + xlstm.slstm_block(sblk["cell"], rms_norm(sblk["ln"], x),
                                     cfg)[0]

    pair = _maybe_remat(pair, cfg)
    for mblk, sblk in zip(layer_blocks(p, "mlstm_blocks"),
                          layer_blocks(p, "slstm_blocks")):
        h = pair(mblk, sblk, h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def forward(p: Params, cfg: ModelConfig, batch: dict, *,
            window: int | None = None):
    """Training/prefill trunk → (hidden [B, S, D], aux_loss) of every
    family: the attention family (llama4's interleave; whisper's
    encoder-decoder with ``batch["frames"]``, a VLM with
    ``batch["vision_embeds"]``), zamba2 and xlstm, each block (and each
    group where the reference's has groups) rematerialized in backward
    under ``cfg.remat``.  Serving runs the same blocks through
    ``decode.prefill`` and ``decode.decode_step``, which keep the
    recurrent states."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    win = cfg.window if window is None else window
    if cfg.is_encdec:
        enc_out = whisper_encode(p, cfg, batch["frames"])
        h = embed_tokens(p, cfg, tokens)
        h = with_positions(h, sinusoidal_positions(S, cfg.d_model,
                                                   h.device)[None])
        block = _maybe_remat(lambda blk, x: whisper_dec_block(
            blk, x, cfg, positions, enc_out)[0], cfg)
        for blk in layer_blocks(p, "dec_blocks"):
            h = block(blk, h)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        h = embed_tokens(p, cfg, tokens, batch.get("vision_embeds"))
        if cfg.block_pattern == "attn":
            h, aux = _attn_trunk(p, cfg, h, positions, win)
        elif cfg.block_pattern == "zamba2":
            h, aux = _zamba2_trunk(p, cfg, h, positions, win)
        elif cfg.block_pattern == "xlstm":
            h, aux = _xlstm_trunk(p, cfg, h)
        else:
            raise ValueError(cfg.block_pattern)
    return rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset), aux


def train_loss(p: Params, cfg: ModelConfig, batch: dict):
    """Next-token CE (+ 0.01 x the MoE aux loss) → ``(total, {"ce", "aux"})``.
    ``batch``: tokens, labels, loss_mask [B, S] (+ whisper's frames, a
    VLM's vision embeddings)."""
    h, aux = forward(p, cfg, batch)
    loss = chunked_ce_loss(h, lm_head_w(p, cfg), batch["labels"],
                           batch["loss_mask"].to(torch.float32),
                           cfg.loss_chunk, vocab=cfg.vocab_size)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}
