"""Serving-side paths of the attention family (dense, and MoE with an
expert FFN on every layer): ternary weight packing, the KV ring cache,
prefill (whole and chunked) and single-token decode.

``quantize_for_serving`` turns trained parameters into the deployment
artifact: every ternary projection becomes ``{"packed": uint8 base-3 (1.6
b/w, rows padded to 128 bytes), "scale": absmean}``, byte for byte what the
reference writes; an expert stack keeps one scale per expert.
``init_serving_params`` builds the same artifact from a seed one layer at a
time, so a model whose bf16 tree does not fit the card still serves.  Every
cache writer keeps one ring invariant: position ``p`` lives at slot ``p %
CL`` (:func:`_ring_slot`); a negative position (a dead scheduler row, a
padded chunk tail) writes nothing.

Unlike the reference's functional updates, the chunk and decode steps write
their KV and positions into the cache tensors in place (the cache dict they
return holds the same tensors): a serving step then never copies the cache.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from repro_torch.core import encoding
from repro_torch.core.quantization import ternarize
from repro_torch.kernels.dispatch import GroupedTernaryWeight, TernaryWeight
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (append_attention, attention,
                                       mask_padded_vocab, moe_capacity,
                                       rms_norm)
from repro_torch.models.model import (Params, block_ffn, check_supported,
                                      embed_tokens, init_layer, init_top,
                                      layer_blocks, lm_head_w, stack_layers)

logger = logging.getLogger(__name__)

#: leaf-dict keys (within their parent block) that carry ternary weights
TERNARY_KEYS = {"wq", "wk", "wv", "wo", "wi", "wg", "up", "down", "wz", "wx",
                "ffn_up", "ffn_down"}
#: parent keys whose children must stay fp regardless
FP_PARENTS = {"router"}
#: top-level entries that stay fp
FP_TOP = {"embed", "lm_head"}


def _pack_matrix(w: torch.Tensor):
    """One ``[din, dout]`` matrix → (base-3 bytes ``[dout, ceil(din/5)]``
    with the rows padded to a multiple of 128 bytes, bf16 absmean scale).
    The padding bytes decode past the logical width, where the kernels
    never read."""
    w_t, scale = ternarize(w)
    packed = encoding.pad_rows(encoding.pack_base3(w_t.T),
                               encoding.PACKED_ROW_BYTES)
    return packed, scale.to(torch.bfloat16)


def _pack_leaf(leaf: dict) -> dict:
    """``{"w": [..., din, dout]}`` → ``{"packed": [..., dout, nb], "scale":
    [...]}``: one absmean scale per ``[din, dout]`` matrix, so a stacked
    leaf ``[L, din, dout]`` gets per-layer scales and an expert stack
    ``[L, E, din, dout]`` per-expert ones (the reference's per-layer and
    per-expert scales).  Every matrix is packed on its own, so a layer
    packs to the same bytes alone (``init_serving_params``) as inside its
    stack."""
    w = leaf["w"]
    lead = w.shape[:-2]
    parts = [_pack_matrix(m) for m in w.reshape(-1, *w.shape[-2:])]
    packed = torch.stack([pk for pk, _ in parts])
    scale = torch.stack([sc for _, sc in parts])
    out = {"packed": packed.reshape(*lead, *packed.shape[1:]),
           "scale": scale.reshape(lead)}
    if "b" in leaf:
        out["b"] = leaf["b"]
    return out


def quantize_for_serving(p: Params, cfg: ModelConfig) -> Params:
    """Training params → packed-ternary serving params (the MoE router, the
    embedding and the LM head stay float)."""

    def walk(node, key_path):
        if isinstance(node, dict):
            if "w" in node and key_path and key_path[-1] in TERNARY_KEYS \
                    and not (set(key_path) & (FP_PARENTS | FP_TOP)):
                return _pack_leaf(node)
            return {k: walk(v, key_path + (k,)) for k, v in node.items()}
        return node

    return walk(p, ())


def init_serving_params(cfg: ModelConfig, generator: torch.Generator,
                        device: str | torch.device = "cuda") -> Params:
    """``quantize_for_serving(init_params(cfg, generator, device), cfg)``
    without ever holding the bf16 tree: the same draws, one layer at a
    time, each layer packed and its bf16 weights freed before the next is
    drawn.  Absmean scales are per layer (per expert in MoE stacks), so the
    result is the same, byte for byte.  Peak memory is the packed tree plus
    one layer's bf16 weights and its packing temporaries."""
    check_supported(cfg)
    p = init_top(cfg, generator, device)
    layers = [quantize_for_serving(init_layer(cfg, generator, device), cfg)
              for _ in range(cfg.n_layers)]
    p["blocks"] = stack_layers(layers)
    return p


def packed_bits_per_weight(p: Params) -> float:
    """Measured storage density of the serving artifact (≈1.6 b/w; the
    128-byte row padding counts as stored)."""
    bits = weights = 0

    def walk(node):
        nonlocal bits, weights
        if isinstance(node, dict):
            if "packed" in node:
                bits += node["packed"].numel() * 8
                weights += node["packed"].numel() * encoding.TRITS_PER_BYTE
            else:
                for v in node.values():
                    walk(v)

    walk(p)
    return bits / max(weights, 1)


def _logical_k(cfg: ModelConfig, path: tuple) -> int:
    """In-features of the packed projection at ``path`` in a block (the
    packed rows are padded past it)."""
    if path[-1] != "wo":
        return cfg.d_model
    return cfg.q_dim if path[-2] == "attn" else cfg.d_ff


def bind_serving_weights(p: Params, cfg: ModelConfig) -> Params:
    """The serving tree with ``p["blocks"]`` split into per-layer dicts whose
    packed leaves carry a bound :class:`TernaryWeight` under ``"tw"``, or,
    for MoE expert stacks, a :class:`GroupedTernaryWeight` under ``"gw"``,
    so each kernel's weight encoding is derived once and reused by every
    step.  The input tree is not modified."""
    def bind(node, path):
        if isinstance(node, dict):
            if "packed" in node:
                k = _logical_k(cfg, path)
                if path[-2] == "moe":
                    return dict(node, gw=GroupedTernaryWeight.from_packed(
                        node["packed"], node["scale"], k, mu=cfg.mu))
                return dict(node, tw=TernaryWeight.from_packed(
                    node["packed"], node["scale"], k, mu=cfg.mu))
            return {key: bind(v, path + (key,)) for key, v in node.items()}
        return node

    return dict(p, blocks=[bind(b, ()) for b in layer_blocks(p)])


def layer_matmul_problems(cfg: ModelConfig, batch_size: int,
                          seq_len: int = 1
                          ) -> list[tuple[str, int, int, int]]:
    """Role-tagged dense matmul problems ``(role, M, K, N)`` one forward
    step issues through ``dispatch.ternary_matmul``, ``M = batch_size ·
    seq_len``.  ``role`` is the projection's parameter-leaf name; roles that
    dispatch identically (``wk``/``wv``, ``wi``/``wg``) are listed once.

    The port's copy covers the attention projections and the ``d_ff`` /
    ``dense_ff`` feed-forwards; the mamba2/zamba2 and xlstm projections come
    with those families, and asking for them raises.  As in the reference,
    an MoE config lists its ``d_ff`` problems too, though its expert
    matmuls dispatch as grouped problems
    (:func:`layer_grouped_matmul_problems`) and no dense projection of it
    has those shapes."""
    if cfg.block_pattern not in ("attn",):
        raise NotImplementedError(
            f"layer_matmul_problems: the {cfg.block_pattern!r} block pattern "
            f"is not ported yet")
    M = batch_size * seq_len
    d = cfg.d_model
    probs: set[tuple[str, int, int, int]] = set()

    def proj(role, k, n):
        if k and n:
            probs.add((role, M, int(k), int(n)))

    proj("wq", d, cfg.q_dim)
    proj("wk", d, cfg.kv_dim)
    proj("wo", cfg.q_dim, d)
    if cfg.d_ff:
        proj("wi", d, cfg.d_ff)          # wi / wg
        proj("wo", cfg.d_ff, d)
    if cfg.dense_ff:
        proj("wi", d, cfg.dense_ff)
        proj("wo", cfg.dense_ff, d)
    return sorted(probs)


def layer_matmul_shapes(cfg: ModelConfig, batch_size: int,
                        seq_len: int = 1) -> list[tuple[int, int, int]]:
    """The distinct ternary-matmul problems ``(M, K, N)`` of one forward
    step (:func:`layer_matmul_problems` without the roles): the shape
    universe that :func:`repro_torch.kernels.dispatch.autotune` measures so
    serving dispatches on measurements instead of the prior."""
    return sorted({(m, k, n)
                   for _, m, k, n in layer_matmul_problems(cfg, batch_size,
                                                           seq_len)})


def layer_grouped_matmul_problems(cfg: ModelConfig, batch_size: int,
                                  seq_len: int = 1
                                  ) -> list[tuple[str, int, int, int, int]]:
    """Role-tagged grouped (MoE expert) problems ``(role, E, C, K, N)`` one
    forward step issues through ``dispatch.grouped_ternary_matmul``, ``C``
    the step's per-expert capacity; empty for configs without experts."""
    if not cfg.n_experts:
        return []
    E = cfg.n_experts
    cap = moe_capacity(cfg, batch_size * seq_len)
    d, f = cfg.d_model, cfg.d_ff
    return sorted({("wi", E, cap, d, f), ("wo", E, cap, f, d)})


def layer_grouped_matmul_shapes(cfg: ModelConfig, batch_size: int,
                                seq_len: int = 1
                                ) -> list[tuple[int, int, int, int]]:
    """The distinct grouped problems ``(E, C, K, N)`` of one forward step
    (:func:`layer_grouped_matmul_problems` without the roles): the expert
    stacks (``wi``/``wg``: ``K = d_model``, ``N = d_ff``; ``wo`` reversed)
    at the step's capacity."""
    return sorted({(e, c, k, n)
                   for _, e, c, k, n in layer_grouped_matmul_problems(
                       cfg, batch_size, seq_len)})


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, s_max: int) -> int:
    return min(cfg.window, s_max) if cfg.window else s_max


def init_cache(cfg: ModelConfig, B: int, s_max: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    if cfg.block_pattern != "attn" or cfg.is_encdec:
        raise NotImplementedError(
            f"the port's cache covers the attention family, not "
            f"{cfg.block_pattern}")
    CL = cache_len(cfg, s_max)
    shape = (cfg.n_layers, B, CL, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            # per-row slot positions (-1 = empty slot)
            "pos": torch.full((cfg.n_layers, B, CL), -1, dtype=torch.int32,
                              device=device)}


def _ring_slot(cfg: ModelConfig, CL: int, index: torch.Tensor) -> torch.Tensor:
    """Canonical ring slot: position ``p`` lives at ``p % CL`` when a window
    makes the cache a ring, at ``p`` otherwise; negative positions map to
    ``CL`` (one past the end), which every writer drops."""
    index = index.to(torch.int32)
    slot = index % CL if (cfg.window and CL) else index
    return torch.where(index >= 0, slot, CL)


def _scatter_rows(cache: dict, slot: torch.Tensor, positions: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Write ``[L, B, S, ...]`` fresh KV and the positions at ``slot``
    ``[B, S]`` in place; entries whose slot is out of range drop."""
    CL = cache["pos"].shape[-1]
    B, S = slot.shape
    rows = torch.arange(B, device=slot.device)[:, None].expand(B, S)
    keep = (slot >= 0) & (slot < CL)
    r, s = rows[keep], slot[keep].long()
    cache["k"][:, r, s] = k_new[:, keep].to(cache["k"].dtype)
    cache["v"][:, r, s] = v_new[:, keep].to(cache["v"].dtype)
    cache["pos"][:, r, s] = positions.to(torch.int32)[keep]
    return cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _pad_kv_to(k: torch.Tensor, CL: int) -> torch.Tensor:
    """[L?, B, S, H, hd] → CL slots honouring the ring invariant (S >= CL
    keeps the last CL keys, rolled so position p sits at slot p % CL)."""
    S = k.shape[-3]
    if S >= CL:
        k = k[..., S - CL:, :, :]
        shift = S % CL
        return torch.roll(k, shift, dims=k.ndim - 3) if shift else k
    return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, CL - S))


def _prefill_positions(S: int, CL: int, device=None) -> torch.Tensor:
    """Per-slot positions matching :func:`_pad_kv_to` (-1 = empty)."""
    pos = torch.arange(S, dtype=torch.int32, device=device)
    if S >= CL:
        return torch.roll(pos[S - CL:], S % CL)
    return torch.cat([pos, torch.full((CL - S,), -1, dtype=torch.int32,
                                      device=device)])


def _final_logits(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """[B, D] final hidden → masked f32 logits [B, V]."""
    return mask_padded_vocab((h @ lm_head_w(p, cfg)).to(torch.float32),
                             cfg.vocab_size)


def prefill(p: Params, cfg: ModelConfig, batch: dict, s_max: int):
    """Run the full prompt once; return (cache, last-position logits)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    CL = cache_len(cfg, s_max)
    if not cfg.window and S > CL:
        raise ValueError(
            f"prompt length {S} exceeds cache length {CL} (s_max) for a "
            f"non-windowed config; raise s_max/max_len instead of relying on "
            f"silent truncation")
    dev = tokens.device
    cache = init_cache(cfg, B, CL if cfg.window else s_max, device=dev)
    positions = torch.arange(S, device=dev)
    x = embed_tokens(p, cfg, tokens)
    ks, vs = [], []
    for blk in layer_blocks(p):
        hn = rms_norm(blk["ln1"], x, offset=cfg.rmsnorm_offset)
        a, (k, v) = attention(blk["attn"], hn, cfg, positions=positions,
                              window=cfg.window, return_kv=True)
        x = x + a
        x = x + block_ffn(blk, rms_norm(blk["ln2"], x,
                                        offset=cfg.rmsnorm_offset), cfg)[0]
        ks.append(k)
        vs.append(v)
    x = rms_norm(p["final_norm"], x, offset=cfg.rmsnorm_offset)
    cache["k"] = _pad_kv_to(torch.stack(ks), CL).to(cache["k"].dtype)
    cache["v"] = _pad_kv_to(torch.stack(vs), CL).to(cache["v"].dtype)
    cache["pos"] = _prefill_positions(S, CL, dev).expand_as(cache["pos"]).clone()
    return cache, _final_logits(p, cfg, x[:, -1])


def supports_chunked_prefill(p: Params, cfg: ModelConfig) -> bool:
    """Whether :func:`prefill_chunk` covers this (params, config): a uniform
    stack of attention blocks whose only cross-chunk state is the KV ring."""
    reason = None
    if cfg.block_pattern != "attn":
        reason = f"block_pattern={cfg.block_pattern!r} carries recurrent state"
    elif cfg.is_encdec:
        reason = "encoder-decoder stacks prefill the encoder whole"
    elif cfg.frontend != "none":
        reason = f"modality frontend {cfg.frontend!r} feeds prefix embeds"
    elif "dense_blocks" in p:
        reason = "interleaved-MoE (dense_blocks) stack is not uniform"
    if reason is not None:
        logger.debug("chunked prefill unsupported for %s: %s", cfg.name, reason)
        return False
    return True


def _chunk_forward(p: Params, cfg: ModelConfig, cache: dict,
                   tokens: torch.Tensor, positions: torch.Tensor):
    """Run a ``[B, C]`` chunk at per-row absolute ``positions`` through the
    stack, attending the already-written ring (read-only) plus the chunk
    itself, then write the chunk's KV at ``p % CL`` (positions of -1 neither
    write nor match a query).  Returns ``(cache, h [B, C, D])``, ``h``
    final-normed."""
    if not supports_chunked_prefill(p, cfg):
        raise NotImplementedError(
            f"chunked prefill not supported for {cfg.name} "
            f"(block_pattern={cfg.block_pattern}); use prefill()")
    B, C = tokens.shape
    CL = cache["pos"].shape[-1]
    if cfg.window and C > CL:
        raise ValueError(
            f"chunk size {C} exceeds ring length {CL}: a single chunk would "
            f"collide with itself in the ring; use chunks <= the window")
    positions = positions.to(torch.int32)
    slot = _ring_slot(cfg, CL, positions)
    h = embed_tokens(p, cfg, tokens)
    old_pos = cache["pos"][0].clone()  # [B, CL] pre-chunk positions
    ks, vs = [], []
    for i, blk in enumerate(layer_blocks(p)):
        hn = rms_norm(blk["ln1"], h, offset=cfg.rmsnorm_offset)
        a, (k, v) = append_attention(blk["attn"], hn, cfg, positions=positions,
                                     cache_k=cache["k"][i], cache_v=cache["v"][i],
                                     k_positions=old_pos, window=cfg.window)
        h = h + a
        h = h + block_ffn(blk, rms_norm(blk["ln2"], h,
                                        offset=cfg.rmsnorm_offset), cfg)[0]
        ks.append(k)
        vs.append(v)
    cache = _scatter_rows(cache, slot, positions, torch.stack(ks), torch.stack(vs))
    return cache, rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset)


def prefill_chunk(p: Params, cfg: ModelConfig, cache: dict,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  take: int | None = None):
    """Advance a prefill by one fixed-size chunk.

    tokens: [B, C]; positions: int32 [B, C] absolute, -1 on the padded tail;
    ``take``: index into the chunk whose logits to return (default C-1).
    Returns (cache, logits [B, V])."""
    C = tokens.shape[1]
    take = C - 1 if take is None else take
    cache, h = _chunk_forward(p, cfg, cache, tokens, positions)
    return cache, _final_logits(p, cfg, h[:, take])


def prefill_chunks_of(plen: int, chunk: int) -> list[tuple[int, int]]:
    """Split a prompt of length ``plen`` into ``(start, valid)`` chunks."""
    if plen < 1:
        raise ValueError("empty prompt")
    return [(s, min(chunk, plen - s)) for s in range(0, plen, chunk)]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(p: Params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                index: torch.Tensor):
    """One decode step.  tokens: [B]; index: int32 [B] per-slot positions
    (a scalar broadcasts).  Each row attends, ropes and writes at its own
    position; a row at ``-1`` (dead) writes nothing.
    Returns (logits [B, V], cache)."""
    B = tokens.shape[0]
    index = torch.as_tensor(index, dtype=torch.int32, device=tokens.device)
    if index.ndim == 0:
        index = index.expand(B)
    CL = cache["pos"].shape[-1]
    slot = _ring_slot(cfg, CL, index)
    positions = index[:, None]
    h = embed_tokens(p, cfg, tokens[:, None])
    old_pos = cache["pos"][0].clone()
    ks, vs = [], []
    for i, blk in enumerate(layer_blocks(p)):
        hn = rms_norm(blk["ln1"], h, offset=cfg.rmsnorm_offset)
        a, (k, v) = append_attention(blk["attn"], hn, cfg, positions=positions,
                                     cache_k=cache["k"][i], cache_v=cache["v"][i],
                                     k_positions=old_pos, window=cfg.window)
        h = h + a
        h = h + block_ffn(blk, rms_norm(blk["ln2"], h,
                                        offset=cfg.rmsnorm_offset), cfg)[0]
        ks.append(k)
        vs.append(v)
    cache = _scatter_rows(cache, slot[:, None], positions, torch.stack(ks),
                          torch.stack(vs))
    h = rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset)
    return _final_logits(p, cfg, h[:, 0]), cache
