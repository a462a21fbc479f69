"""Serving-side paths of the families the port serves (attention, dense
and MoE, llama4's dense/MoE interleave, with whisper's encoder-decoder and
internvl2's vision prefix;
zamba2's Mamba2 + shared attention; xlstm's mLSTM/sLSTM): ternary
weight packing, the KV ring and recurrent-state caches, prefill (whole,
into one slot of a live cache, and chunked for the attention family),
single-token decode, the prefix-cache block extract and splice, and
speculative decoding's batched verify with its KV snapshot and rollback.

``quantize_for_serving`` turns trained parameters into the deployment
artifact: every ternary projection becomes ``{"packed": uint8 base-3 (1.6
b/w, rows padded to 128 bytes), "scale": absmean}``, byte for byte what the
reference writes; an expert stack keeps one scale per expert.
``init_serving_params`` builds the same artifact from a seed one layer at a
time, so a model whose bf16 tree does not fit the card still serves.  Every
cache writer keeps one ring invariant: position ``p`` lives at slot ``p %
CL`` (:func:`_ring_slot`); a negative position (a dead scheduler row, a
padded chunk tail) writes nothing.  Every cache leaf carries the batch on
axis 1 (``[layers, B, ...]``), so one request's row splices into a live
batch leaf by leaf (:func:`splice_rows`).

Unlike the reference's functional updates, the chunk, decode and verify
steps (and the block splice and the rollback) write their KV, positions
and recurrent states into the cache tensors in place (the cache dict they
return holds the same tensors): a serving step then never copies the cache.
As in the reference, a dead row (position -1) of a decode step drops its KV
and position writes but still advances its recurrent states; admission's
splice overwrites them.
"""

from __future__ import annotations

import logging
from contextlib import nullcontext
from typing import Any

import torch

from repro_torch.core import encoding
from repro_torch.core.quantization import ternarize
from repro_torch.kernels.dispatch import (GroupedTernaryWeight, TernaryWeight,
                                          per_position_launches)
from repro_torch.models import ssm, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (acc_dtype, append_attention,
                                       attention, ffn, mask_padded_vocab,
                                       moe_capacity, ring_writes, rms_norm)
from repro_torch.models.model import (Params, attn_layers, block_ffn,
                                      check_supported, embed_tokens,
                                      init_layer, init_shared, init_top,
                                      layer_blocks, layer_stacks, lm_head_w,
                                      sinusoidal_position_at,
                                      sinusoidal_positions, stack_layers,
                                      whisper_cross, whisper_dec_block,
                                      whisper_encode, with_positions)
from repro_torch.parallel.collectives import join_last

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


def _pack_experts(draw, n: int) -> dict:
    """An expert stack packed one expert at a time as ``draw`` makes each
    ``[din, dout]`` matrix: the bytes and per-expert scales of
    :func:`_pack_leaf` on the whole stack, without its bf16 weights."""
    parts = [_pack_matrix(draw()) for _ in range(n)]
    return {"packed": torch.stack([pk for pk, _ in parts]),
            "scale": torch.stack([sc for _, sc in parts])}


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
    drawn, and within an MoE layer each expert packed as it is drawn
    (:func:`_pack_experts`).  Absmean scales are per layer (per expert in
    MoE stacks), so the result is the same, byte for byte.  Peak memory is
    the packed tree plus one layer's weights outside its expert stacks,
    one expert's bf16 matrix and the packing temporaries."""
    check_supported(cfg)
    p = init_top(cfg, generator, device)
    for name, depth in layer_stacks(cfg).items():
        p[name] = stack_layers([
            quantize_for_serving(init_layer(cfg, generator, device, name,
                                            expert_leaf=_pack_experts), cfg)
            for _ in range(depth)])
    if cfg.block_pattern == "zamba2":
        p["shared_attn"] = quantize_for_serving(
            init_shared(cfg, generator, device), cfg)
    return p


def f64_params(p: Params) -> Params:
    """The serving tree ``p`` for the f64 yardstick: its float embedding
    and LM head in f64 (bf16 values, exact), every other leaf shared.  Run
    under ``matmul_policy="fixed:ref"`` with f64 frontend inputs, the
    plain path then computes in f64 end to end: each packed projection
    decodes its trits to f64 (dispatch's ``ref``), every norm, attention
    and recurrence accumulates in f64 (``layers.acc_dtype``), and the
    model's constants keep their bf16 rounding.  Its logits measure how far
    the bf16 model's own roundings carry, with or without the kernels."""
    out = dict(p)
    for name in ("embed", "lm_head"):
        if name in p:
            out[name] = {"w": p[name]["w"].double()}
    return out


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
    """In-features of the packed projection at ``path`` (the layer stack's
    name, then the keys down to the leaf, e.g. ``("dense_blocks", "ffn",
    "wo")``): the packed rows are padded past it, and byte 0 decodes to
    trits, so a wrong width would read padding as weights.  llama4's dense
    blocks have FFNs of width ``dense_ff``; its shared expert and every
    other FFN and expert stack have ``d_ff``."""
    parent, name = path[-2], path[-1]
    d = cfg.d_model
    if parent in ("attn", "self_attn", "cross_attn"):
        return cfg.q_dim if name == "wo" else d
    if parent == "ffn" and path[0] == "dense_blocks":
        return (cfg.dense_ff or cfg.d_ff) if name == "wo" else d
    if parent in ("ffn", "moe", "shared"):
        return cfg.d_ff if name == "wo" else d
    if parent == "mixer":                      # Mamba2: wz, wx | wo
        return ssm.ssm_dims(cfg)[0] if name == "wo" else d
    if parent == "cell":                       # mLSTM / sLSTM
        d_in = xlstm.mlstm_dims(cfg)[0]
        return {"up": d, "wq": d_in, "wk": d_in, "wv": d_in, "down": d_in,
                "ffn_up": d, "ffn_down": xlstm.slstm_up(cfg)}[name]
    raise KeyError(f"no logical width for the projection at {path}")


def bind_serving_weights(p: Params, cfg: ModelConfig) -> Params:
    """The serving tree with each layer stack (``p["blocks"]``, llama4's
    ``dense_blocks`` and ``moe_blocks``, whisper's encoder and decoder
    stacks, or the recurrent families' stacks) split
    into per-layer dicts whose packed
    leaves carry a bound :class:`TernaryWeight` under ``"tw"``, or, for MoE
    expert stacks, a :class:`GroupedTernaryWeight` under ``"gw"``, so each
    kernel's weight encoding is derived once and reused by every step.
    zamba2's shared block is bound once, for all its invocations.  The
    input tree is not modified."""
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

    out = dict(p)
    for name in layer_stacks(cfg):
        out[name] = [bind(b, (name,)) for b in layer_blocks(p, name)]
    if "shared_attn" in p:
        out["shared_attn"] = bind(p["shared_attn"], ("shared_attn",))
    return out


def layer_matmul_problems(cfg: ModelConfig, batch_size: int,
                          seq_len: int = 1
                          ) -> list[tuple[str, int, int, int]]:
    """Role-tagged dense matmul problems ``(role, M, K, N)`` one forward
    step issues through ``dispatch.ternary_matmul``, ``M = batch_size ·
    seq_len``.  ``role`` is the projection's parameter-leaf name; roles that
    dispatch identically (``wk``/``wv``, ``wi``/``wg``, ``wz``/``wx``, the
    mLSTM's ``wq``/``wk``/``wv``) are listed once.  As in the reference, an
    MoE config lists its ``d_ff`` problems too, though its expert matmuls
    dispatch as grouped problems (:func:`layer_grouped_matmul_problems`)
    and no dense projection of it has those shapes."""
    M = batch_size * seq_len
    d = cfg.d_model
    probs: set[tuple[str, int, int, int]] = set()

    def proj(role, k, n):
        if k and n:
            probs.add((role, M, int(k), int(n)))

    if cfg.block_pattern in ("attn", "zamba2") or cfg.is_encdec:
        proj("wq", d, cfg.q_dim)
        proj("wk", d, cfg.kv_dim)
        proj("wo", cfg.q_dim, d)
    if cfg.d_ff:
        proj("wi", d, cfg.d_ff)          # wi / wg
        proj("wo", cfg.d_ff, d)
    if cfg.dense_ff:
        proj("wi", d, cfg.dense_ff)
        proj("wo", cfg.dense_ff, d)
    if cfg.block_pattern in ("zamba2", "mamba2"):
        d_in = ssm.ssm_dims(cfg)[0]
        proj("wz", d, d_in)              # wz / wx
        proj("wo", d_in, d)
    if cfg.block_pattern == "xlstm":
        d_in = xlstm.mlstm_dims(cfg)[0]
        proj("up", d, 2 * d_in)          # mLSTM up
        proj("wq", d_in, d_in)           # mLSTM wq / wk / wv
        proj("down", d_in, d)            # mLSTM down
        up = xlstm.slstm_up(cfg)
        proj("ffn_up", d, 2 * up)        # sLSTM ffn_up
        proj("ffn_down", up, d)          # sLSTM ffn_down
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
               device: str | torch.device = "cuda", mesh=None) -> dict:
    """A fresh cache of ``B`` rows, every leaf ``[layers, B, ...]``: the KV
    ring and its slot positions (-1 = empty) for each attention layer
    (zamba2: one per shared-block invocation; whisper: each decoder
    layer's self-attention, beside its cross-attention keys and values
    ``cross_k``/``cross_v`` ``[L, B, enc_seq, Hkv, hd]``, written once by
    prefill), zamba2's f32 SSM states and conv windows, xlstm's mLSTM
    ``(C, n, m)`` and sLSTM ``(c, n, h, m)`` states at the reference's
    initial values.  With ``mesh`` (the attention family) a rank's slice:
    its rows of the batch and its kv heads, per
    ``sharding.cache_specs(kv_heads=cfg.n_kv_heads)``."""
    CL = cache_len(cfg, s_max)
    f32 = torch.float32
    if mesh is not None:
        from repro_torch.parallel.sharding import cache_specs, local_shape

        if cfg.block_pattern != "attn" or cfg.is_encdec:
            raise NotImplementedError(
                f"a sharded cache covers the attention family, not "
                f"{cfg.name}")
        whole = init_cache(cfg, B, s_max, dtype, "meta")
        specs = cache_specs(whole, mesh, kv_heads=cfg.n_kv_heads)
        # the slot positions follow their rows: the reference keeps them
        # whole and updates every row on every device, a rank here decodes
        # its own rows only
        specs["pos"] = specs["k"][:3]
        fill = {"k": 0, "v": 0, "pos": -1}
        return {name: torch.full(local_shape(leaf.shape, specs[name], mesh),
                                 fill[name], dtype=leaf.dtype, device=device)
                for name, leaf in whole.items()}

    def kv(n):
        shape = (n, B, CL, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                # per-row slot positions (-1 = empty slot)
                "pos": torch.full((n, B, CL), -1, dtype=torch.int32,
                                  device=device)}

    if cfg.is_encdec:
        c = kv(cfg.n_layers)
        shape = (cfg.n_layers, B, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return c
    if cfg.block_pattern == "attn":
        return kv(cfg.n_layers)
    if cfg.block_pattern == "zamba2":
        d_in, H, N = ssm.ssm_dims(cfg)
        c = kv(cfg.n_layers // cfg.attn_every)
        c["ssm"] = torch.zeros((cfg.n_layers, B, H, N, cfg.ssm_head_dim),
                               dtype=f32, device=device)
        c["conv"] = torch.zeros((cfg.n_layers, B, cfg.ssm_conv - 1,
                                 d_in + 2 * N), dtype=dtype, device=device)
        return c
    if cfg.block_pattern == "xlstm":
        _, H, dk = xlstm.mlstm_dims(cfg)
        half, D = cfg.n_layers // 2, cfg.d_model

        def full(shape, value):
            return torch.full(shape, value, dtype=f32, device=device)

        return {"mC": full((half, B, H, dk, dk), 0.0),
                "mn": full((half, B, H, dk), 0.0),
                "mm": full((half, B, H), -1e30),
                "sc": full((half, B, D), 0.0),
                "sn": full((half, B, D), 0.0) + 1e-6,
                "sh": full((half, B, D), 0.0),
                "sm": full((half, B, D), -1e30)}
    raise NotImplementedError(
        f"the port's cache covers the attention, zamba2 and xlstm families, "
        f"not {cfg.block_pattern}")


def splice_rows(cache: dict, slot: int, one: dict) -> dict:
    """Write the single-row cache ``one`` into batch row ``slot`` of
    ``cache``, every leaf, in place; the other rows are untouched."""
    for name, leaf in cache.items():
        leaf[:, slot] = one[name][:, 0].to(leaf.dtype)
    return cache


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
    keep, r, s = ring_writes(slot, cache["pos"].shape[-1])
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
    """[B, D] final hidden → masked f32 logits [B, V] (f64 for the f64
    yardstick); a rank's vocab columns under a mesh are gathered first."""
    logits = join_last((h @ lm_head_w(p, cfg)).to(acc_dtype(h)),
                       cfg.padded_vocab)
    return mask_padded_vocab(logits, cfg.vocab_size)


def min_prompt_len(cfg: ModelConfig) -> int:
    """The shortest prompt :func:`prefill` takes: zamba2's prefill hands
    each Mamba2 layer's last ``ssm_conv - 1`` conv inputs to decode, so it
    needs at least that many tokens (the reference fails below it too, at
    its conv-state reshape); a VLM's vision prefix overwrites the first
    ``vision_tokens`` positions, so it needs as many (the reference fails
    below it in ``dynamic_update_slice``); any other config, one."""
    if cfg.block_pattern == "zamba2":
        return cfg.ssm_conv - 1
    if cfg.frontend == "vit_stub":
        return cfg.vision_tokens
    return 1


def check_prompt_len(cfg: ModelConfig, S: int) -> None:
    """Refuse a prompt shorter than :func:`min_prompt_len` (the padded
    length for a batch of left-padded prompts, as ``run()`` prefills)."""
    if S >= min_prompt_len(cfg):
        return
    if cfg.block_pattern == "zamba2":
        raise ValueError(
            f"{cfg.name}: a prompt of {S} tokens is shorter than the "
            f"ssm_conv - 1 = {cfg.ssm_conv - 1} tokens of conv state a "
            f"Mamba2 prefill leaves for decode")
    raise ValueError(
        f"{cfg.name}: a prompt of {S} tokens is shorter than the "
        f"vision_tokens = {cfg.vision_tokens} positions its vision prefix "
        f"overwrites")


def _shared_block(shared: Params, x: torch.Tensor, cfg: ModelConfig, **kw):
    """zamba2's shared attention+FFN block: ``(x, (k, v))``, the
    attention's fresh k/v; with ``cache_k``/``cache_v`` in ``kw`` it
    attends the read-only ring plus the new token
    (:func:`append_attention`, decode), else the prompt itself."""
    attend = append_attention if "cache_k" in kw else attention
    a, kv = attend(shared["attn"], rms_norm(shared["ln1"], x), cfg, **kw)
    x = x + a
    return x + ffn(shared["ffn"], rms_norm(shared["ln2"], x), cfg), kv


def prefill(p: Params, cfg: ModelConfig, batch: dict, s_max: int):
    """Run the full prompt once; return (cache, last-position logits).
    ``batch`` holds ``tokens`` [B, S] and, for whisper, ``frames`` [B,
    enc_seq, D]; for a VLM, ``vision_embeds`` [B, vision_tokens, D]
    (either stub input zero where a caller has none, as the engine's)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    CL = cache_len(cfg, s_max)
    if not cfg.window and S > CL:
        raise ValueError(
            f"prompt length {S} exceeds cache length {CL} (s_max) for a "
            f"non-windowed config; raise s_max/max_len instead of relying on "
            f"silent truncation")
    check_prompt_len(cfg, S)
    dev = tokens.device
    cache = init_cache(cfg, B, CL if cfg.window else s_max, device=dev)
    positions = torch.arange(S, device=dev)
    x = embed_tokens(p, cfg, tokens, batch.get("vision_embeds"))
    ks, vs = [], []
    if cfg.is_encdec:
        enc_out = whisper_encode(p, cfg, batch["frames"])
        x = with_positions(x, sinusoidal_positions(S, cfg.d_model, dev)[None])
        cks, cvs = [], []
        for blk in layer_blocks(p, "dec_blocks"):
            x, (k, v), (ck, cv) = whisper_dec_block(blk, x, cfg, positions,
                                                    enc_out)
            ks.append(k)
            vs.append(v)
            cks.append(ck)
            cvs.append(cv)
        cache["cross_k"] = torch.stack(cks).to(cache["cross_k"].dtype)
        cache["cross_v"] = torch.stack(cvs).to(cache["cross_v"].dtype)
    elif cfg.block_pattern == "attn":
        for blk in attn_layers(p, cfg):
            hn = rms_norm(blk["ln1"], x, offset=cfg.rmsnorm_offset)
            a, (k, v) = attention(blk["attn"], hn, cfg, positions=positions,
                                  window=cfg.window, return_kv=True)
            x = x + a
            x = x + block_ffn(blk, rms_norm(blk["ln2"], x,
                                            offset=cfg.rmsnorm_offset), cfg)[0]
            ks.append(k)
            vs.append(v)
    elif cfg.block_pattern == "zamba2":
        g = cfg.attn_every
        states, convs = [], []
        for i, blk in enumerate(layer_blocks(p, "mamba_blocks")):
            y, (st, cv) = ssm.mamba2_block(blk["mixer"],
                                           rms_norm(blk["ln"], x), cfg)
            x = x + y
            states.append(st)
            convs.append(cv)
            if (i + 1) % g == 0:
                x, (k, v) = _shared_block(p["shared_attn"], x, cfg,
                                          positions=positions,
                                          window=cfg.window, return_kv=True)
                ks.append(k)
                vs.append(v)
        cache["ssm"] = torch.stack(states)
        cache["conv"] = torch.stack(convs).to(cache["conv"].dtype)
    else:  # xlstm
        names = ("mC", "mn", "mm", "sc", "sn", "sh", "sm")
        states = {n: [] for n in names}
        for mblk, sblk in zip(layer_blocks(p, "mlstm_blocks"),
                              layer_blocks(p, "slstm_blocks")):
            y, mst = xlstm.mlstm_block(mblk["cell"], rms_norm(mblk["ln"], x),
                                       cfg)
            x = x + y
            y, sst = xlstm.slstm_block(sblk["cell"], rms_norm(sblk["ln"], x),
                                       cfg)
            x = x + y
            for n, t in zip(names, mst + sst):
                states[n].append(t)
        cache.update({n: torch.stack(t) for n, t in states.items()})
    if ks:
        cache["k"] = _pad_kv_to(torch.stack(ks), CL).to(cache["k"].dtype)
        cache["v"] = _pad_kv_to(torch.stack(vs), CL).to(cache["v"].dtype)
        cache["pos"] = _prefill_positions(S, CL, dev).expand_as(
            cache["pos"]).clone()
    x = rms_norm(p["final_norm"], x, offset=cfg.rmsnorm_offset)
    return cache, _final_logits(p, cfg, x[:, -1])


def prefill_into_slot(p: Params, cfg: ModelConfig, cache: dict, batch: dict,
                      slot: int, s_max: int):
    """Prefill one request (``batch["tokens"]`` [1, S]) and splice its KV
    and states into batch row ``slot`` of the live ``cache`` in place,
    every leaf (:func:`splice_rows`), leaving every other row untouched.
    Returns ``(cache, logits [V])``, the last prompt position's logits."""
    cache1, logits = prefill(p, cfg, batch, s_max=s_max)
    return splice_rows(cache, slot, cache1), logits[0]


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
                   tokens: torch.Tensor, positions: torch.Tensor,
                   exact: bool = False):
    """Run a ``[B, C]`` chunk at per-row absolute ``positions`` through the
    stack, attending the already-written ring (read-only) plus the chunk
    itself, then write the chunk's KV at ``p % CL`` (positions of -1 neither
    write nor match a query).  Returns ``(cache, h [B, C, D])``, ``h``
    final-normed.

    ``exact`` (dense caches only) switches to the scatter-first form: each
    layer writes the chunk's KV into its own cache slice before attending,
    masked strictly below each query, and the chunk merges self-only, so
    every chunk position attends what a sequential :func:`decode_step` at
    that position would, in the same order (see
    :func:`repro_torch.models.layers.append_attention`).  The projections
    then launch one position at a time
    (:func:`~repro_torch.kernels.dispatch.per_position_launches`) and the
    attention takes each query as a batch row of its own, so every kernel
    and matmul runs at a decode step's row count: on the card their sums'
    order depends on it."""
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
    if exact and cfg.window:
        raise ValueError(
            "exact (scatter-first) chunk forward requires a dense cache: a "
            "wrapped ring would pre-evict in-window keys that earlier chunk "
            "positions still attend")
    positions = positions.to(torch.int32)
    slot = _ring_slot(cfg, CL, positions)
    h = embed_tokens(p, cfg, tokens)
    old_pos = cache["pos"][0].clone()  # [B, CL] pre-chunk positions
    scatter = None
    if exact:
        # queries see their chunk-mates at their slots: the positions go in
        # up front, the KV layer by layer
        scatter = ring_writes(slot, CL)
        keep, r, s = scatter
        old_pos[r, s] = positions[keep]
    ks, vs = [], []
    with per_position_launches() if exact else nullcontext():
        for i, blk in enumerate(layer_blocks(p)):
            hn = rms_norm(blk["ln1"], h, offset=cfg.rmsnorm_offset)
            a, (k, v) = append_attention(
                blk["attn"], hn, cfg, positions=positions,
                cache_k=cache["k"][i], cache_v=cache["v"][i],
                k_positions=old_pos, window=cfg.window, scatter=scatter)
            h = h + a
            h = h + block_ffn(blk, rms_norm(blk["ln2"], h,
                                            offset=cfg.rmsnorm_offset), cfg)[0]
            if not exact:   # exact: the layer wrote its own slice already
                ks.append(k)
                vs.append(v)
    if exact:
        cache["pos"][:, r, s] = positions[keep]
    else:
        cache = _scatter_rows(cache, slot, positions, torch.stack(ks),
                              torch.stack(vs))
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


def _window_positions(start: torch.Tensor, K: int) -> torch.Tensor:
    """Positions ``start[b] .. start[b]+K-1`` per row, the whole row -1
    where ``start[b] < 0`` (-1 + j is a real position for j >= 1, so a
    per-position mask would let a dead row write)."""
    start = start.to(torch.int32)
    j = torch.arange(K, dtype=torch.int32, device=start.device)
    return torch.where(start[:, None] >= 0, start[:, None] + j, -1)


def verify_step(p: Params, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, start: torch.Tensor):
    """Score K candidate tokens per row in one batched forward: the verify
    half of draft-and-verify speculative decoding.

    tokens: [B, K] candidates per row; start: int32 [B], the position of
    each row's first candidate (-1: a dead row, which writes nothing).
    Row ``b``'s candidates sit at ``start[b] .. start[b]+K-1`` and their KV
    lands at the canonical ring slots, as K :func:`decode_step` calls would
    write it.  Returns ``(logits [B, K, V], cache)``: ``logits[b, j]`` is
    the next-token distribution after candidates ``0..j``.

    On dense caches the forward runs scatter-first (``exact``): per row
    and position it attends and reduces as sequential decode does, every
    kernel at a decode step's row count, so the logits and KV equal K
    decode steps bitwise (on the CPU and, at bitnet's full width, on the
    H100: ``launch/verify_drift.py``).  Windowed caches take the read-only
    chunk form (positionally exact, softmax partitioned otherwise)."""
    K = tokens.shape[1]
    positions = _window_positions(start, K)
    cache, h = _chunk_forward(p, cfg, cache, tokens, positions,
                              exact=not cfg.window)
    return _final_logits(p, cfg, h), cache


def snapshot_kv_window(cfg: ModelConfig, cache: dict, start: torch.Tensor,
                       K: int) -> dict:
    """The undo slab for :func:`rollback_kv_window`, taken before a K-token
    speculative write: per row, the KV and positions at the ring slots of
    positions ``start[b] .. start[b]+K-1`` (slot CL for a dead row or past
    a dense cache's end, read clamped and never restored).  K <= CL
    consecutive positions take K distinct slots, so the pair is exact also
    where the write wraps the ring.  The slab owns its storage (advanced
    indexing copies): the verify writes into the very slots it holds.
    Returns ``{"slot": [B, K], "pos": [B, K], "k"/"v": [L, B, K, Hkv,
    hd]}``."""
    CL = cache["pos"].shape[-1]
    slot = _ring_slot(cfg, CL, _window_positions(start, K))
    rows = torch.arange(slot.shape[0], device=slot.device)[:, None]
    read = slot.clamp_max(CL - 1).long()
    return {"slot": slot, "pos": cache["pos"][0][rows, read],
            "k": cache["k"][:, rows, read], "v": cache["v"][:, rows, read]}


def rollback_kv_window(cfg: ModelConfig, cache: dict, undo: dict,
                       keep: torch.Tensor) -> dict:
    """Rewind a K-token speculative write in place: entries ``j >=
    keep[b]`` of each row get their KV and positions back from ``undo``
    (:func:`snapshot_kv_window`), -1 and evicted in-window keys included;
    the accepted prefix ``j < keep[b]`` stays.  The cache is then what
    ``keep[b]`` sequential :func:`decode_step` writes would have left.

    ``keep`` and ``undo["slot"]`` may lie on the host (the engine reads
    them back with the round's results): the entries to restore are then
    found there, without a device read."""
    slot = undo["slot"]
    CL = cache["pos"].shape[-1]
    j = torch.arange(slot.shape[1], device=slot.device)[None, :]
    restore = (j >= keep.to(slot.device)[:, None]) & (slot < CL)
    r, jj = restore.nonzero(as_tuple=True)
    s = slot[r, jj].long()
    dev = cache["pos"].device
    r, jj, s = r.to(dev), jj.to(dev), s.to(dev)
    for name in ("k", "v"):
        cache[name][:, r, s] = undo[name][:, r, jj]
    cache["pos"][:, r, s] = undo["pos"][r, jj]
    return cache


def _block_slots(cfg: ModelConfig, cache: dict, start: int, length: int):
    """Positions ``[start, start + length)`` and their canonical ring slots
    in ``cache`` (``start`` is a host int: no device read)."""
    pos = start + torch.arange(length, dtype=torch.int32,
                               device=cache["pos"].device)
    return pos, _ring_slot(cfg, cache["pos"].shape[-1], pos).long()


def extract_kv_blocks(cfg: ModelConfig, cache: dict, start: int,
                      length: int) -> dict:
    """Pull one prefix block's KV out of a single-row cache: the slab
    ``{"k": [L, length, Hkv, hd], "v": [L, length, Hkv, hd]}`` holding
    positions ``[start, start + length)``, read from their canonical ring
    slots (``p % CL``), so the extraction is valid whenever those positions
    are still live in the ring (the engine extracts each chunk right after
    prefilling it, before any wraparound can overwrite it).

    The slab owns its storage (``index_select``, not a view): a view would
    keep the whole admission cache alive for as long as the block stays in
    a prefix store.  Inverse of :func:`splice_kv_blocks`."""
    _, slots = _block_slots(cfg, cache, start, length)
    return {name: cache[name][:, 0].index_select(1, slots)
            for name in ("k", "v")}


def splice_kv_blocks(cfg: ModelConfig, cache: dict, block: dict,
                     start: int) -> dict:
    """Write a cached prefix block back into a single-row cache, in place,
    at the canonical ring slots for positions ``[start, start + length)``:
    KV *and* the per-slot positions, so a later chunked prefill or decode
    step sees exactly the state the original compute left behind (the slab
    is spliced in its stored dtype, untouched).  Fixed shapes, no host
    sync.

    Blocks must be spliced in prefix order: with a sliding window a later
    block's slots may wrap onto an earlier block's (the engine caps reuse
    depth at ``CL`` so this never happens, but later writes win, matching
    recompute).  Inverse of :func:`extract_kv_blocks`.  Returns
    ``cache``."""
    L, length = block["k"].shape[:2]
    pos, slots = _block_slots(cfg, cache, start, length)
    for name in ("k", "v"):
        cache[name][:, 0].index_copy_(1, slots,
                                      block[name].to(cache[name].dtype))
    cache["pos"][:, 0].index_copy_(1, slots, pos.expand(L, length))
    return cache


def prefill_chunks_of(plen: int, chunk: int) -> list[tuple[int, int]]:
    """Split a prompt of length ``plen`` into ``(start, valid)`` chunks."""
    if plen < 1:
        raise ValueError("empty prompt")
    return [(s, min(chunk, plen - s)) for s in range(0, plen, chunk)]


def prefill_chunked(p: Params, cfg: ModelConfig, batch: dict, s_max: int,
                    chunk: int):
    """Whole-prompt prefill built from :func:`prefill_chunk` calls: the
    same cache and last-position logits as :func:`prefill` (up to the
    attention's partitioning), for the configs the chunked path covers.
    Nothing serves through it: it is the reference's oracle that chunked
    admission equals whole-prompt prefill, kept for the tests that hold
    the two together.  Returns (cache, logits [B, V])."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    CL = cache_len(cfg, s_max)
    if not cfg.window and S > CL:
        raise ValueError(
            f"prompt length {S} exceeds cache length {CL} (s_max) for a "
            f"non-windowed config")
    dev = tokens.device
    cache = init_cache(cfg, B, CL if cfg.window else s_max, device=dev)
    logits = None
    j = torch.arange(chunk, device=dev)
    for start, valid in prefill_chunks_of(S, chunk):
        ctoks = torch.nn.functional.pad(tokens[:, start:start + valid],
                                        (0, chunk - valid), value=1)
        cpos = torch.where(j < valid, start + j, -1).to(torch.int32)
        cache, logits = prefill_chunk(p, cfg, cache, ctoks,
                                      cpos.expand(B, chunk), take=valid - 1)
    return cache, logits


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(p: Params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                index: torch.Tensor):
    """One decode step.  tokens: [B]; index: int32 [B] per-slot positions
    (a scalar broadcasts).  Each row attends, ropes and writes at its own
    position; a row at ``-1`` (dead) writes no KV and no position, though
    its recurrent states advance, as in the reference.
    Returns (logits [B, V], cache)."""
    B = tokens.shape[0]
    index = torch.as_tensor(index, dtype=torch.int32, device=tokens.device)
    if index.ndim == 0:
        index = index.expand(B)
    CL = cache["pos"].shape[-1] if "pos" in cache else 0
    slot = _ring_slot(cfg, CL, index)
    positions = index[:, None]
    h = embed_tokens(p, cfg, tokens[:, None])
    if cfg.is_encdec:
        h = with_positions(h, sinusoidal_position_at(index,
                                                     cfg.d_model)[:, None])
        old_pos = cache["pos"][0].clone()
        ks, vs = [], []
        for i, blk in enumerate(layer_blocks(p, "dec_blocks")):
            a, (k, v) = append_attention(
                blk["self_attn"], rms_norm(blk["ln1"], h), cfg,
                positions=positions, cache_k=cache["k"][i],
                cache_v=cache["v"][i], k_positions=old_pos,
                window=cfg.window, use_rope=False)
            h = h + a
            h = whisper_cross(blk, h, cfg, positions,
                              (cache["cross_k"][i], cache["cross_v"][i]))
            h = h + ffn(blk["ffn"], rms_norm(blk["ln3"], h), cfg)
            ks.append(k)
            vs.append(v)
        cache = _scatter_rows(cache, slot[:, None], positions,
                              torch.stack(ks), torch.stack(vs))
    elif cfg.block_pattern == "attn":
        old_pos = cache["pos"][0].clone()
        ks, vs = [], []
        for i, blk in enumerate(attn_layers(p, cfg)):
            hn = rms_norm(blk["ln1"], h, offset=cfg.rmsnorm_offset)
            a, (k, v) = append_attention(blk["attn"], hn, cfg,
                                         positions=positions,
                                         cache_k=cache["k"][i],
                                         cache_v=cache["v"][i],
                                         k_positions=old_pos,
                                         window=cfg.window)
            h = h + a
            h = h + block_ffn(blk, rms_norm(blk["ln2"], h,
                                            offset=cfg.rmsnorm_offset), cfg)[0]
            ks.append(k)
            vs.append(v)
        cache = _scatter_rows(cache, slot[:, None], positions,
                              torch.stack(ks), torch.stack(vs))
    elif cfg.block_pattern == "zamba2":
        old_pos = cache["pos"][0].clone()
        ks, vs = [], []
        g = cfg.attn_every
        for i, blk in enumerate(layer_blocks(p, "mamba_blocks")):
            y, (st, cv) = ssm.mamba2_block(
                blk["mixer"], rms_norm(blk["ln"], h), cfg,
                state=cache["ssm"][i], conv_state=cache["conv"][i])
            h = h + y
            cache["ssm"][i] = st
            cache["conv"][i] = cv.to(cache["conv"].dtype)
            if (i + 1) % g == 0:
                j = i // g
                h, (k, v) = _shared_block(p["shared_attn"], h, cfg,
                                          positions=positions,
                                          cache_k=cache["k"][j],
                                          cache_v=cache["v"][j],
                                          k_positions=old_pos,
                                          window=cfg.window)
                ks.append(k)
                vs.append(v)
        cache = _scatter_rows(cache, slot[:, None], positions,
                              torch.stack(ks), torch.stack(vs))
    else:  # xlstm
        for i, (mblk, sblk) in enumerate(zip(layer_blocks(p, "mlstm_blocks"),
                                             layer_blocks(p, "slstm_blocks"))):
            mst = tuple(cache[n][i] for n in ("mC", "mn", "mm"))
            y, mst = xlstm.mlstm_block(mblk["cell"], rms_norm(mblk["ln"], h),
                                       cfg, state=mst, decode=True)
            h = h + y
            sst = tuple(cache[n][i] for n in ("sc", "sn", "sh", "sm"))
            y, sst = xlstm.slstm_block(sblk["cell"], rms_norm(sblk["ln"], h),
                                       cfg, state=sst)
            h = h + y
            for n, t in zip(("mC", "mn", "mm", "sc", "sn", "sh", "sm"),
                            mst + sst):
                cache[n][i] = t
    h = rms_norm(p["final_norm"], h, offset=cfg.rmsnorm_offset)
    return _final_logits(p, cfg, h[:, 0]), cache
