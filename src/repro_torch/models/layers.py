"""Shared neural blocks of the attention family: norms, RoPE, ternary-aware
linears, GQA attention, gated FFNs and the top-k MoE FFN.

Every projection goes through :func:`linear`, which dispatches on the leaf:

  * ``{"w": [in, out]}``                 — fp or QAT (fake-quant) forward
  * ``{"packed": [out, in/5], "scale"}`` — 1.6-bit base-3 serving path, via
    :func:`repro_torch.kernels.dispatch.ternary_matmul`; a ``"tw"`` entry
    (a bound :class:`~repro_torch.kernels.dispatch.TernaryWeight`) carries
    the kernel encodings derived once, see ``decode.bind_serving_weights``.

MoE expert stacks go through :func:`moe_ffn`'s expert matmuls, which take
``{"packed": [E, out, in/5], "scale": [E]}`` to
:func:`repro_torch.kernels.dispatch.grouped_ternary_matmul` (a ``"gw"``
entry carries the bound
:class:`~repro_torch.kernels.dispatch.GroupedTernaryWeight`).

The arithmetic follows the reference op for op, including where it rounds
to bf16, so the two agree to bf16 tolerance.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.quantization import (fake_quant_acts, fake_quant_ternary,
                                           quantize_activations_int8)
from repro_torch.kernels.dispatch import (GroupedTernaryWeight, TernaryWeight,
                                          grouped_ternary_matmul,
                                          ternary_matmul)
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the reference normalizes and accumulates in (f32), or f64
    for f64 activations: the plain path run in f64 end to end, the
    yardstick of the logits' rounding drift."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rms_norm(p: Params, x: torch.Tensor, *, offset: bool = False,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(acc_dtype(x))
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    g = p["g"].to(x.dtype)
    if offset:
        g = 1.0 + g
    return (x * g).to(dt)


def linear(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
           ternary: bool = True) -> torch.Tensor:
    """Apply a (possibly ternary) linear layer; see the module docstring."""
    if "packed" in p:
        if p["packed"].ndim != 2:
            raise NotImplementedError(
                f"linear() needs a per-layer [out, in/5] packed matrix, got "
                f"shape {tuple(p['packed'].shape)}; slice the stacked dim first")
        tw = p.get("tw") or TernaryWeight.from_packed(
            p["packed"], p["scale"], x.shape[-1], mu=cfg.mu)
        if cfg.act_dtype == "int8" and x.is_floating_point():
            # W1.58A8: per-token absmax int8 in front of the packed matmul;
            # the activation scale is the second rank-1 correction
            x_q, x_scale = quantize_activations_int8(x)
            y = ternary_matmul(x_q, tw, policy=cfg.matmul_policy)
            y = (y * x_scale).to(x.dtype)
        else:
            y = ternary_matmul(x, tw, policy=cfg.matmul_policy)
    else:
        w = p["w"]
        if ternary and cfg.quant == "qat":
            w = fake_quant_ternary(w)
            if cfg.quantize_acts:
                x = fake_quant_acts(x)
        if x.dtype != w.dtype:  # bf16 x through an f32 gate: f32, as jnp
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [B, S, H, hd]; positions: [B, S] or [S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs          # [B, S, half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str):
    if name == "silu":
        # the reference's op sequence, x * 1 / (1 + exp(-x)), each step
        # rounded to the activation dtype (torch.sigmoid rounds once and
        # lands one bf16 ulp away on about a fifth of the values)
        return lambda v: v * (1 / (1 + torch.exp(-v)))
    if name == "gelu":
        return lambda v: torch.nn.functional.gelu(v, approximate="tanh")
    raise KeyError(name)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _chunk_mask(qp: torch.Tensor, kp: torch.Tensor, kind: str,
                window: int) -> torch.Tensor:
    """[1 or B, qc, kc] bool validity from absolute positions (kp = -1 marks
    an empty slot).  ``kind``: "causal" (kp <= qp, optional sliding window),
    "causal_strict" (kp < qp), "self" (kp == qp) or "full"."""
    if qp.ndim == 1:
        qp = qp[None]
    if kp.ndim == 1:
        kp = kp[None]
    valid = kp[:, None, :] >= 0
    if kind == "self":
        valid = valid & (kp[:, None, :] == qp[:, :, None])
    elif kind == "causal_strict":
        valid = valid & (kp[:, None, :] < qp[:, :, None])
    elif kind == "causal":
        valid = valid & (kp[:, None, :] <= qp[:, :, None])
        if window:
            valid = valid & (kp[:, None, :] > qp[:, :, None] - window)
    return valid


def _sdpa(q, k, v, cfg: ModelConfig, *, q_pos, k_pos, kind: str = "causal",
          window: int = 0, chunk_k: int = 1024, extra_kv=None,
          extra_kind: str | None = None) -> torch.Tensor:
    """Attention with an online softmax over key chunks, in f32.

    q: [B,Sq,H,hd]; k/v: [B,Sk,Hkv,hd]; q_pos [Sq] or [B,Sq]; k_pos [Sk] or
    [B,Sk] absolute positions (-1 = empty slot).  Scores are taken in the
    activation dtype, scaled and soft-maxed in f32, and the probabilities
    meet ``v`` in its dtype, chunk by chunk, as the reference does;
    ``extra_kv = (k1, v1, pos1)`` merges one more chunk (the tokens being
    appended).  Returns [B, Sq, H*hd] in ``v``'s dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    q_pos = torch.atleast_2d(q_pos)
    k_pos = torch.atleast_2d(k_pos)
    scale = 1.0 / math.sqrt(hd)
    qb = q.reshape(B, Sq, Hkv, rep, hd)
    f32 = acc_dtype(q)
    m = torch.full((B, Hkv, rep, Sq), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, Hkv, rep, Sq, hd), dtype=f32, device=q.device)

    def merge(m, l, acc, kb, vb, kp, mk):
        s = torch.einsum("bqkrd,bskd->bkrqs", qb, kb).to(f32) * scale
        valid = _chunk_mask(q_pos, kp, mk, window)
        s = torch.where(valid[:, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkrqs,bskd->bkrqd", p.to(vb.dtype), vb).to(f32)
        return m_new, l, acc

    ck = min(chunk_k, Sk)
    for s0 in range(0, Sk, ck):
        kb, vb, kp = k[:, s0:s0 + ck], v[:, s0:s0 + ck], k_pos[:, s0:s0 + ck]
        pad = ck - kb.shape[1]
        if pad:  # the reference pads the last chunk with empty slots
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
            kp = torch.nn.functional.pad(kp, (0, pad), value=-1)
        m, l, acc = merge(m, l, acc, kb, vb, kp, kind)
    if extra_kv is not None:
        k1, v1, p1 = extra_kv
        m, l, acc = merge(m, l, acc, k1.to(qb.dtype), v1.to(qb.dtype),
                          torch.atleast_2d(p1), extra_kind or kind)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]     # [B, Hkv, rep, Sq, hd]
    out = out.permute(0, 3, 1, 2, 4)                      # [B, Sq, Hkv, rep, hd]
    return out.reshape(B, Sq, H * hd).to(v.dtype)


def _q(p: Params, x: torch.Tensor, cfg: ModelConfig, positions,
       use_rope: bool = True):
    B, Sq, _ = x.shape
    q = linear(p["wq"], x, cfg).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
    return rope(q, positions, cfg.rope_theta) if use_rope else q


def cross_kv(p: Params, src: torch.Tensor, cfg: ModelConfig):
    """Keys and values of ``src`` [B, S, D] (whisper's encoder output)
    under the projections ``p``: ``(k, v)`` [B, S, Hkv, hd], unroped."""
    B, S, _ = src.shape
    k = linear(p["wk"], src, cfg).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = linear(p["wv"], src, cfg).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions,
         use_rope: bool = True):
    q = _q(p, x, cfg, positions, use_rope)
    k, v = cross_kv(p, x, cfg)
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k)
    return q, rope(k, positions, cfg.rope_theta) if use_rope else k, v


def ring_writes(slot: torch.Tensor, CL: int):
    """The in-range entries of ``slot`` ``[B, S]`` (ring slots; out of
    range drops): ``(keep [B, S], rows [n], slots [n])``, the index pair a
    cache write takes.  Boolean indexing reads ``keep`` back to the host
    once."""
    B, S = slot.shape
    keep = (slot >= 0) & (slot < CL)
    rows = torch.arange(B, device=slot.device)[:, None].expand(B, S)
    return keep, rows[keep], slot[keep].long()


def append_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, k_positions: torch.Tensor,
                     window: int = 0, scatter=None, use_rope: bool = True):
    """Attention over a read-only KV cache plus the tokens being appended
    (decode: one token; chunked prefill: one chunk), merged as one extra
    online-softmax chunk.  Causality inside the chunk falls out of the
    absolute-position mask.  The fresh ``(k, v)`` are returned for the
    caller to write at their ring slots after the layer loop.

    x: [B, Sq, D]; positions: [B, Sq] (-1 rows produce garbage the caller
    discards); cache k/v: [B, CL, Hkv, hd]; k_positions: [B, CL].
    Returns (out [B, Sq, D], (k, v) [B, Sq, Hkv, hd]).

    ``scatter`` (the chunk's :func:`ring_writes`) switches to the
    scatter-first exact form of speculative verify: the chunk's fresh k/v
    are written into ``cache_k``/``cache_v`` in place before attending,
    the cache is masked strictly below each query (``kp < qp``; the caller
    passes ``k_positions`` already holding the chunk's positions) and the
    chunk merges self-only (``kp == qp``).  Each query attends as a batch
    row of its own (the row's cache repeated per query), so every product
    of the attention has a decode step's shape: per query the attended set,
    the reduction order and the row count are then those of sequential
    single-token decode.  Dense caches only: on a wrapped ring the write
    would evict keys that earlier chunk positions still attend.  Returns
    (out, (cache_k, cache_v)).  ``use_rope=False``: no rotary embedding
    (whisper's decoder self-attention)."""
    q, k, v = _qkv(p, x, cfg, positions, use_rope)
    if scatter is not None:
        if window:
            raise ValueError("scatter-first exact attention requires a "
                             "dense (window=0) cache")
        keep, r, s = scatter
        cache_k[r, s] = k[keep].to(cache_k.dtype)
        cache_v[r, s] = v[keep].to(cache_v.dtype)
        B, Sq = positions.shape

        def rows(t):        # [B, Sq, ...] → [B·Sq, 1, ...]
            return t.reshape(B * Sq, 1, *t.shape[2:])

        def per_query(t):   # [B, ...] → [B·Sq, ...], row b·Sq + j
            return t.repeat_interleave(Sq, 0)

        o = _sdpa(rows(q), per_query(cache_k.to(q.dtype)),
                  per_query(cache_v.to(q.dtype)), cfg, q_pos=rows(positions),
                  k_pos=per_query(k_positions), kind="causal_strict",
                  extra_kv=(rows(k), rows(v), rows(positions)),
                  extra_kind="self")
        return linear(p["wo"], o.reshape(B, Sq, -1), cfg), (cache_k, cache_v)
    o = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), cfg,
              q_pos=positions, k_pos=k_positions, window=window,
              extra_kv=(k, v, positions))
    return linear(p["wo"], o, cfg), (k, v)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, k_positions: torch.Tensor | None = None,
              kind: str = "causal", window: int = 0, kv=None,
              use_rope: bool = True, return_kv: bool = False):
    """GQA self-attention over ``x`` itself (training / whole-prompt
    prefill), or, with ``kv=(k, v)`` [B, Sk, Hkv, hd] given, attention of
    ``x``'s queries over those keys (whisper's cross-attention, with
    ``kind="full"`` and ``k_positions`` the keys' positions).
    ``use_rope=False`` skips the rotary embedding; ``return_kv`` also
    returns the ``(k, v)`` attended."""
    if kv is None:
        q, k, v = _qkv(p, x, cfg, positions, use_rope)
    else:
        q, (k, v) = _q(p, x, cfg, positions, use_rope), kv
    out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), cfg, q_pos=positions,
                k_pos=positions if k_positions is None else k_positions,
                kind=kind, window=window)
    out = linear(p["wo"], out, cfg)
    return (out, (k, v)) if return_kv else out


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated FFN (SwiGLU/GeGLU) or plain 2-layer MLP."""
    if "wg" in p:
        h = _act(cfg.act_fn)(linear(p["wg"], x, cfg)) * linear(p["wi"], x, cfg)
    else:
        h = _act(cfg.act_fn)(linear(p["wi"], x, cfg))
    return linear(p["wo"], h, cfg)


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Per-expert capacity ``C`` of a forward over ``tokens`` tokens: the
    expert-buffer rows :func:`moe_ffn` allocates, and the capacity the
    autotune shape universe enumerates."""
    return max(int(cfg.capacity_factor * tokens * cfg.experts_per_token
                   / cfg.n_experts), 1)


def init_moe(g: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    """One layer's MoE parameters, drawn from ``g`` on ``device`` in the
    reference's shapes, dtypes and scales: an f32 router ``[D, E]`` and
    bf16 expert stacks ``[E, din, dout]`` (plus a shared expert where the
    config has one)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)

    def normal(shape, scale, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, dtype=dtype,
                           device=device) * scale

    p = {"router": {"w": normal((d, E), s, torch.float32)},
         "wi": {"w": normal((E, d, f), s)},
         "wg": {"w": normal((E, d, f), s)},
         "wo": {"w": normal((E, f, d), 1.0 / math.sqrt(f))}}
    if cfg.moe_shared_expert:
        p["shared"] = {"wi": {"w": normal((d, f), s)},
                       "wo": {"w": normal((f, d), 1.0 / math.sqrt(f))}}
        if cfg.ffn_gated:
            p["shared"]["wg"] = {"w": normal((d, f), s)}
    return p


def _expert_matmul(leaf: Params, cfg: ModelConfig, d_in: int):
    """``f: [E, C, d_in] → [E, C, d_out]`` for packed (``{"packed" [E,
    d_out, d_in/5], "scale" [E]}``) or float (``{"w" [E, d_in, d_out]}``,
    fake-quantized per expert under QAT) expert weights.  Packed stacks go
    through :func:`grouped_ternary_matmul`, so ``cfg.matmul_policy``
    governs them as it does the dense projections; with int8 activations
    each buffer row is quantized per token first (the zero rows of empty
    slots quantize to zero codes) and its scale is the second rank-1
    correction."""
    if "packed" in leaf:
        gw = leaf.get("gw") or GroupedTernaryWeight.from_packed(
            leaf["packed"], leaf["scale"], d_in, mu=cfg.mu)
        if cfg.act_dtype == "int8":
            def run(t):
                t_q, t_scale = quantize_activations_int8(t)
                y = grouped_ternary_matmul(t_q, gw, policy=cfg.matmul_policy)
                return (y * t_scale).to(t.dtype)

            return run
        return lambda t: grouped_ternary_matmul(t, gw,
                                                policy=cfg.matmul_policy)
    w = leaf["w"]
    if cfg.quant == "qat":
        w = fake_quant_ternary(w, axis=(-2, -1))
    return lambda t: torch.einsum("ecd,edf->ecf", t, w.to(t.dtype))


def route(router: Params, xf: torch.Tensor, cfg: ModelConfig):
    """Token-choice routing of ``xf [T, D]``: ``(probs [T, E], gate_vals
    [T, K], gate_idx [T, K])`` from the f32 router softmax, the top-k
    experts (ties to the lower index, as the reference's ``top_k``; a
    stable descending sort does the same on every device) and their gates
    renormalized to sum to 1."""
    logits = xf.to(torch.float32) @ router["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    K = cfg.experts_per_token
    gate_vals, gate_idx = gate_vals[:, :K], gate_idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Top-k token-choice MoE with the reference's sort-based dispatch:
    f32 router softmax, top-k (ties to the lower expert index), gate
    renormalization, a stable sort of the token-expert assignments, each
    assignment's slot in its expert's ``C`` rows (later ones past ``C``
    drop to a sentinel row), the grouped expert matmuls over the ``[E, C,
    D]`` buffer, and the gated results added back per token in the
    activation dtype.  Every row of ``x`` routes and takes capacity,
    including rows whose output the caller discards (dead slots, padded
    chunk tails).  Returns ``(out [B, S, D], aux_loss)``."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(T, D)
    probs, gate_vals, gate_idx = route(p["router"], xf, cfg)

    # assignments per expert (exact small integers in f32; an index_add,
    # unlike bincount, needs no readback to the host)
    flat_e = gate_idx.reshape(T * K)
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    # load-balance aux loss (Switch): E * Σ_e f_e · p_e
    aux = E * torch.sum(probs.mean(0) * (counts / (T * K)))

    cap = moe_capacity(cfg, T)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok_of = order // K
    counts = counts.long()
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * K, device=x.device) - start[sorted_e]
    keep = slot < cap
    # dropped assignments target the sentinel row E·cap
    flat_idx = torch.where(keep, sorted_e * cap + slot, E * cap)
    buf = torch.zeros((E * cap + 1, D), dtype=xf.dtype, device=x.device)
    buf[flat_idx] = xf[tok_of]
    disp = buf[:-1].reshape(E, cap, D)

    up_i = _expert_matmul(p["wi"], cfg, D)
    up_g = _expert_matmul(p["wg"], cfg, D)
    down = _expert_matmul(p["wo"], cfg, cfg.d_ff)
    h = _act(cfg.act_fn)(up_g(disp)) * up_i(disp)
    eout = down(h).reshape(E * cap, D)

    gathered = torch.where(keep[:, None],
                           eout[torch.clamp_max(flat_idx, E * cap - 1)],
                           torch.zeros((), dtype=eout.dtype, device=x.device))
    gates_sorted = gate_vals.reshape(T * K)[order].to(xf.dtype)
    # two contributions a row (top-2) round the same in any order
    out = torch.zeros((T, D), dtype=xf.dtype, device=x.device).index_add_(
        0, tok_of, gathered * gates_sorted[:, None])
    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + ffn(p["shared"], x, cfg)
    return out, aux


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-1e30 out the vocab-padding tail (see ModelConfig.padded_vocab)."""
    if logits.shape[-1] == vocab:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota < vocab, logits, -1e30)
