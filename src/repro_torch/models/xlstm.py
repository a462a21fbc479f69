"""xLSTM blocks (sLSTM + mLSTM) of the xlstm-125m architecture.

* **mLSTM**: matrix-memory cell with O(1) decode state ``(C [B,H,dk,dv],
  n [B,H,dk], m [B,H])``; prefill runs the chunked scan with the
  exponential-gate stabilizer carried across chunks.
* **sLSTM**: scalar-memory cell with recurrent gate weights, stepped one
  position at a time.

As in the reference: the up/down projections and the q/k/v maps are ternary
(through :func:`repro_torch.models.layers.linear`), the gates and the
recurrent weights stay f32.

One deliberate departure: :func:`slstm_scan` steps the S real positions
only.  The reference pads time to a multiple of its 64-step checkpoint
chunk and steps the padded positions too, with zero gate inputs, which are
not neutral for this cell: for ``S > 64`` not a multiple of 64 its state
after prefill is not the state after S steps.  Here it is, so a prompt's
state equals the reference's own one-step-at-a-time recurrence.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _act, linear, rms_norm
from repro_torch.models.ssm import softplus


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-softplus(-x)``, as the reference computes it."""
    return -softplus(-x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU in the reference's op order, each op in x's dtype."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig):
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    dk = d_in // H
    return d_in, H, dk


def _lin(g, d_in, d_out, device, dtype=torch.bfloat16, scale=None):
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    return {"w": torch.randn((d_in, d_out), generator=g, dtype=dtype,
                             device=device) * scale}


def init_mlstm(g: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> Params:
    """One layer's mLSTM cell in the reference's shapes, dtypes, scales."""
    d_in, H, _ = mlstm_dims(cfg)
    D = cfg.d_model
    return {"up": _lin(g, D, 2 * d_in, device),
            "wq": _lin(g, d_in, d_in, device),
            "wk": _lin(g, d_in, d_in, device),
            "wv": _lin(g, d_in, d_in, device),
            "wif": _lin(g, d_in, 2 * H, device, torch.float32),
            "norm": {"g": torch.ones((d_in,), dtype=torch.bfloat16,
                                     device=device)},
            "down": _lin(g, d_in, D, device)}


def _mlstm_chunked(q, k, v, log_f, log_i, chunk: int, state=None):
    """Chunk-parallel mLSTM.  q/k/v: [B,S,H,dk|dv]; log_f/log_i: [B,S,H]."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    dev = q.device
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        log_f = torch.nn.functional.pad(log_f, (0, 0, 0, pad))   # keep
        log_i = torch.nn.functional.pad(log_i, (0, 0, 0, pad), value=-1e30)
    nc = (S + pad) // chunk
    if state is None:
        C = torch.zeros((B, H, dk, dv), dtype=f32, device=dev)
        n = torch.zeros((B, H, dk), dtype=f32, device=dev)
        m = torch.full((B, H), -1e30, dtype=f32, device=dev)
    else:
        C, n, m = state
    iota = torch.arange(chunk, device=dev)
    causal = (iota[:, None] >= iota[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qf, kf, vf = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        lf, li = log_f[:, sl], log_i[:, sl]
        csf = torch.cumsum(lf, dim=1)                            # [B,Q,H]
        total_f = csf[:, -1]                                     # [B,H]
        # pairwise log-weights: w[i, j] = li_j + csf_i - csf_j
        w_ij = li[:, None, :, :] + csf[:, :, None, :] - csf[:, None, :, :]
        w_ij = torch.where(causal, w_ij, -1e30)
        m_pos = torch.maximum(m[:, None] + csf, w_ij.amax(2))    # [B,i,H]
        Dm = torch.exp(w_ij - m_pos[:, :, None, :])
        scores = torch.einsum("bihd,bjhd->bijh", qf, kf) * Dm
        y_num = torch.einsum("bijh,bjhv->bihv", scores, vf)
        n_i = torch.einsum("bijh,bjhd->bihd", Dm, kf)
        carry_scale = torch.exp(m[:, None] + csf - m_pos)        # [B,i,H]
        y_num = y_num + torch.einsum("bihd,bhdv->bihv", qf, C) * \
            carry_scale[..., None]
        n_i = n_i + n[:, None] * carry_scale[..., None]
        den = torch.abs(torch.einsum("bihd,bihd->bih", qf, n_i))
        ys.append(y_num / torch.maximum(den, torch.exp(-m_pos))[..., None])
        # the state at the end of the chunk
        intra_w = li + (total_f[:, None] - csf)                  # [B,Q,H]
        m_new = torch.maximum(m + total_f, intra_w.amax(1))
        scale_old = torch.exp(m + total_f - m_new)               # [B,H]
        wj = torch.exp(intra_w - m_new[:, None])                 # [B,Q,H]
        C = C * scale_old[:, :, None, None] + \
            torch.einsum("bjh,bjhd,bjhv->bhdv", wj, kf, vf)
        n = n * scale_old[:, :, None] + torch.einsum("bjh,bjhd->bhd", wj, kf)
        m = m_new
    y = torch.cat(ys, dim=1)[:, :S]
    return y, (C, n, m)


def mlstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *, state=None,
                chunk: int = 128, decode: bool = False):
    """x: [B, S, D] → (y, new_state)."""
    B, S, _ = x.shape
    d_in, H, dk = mlstm_dims(cfg)
    f32 = torch.float32
    up = linear(p["up"], x, cfg)
    xi, z = up[..., :d_in], up[..., d_in:]
    q = linear(p["wq"], xi, cfg).reshape(B, S, H, dk) / (dk ** 0.5)
    k = linear(p["wk"], xi, cfg).reshape(B, S, H, dk)
    v = linear(p["wv"], xi, cfg).reshape(B, S, H, dk)
    gates = linear(p["wif"], xi, cfg, ternary=False).to(f32)
    log_i = gates[..., :H]                                   # exp input gate
    log_f = log_sigmoid(gates[..., H:])                      # sigmoid forget

    if decode:
        C, n, m = state
        m_new = torch.maximum(log_f[:, 0] + m, log_i[:, 0])
        i_s = torch.exp(log_i[:, 0] - m_new)
        f_s = torch.exp(log_f[:, 0] + m - m_new)
        q0, k0, v0 = q[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32)
        C_new = f_s[:, :, None, None] * C + i_s[:, :, None, None] * \
            torch.einsum("bhd,bhv->bhdv", k0, v0)
        n_new = f_s[:, :, None] * n + i_s[:, :, None] * k0
        num = torch.einsum("bhd,bhdv->bhv", q0, C_new)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q0, n_new)),
                            torch.exp(-m_new))
        y = (num / den[..., None])[:, None]                  # [B,1,H,dv]
        new_state = (C_new, n_new, m_new)
    else:
        y, new_state = _mlstm_chunked(q, k, v, log_f, log_i, chunk, state)

    y = y.reshape(B, S, d_in).to(x.dtype) * _act("silu")(z)
    y = rms_norm(p["norm"], y)
    return linear(p["down"], y, cfg), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_up(cfg: ModelConfig) -> int:
    """Width of the sLSTM block's gated feed-forward."""
    return int(cfg.d_model * 4 / 3)


def init_slstm(g: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> Params:
    """One layer's sLSTM cell in the reference's shapes, dtypes, scales."""
    d = cfg.d_model
    up = slstm_up(cfg)
    return {"gates_x": _lin(g, d, 4 * d, device, torch.float32),
            "gates_h": _lin(g, d, 4 * d, device, torch.float32, scale=0.02),
            "ffn_up": _lin(g, d, 2 * up, device),
            "ffn_down": _lin(g, up, d, device),
            "norm": {"g": torch.ones((d,), dtype=torch.bfloat16,
                                     device=device)}}


def _slstm_steps(gx: torch.Tensor, wh: torch.Tensor, c, n, h, m):
    """The sLSTM cell stepped over ``gx [B, T, 4D]`` (the input gate
    products) from the carry ``(c, n, h, m)`` → ``(h_seq [B, T, D] f32, c,
    n, h, m)``."""
    D = wh.shape[0]
    hs = []
    for t in range(gx.shape[1]):
        g = gx[:, t] + h @ wh
        zt, it, ft, ot = torch.split(g, D, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        log_f = log_sigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        h = ot * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), c, n, h, m


#: steps a checkpointed sLSTM chunk takes under autograd (the reference's)
SLSTM_TIME_CHUNK = 64


def slstm_scan(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Sequential sLSTM cell over the S positions of x: [B, S, D] →
    (h_seq [B, S, D] in x's dtype, state).  ``state = (c, n, h, m)``, each
    [B, D] f32.  Steps exactly S positions (see the module docstring).

    Under autograd each :data:`SLSTM_TIME_CHUNK` steps run under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` per
    chunk): backward keeps only every chunk's first carry and recomputes
    the steps inside it, where a plain loop would keep every step's.
    Without autograd the chunks run as they are, the same operations in the
    same order."""
    B, S, D = x.shape
    f32 = torch.float32
    if state is None:
        z = torch.zeros((B, D), dtype=f32, device=x.device)
        state = (z, z + 1e-6, z, z - 1e30)
    gx = x.to(f32) @ p["gates_x"]["w"]                       # [B, S, 4D]
    wh = p["gates_h"]["w"]
    steps = _slstm_steps
    if torch.is_grad_enabled() and (gx.requires_grad or wh.requires_grad):
        steps = functools.partial(torch.utils.checkpoint.checkpoint,
                                  _slstm_steps, use_reentrant=False)
    hs = []
    for t0 in range(0, S, SLSTM_TIME_CHUNK):
        h_seq, *state = steps(gx[:, t0:t0 + SLSTM_TIME_CHUNK], wh, *state)
        hs.append(h_seq)
    return torch.cat(hs, 1).to(x.dtype), tuple(state)


def slstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *, state=None):
    h, new_state = slstm_scan(p, x, cfg, state)
    h = rms_norm(p["norm"], h)
    up = linear(p["ffn_up"], h, cfg)
    a, b = torch.chunk(up, 2, dim=-1)
    y = linear(p["ffn_down"], gelu_tanh(a) * b, cfg)
    return y, new_state
