"""Mamba2 (SSD) blocks of the zamba2 hybrid architecture.

Prefill runs the chunked SSD form (intra-chunk attention-like products plus
a loop over chunk states), decode the O(1) single-step state update.  As in
the reference: separate z/x/B/C/dt projections, ``n_groups = 1``; the large
in/out projections (``wz``, ``wx``, ``wo``) are ternary and go through
:func:`repro_torch.models.layers.linear`, the small ``wB``/``wC``/``wdt``
products, the conv and the gates stay float.

The arithmetic follows the reference op for op (bf16 where it rounds to
bf16, the SSD contractions in f32).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _act, acc_dtype, linear, rms_norm


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as the reference's ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def init_mamba2(g: torch.Generator, cfg: ModelConfig,
                device: torch.device) -> Params:
    """One layer's mixer, drawn from ``g`` in the reference's shapes, dtypes
    and scales."""
    d_in, H, N = ssm_dims(cfg)
    D = cfg.d_model

    def lin(d_i, d_o):
        return {"w": torch.randn((d_i, d_o), generator=g, dtype=torch.bfloat16,
                                 device=device) * (1.0 / math.sqrt(d_i))}

    p = {"wz": lin(D, d_in), "wx": lin(D, d_in), "wB": lin(D, N),
         "wC": lin(D, N), "wdt": lin(D, H)}
    p["conv"] = torch.randn((cfg.ssm_conv, d_in + 2 * N), generator=g,
                            dtype=torch.bfloat16, device=device) * 0.1
    p["A_log"] = torch.zeros((H,), dtype=torch.float32, device=device)
    p["D"] = torch.ones((H,), dtype=torch.float32, device=device)
    p["dt_bias"] = torch.full((H,), -2.0, dtype=torch.float32, device=device)
    p["norm"] = {"g": torch.ones((d_in,), dtype=torch.bfloat16, device=device)}
    p["wo"] = lin(d_in, D)
    return p


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: [B, S, C]; kernel: [K, C].

    With ``state`` [B, K-1, C] (decode), returns (y, new_state)."""
    K = kernel.shape[0]
    S = x.shape[1]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)       # [B, K-1+S, C]
        new_state = xin[:, -(K - 1):]
    else:
        xin = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
        new_state = None
    y = xin[:, 0:S] * kernel[0]
    for i in range(1, K):
        y = y + xin[:, i:i + S] * kernel[i]
    y = _act("silu")(y)
    return (y, new_state) if state is not None else y


def _ssd_chunked(u, B_in, C_in, log_a, chunk: int, h0=None):
    """Chunked scalar-decay SSD scan.

    u: [B, S, H, P] (dt-scaled inputs); B_in, C_in: [B, S, N]; log_a:
    [B, S, H] per-step log decays (<= 0); h0: optional [B, H, N, P].
    Returns (y [B, S, H, P] f32, h_final [B, H, N, P] f32; f64 for f64
    ``u``)."""
    Bb, S, H, P = u.shape
    N = B_in.shape[-1]
    f32 = acc_dtype(u)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:  # zero input and zero decay (a = 1 keeps the state)
        u = torch.nn.functional.pad(u, (0, 0, 0, 0, 0, pad))
        B_in = torch.nn.functional.pad(B_in, (0, 0, 0, pad))
        C_in = torch.nn.functional.pad(C_in, (0, 0, 0, pad))
        log_a = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    h = (torch.zeros((Bb, H, N, P), dtype=f32, device=u.device) if h0 is None
         else h0.to(f32))
    iota = torch.arange(chunk, device=u.device)
    causal = (iota[:, None] >= iota[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        ucb, Bcb, Ccb = (u[:, sl].to(f32), B_in[:, sl].to(f32),
                         C_in[:, sl].to(f32))
        cs = torch.cumsum(log_a[:, sl], dim=1)                 # [B, Q, H]
        total = cs[:, -1]                                      # [B, H]
        scores = torch.einsum("bin,bjn->bij", Ccb, Bcb)
        decay = cs[:, :, None, :] - cs[:, None, :, :]          # [B, i, j, H]
        # masked before the exp, not after as the reference: the entries
        # above the diagonal (j > i) are -(the log decays in (i, j]) >= 0
        # and overflow to inf once the dt grow in training, and the
        # reference's where-after-exp then sends 0 * inf = NaN back through
        # the exp.  The forward values are the same bit for bit.
        gate = torch.exp(torch.where(causal, decay, -math.inf))
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", scores, gate, ucb)
        y_inter = torch.einsum("bin,bhnp,bih->bihp", Ccb, h, torch.exp(cs))
        carry_in = torch.einsum("bjn,bjhp,bjh->bhnp", Bcb, ucb,
                                torch.exp(total[:, None] - cs))
        h = torch.exp(total)[:, :, None, None] * h + carry_in
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def mamba2_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 state=None, conv_state=None, chunk: int = 128):
    """Mamba2 mixer.  x: [B, S, D].

    Prefill: ``state=None`` runs the chunked SSD and returns (y, (h,
    conv)), ``conv`` the last ``ssm_conv - 1`` conv inputs (None when the
    prompt is shorter, as in the reference).  Decode: pass ``(state [B, H,
    N, P], conv_state [B, K-1, C])`` with S == 1."""
    Bb, S, _ = x.shape
    d_in, H, N = ssm_dims(cfg)
    P = cfg.ssm_head_dim

    z = linear(p["wz"], x, cfg)
    xs = linear(p["wx"], x, cfg)
    Bi = linear(p["wB"], x, cfg, ternary=False)
    Ci = linear(p["wC"], x, cfg, ternary=False)
    f32 = acc_dtype(x)
    dt = linear(p["wdt"], x, cfg, ternary=False).to(f32)

    conv_in = torch.cat([xs, Bi, Ci], dim=-1)
    if conv_state is not None:
        conv_out, new_conv = _causal_conv(conv_in, p["conv"], conv_state)
    else:
        conv_out = _causal_conv(conv_in, p["conv"])
        new_conv = (conv_in[:, -(cfg.ssm_conv - 1):]
                    if S >= cfg.ssm_conv - 1 else None)
    xs, Bi, Ci = (conv_out[..., :d_in], conv_out[..., d_in:d_in + N],
                  conv_out[..., d_in + N:])

    dt = softplus(dt + p["dt_bias"])                           # [B, S, H]
    a = -torch.exp(p["A_log"])                                 # [H]
    log_a = dt * a
    u = xs.reshape(Bb, S, H, P).to(f32) * dt[..., None]

    if state is None:
        y, h_fin = _ssd_chunked(u, Bi, Ci, log_a, chunk)
    else:
        # single-step recurrence (S == 1)
        a_t = torch.exp(log_a[:, 0])                           # [B, H]
        h_fin = a_t[:, :, None, None] * state.to(f32) + \
            torch.einsum("bn,bhp->bhnp", Bi[:, 0].to(f32), u[:, 0])
        y = torch.einsum("bn,bhnp->bhp", Ci[:, 0].to(f32),
                         h_fin)[:, None]

    # D skip connection on the conv'd, unscaled inputs, per head
    y = y + xs.reshape(Bb, S, H, P).to(f32) * p["D"][None, None, :, None]
    y = y.reshape(Bb, S, d_in).to(x.dtype)
    y = rms_norm(p["norm"], y * _act("silu")(z))
    y = linear(p["wo"], y, cfg)
    return y, (h_fin, new_conv)
