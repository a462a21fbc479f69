"""BitNet b1.58 ternary quantization (paper §II-A), forward semantics only.

Weights: per-tensor absmean scale, then round-to-nearest ternary.
Activations: per-token absmax INT8.  Both follow the reference arithmetic
step for step (the scale in the weight's dtype, the activation math in f32),
so trits and int8 codes agree with it exactly.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def absmean_scale(w: torch.Tensor, axis=None) -> torch.Tensor:
    """BitNet b1.58 scale: mean of absolute values (per-tensor by default),
    accumulated in f32 and returned in ``w``'s dtype."""
    a = w.to(torch.float32).abs()
    m = a.mean() if axis is None else a.mean(dim=axis, keepdim=True)
    return m.to(w.dtype).clamp_min(EPS)


def ternarize(w: torch.Tensor, axis=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize weights to {-1, 0, +1}: ``(w_t int8, scale)`` with
    ``w ≈ w_t * scale``."""
    scale = absmean_scale(w, axis=axis)
    w_t = torch.round(w / scale).clamp(-1, 1).to(torch.int8)
    return w_t, scale


def dequantize(w_t: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return w_t.to(dtype) * scale.to(dtype)


def fake_quant_ternary(w: torch.Tensor, axis=None) -> torch.Tensor:
    """Forward value of the straight-through weight fake-quant,
    ``w + (dequant(ternarize(w)) - w)`` rounded as the reference rounds it."""
    w_t, scale = ternarize(w, axis=axis)
    wq = dequantize(w_t, scale, dtype=w.dtype)
    return w + (wq - w)


def fake_quant_acts(x: torch.Tensor) -> torch.Tensor:
    """Forward value of the straight-through INT8 per-token fake-quant."""
    x_q, scale = quantize_activations_int8(x)
    xq = (x_q.to(torch.float32) * scale).to(x.dtype)
    return x + (xq - x)


def quantize_activations_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last-axis) absmax INT8 quantization → ``(x_q int8, scale
    f32 [..., 1])`` with ``x ≈ x_q * scale``.

    An all-zero row gets the EPS-derived scale (codes 0, never 0/0), a row
    holding ±inf gets the f32-max scale so its codes saturate at ±127, and
    NaN quantizes to 0."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    absmax = torch.where(torch.isfinite(absmax), absmax,
                         torch.finfo(torch.float32).max)
    absmax = absmax.clamp_min(EPS)
    scale = absmax / 127.0
    q = torch.round(xf / scale)
    q = torch.where(torch.isnan(q), 0.0, q)
    x_q = q.clamp(-127, 127).to(torch.int8)
    return x_q, scale
