"""BitNet b1.58 ternary quantization (paper §II-A).

Weights: per-tensor absmean scale, then round-to-nearest ternary.
Activations: per-token absmax INT8.  Both follow the reference arithmetic
step for step (the scale in the weight's dtype, the activation math in f32),
so trits and int8 codes agree with it exactly.

For QAT the fake-quantizers pass gradients straight through: the
``autograd.Function`` forms (:func:`ste_ternarize`,
:func:`ste_quantize_activations`) with an identity backward, and the
stop-gradient forms the model's linears use (:func:`fake_quant_ternary`,
:func:`fake_quant_acts`), ``w + (wq - w).detach()``, which round as the
reference's ``w + stop_gradient(wq - w)`` does (in bf16 that is not
bitwise ``wq``).
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


class _SteTernarize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        w_t, scale = ternarize(w)
        return dequantize(w_t, scale, dtype=w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_ternarize(w: torch.Tensor) -> torch.Tensor:
    """Fake-quantized weights for QAT: forward ``dequant(ternarize(w))``,
    backward the identity (the straight-through estimator)."""
    return _SteTernarize.apply(w)


def fake_quant_ternary(w: torch.Tensor, axis=None) -> torch.Tensor:
    """Straight-through weight fake-quant via the stop-gradient identity,
    ``w + (dequant(ternarize(w)) - w).detach()`` (``axis`` for per-channel
    scales, e.g. per expert on stacked MoE weights)."""
    w_t, scale = ternarize(w.detach(), axis=axis)
    wq = dequantize(w_t, scale, dtype=w.dtype)
    return w + (wq - w).detach()


def fake_quant_acts(x: torch.Tensor) -> torch.Tensor:
    """Straight-through INT8 per-token activation fake-quant (the
    stop-gradient identity)."""
    x_q, scale = quantize_activations_int8(x.detach())
    xq = (x_q.to(torch.float32) * scale).to(x.dtype)
    return x + (xq - x).detach()


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


class _SteQuantizeActivations(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x_q, scale = quantize_activations_int8(x)
        return (x_q.to(torch.float32) * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_quantize_activations(x: torch.Tensor) -> torch.Tensor:
    """Fake-quantized INT8 activations, backward the identity."""
    return _SteQuantizeActivations.apply(x)


def fake_quant_matmul(x: torch.Tensor, w: torch.Tensor,
                      quantize_acts: bool = True) -> torch.Tensor:
    """QAT forward of a linear layer, ``act_q(x) @ ternary_q(w)``, both
    quantizers straight-through, so full-precision gradients reach ``x``
    and the master weight ``w``."""
    xq = ste_quantize_activations(x) if quantize_acts else x
    return xq @ ste_ternarize(w)


def ternary_weight_stats(w_t: torch.Tensor,
                         dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Fractions of -1, 0 and +1 among the trits ``w_t`` (their sparsity
    drives the paper's savings)."""
    w_t = w_t.to(torch.int32)
    n = w_t.numel()
    return {name: ((w_t == v).sum() / n).to(dtype)
            for name, v in (("neg", -1), ("zero", 0), ("pos", 1))}
