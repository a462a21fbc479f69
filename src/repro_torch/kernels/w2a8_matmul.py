"""W1.58A8 matmul: int8 activations against base-3 packed trits, exact
int32 sums (the paper's Table I operating point).

Activations arrive as int8 with a per-token f32 scale, weights as base-3
bytes (1.6 bits per weight); the product is exact in int32 (the largest
sum, 6912 · 127 at bitnet's widest K, is far inside it) and both scales are
a rank-1 correction on the way out.

:func:`w2a8_matmul` is the CUDA kernel's wrapper (``csrc/packed_matmul.cu``,
which ``dequant_packed`` shares; the int8 tensor cores);
:func:`w2a8_matmul_torch` is its plain PyTorch version, used for CPU tensors
and as the kernel's reference on the card; :func:`w2a8_linear` is the whole
linear (quantize, product, rescale).
"""

from __future__ import annotations

import torch

from repro_torch.core.encoding import TRITS_PER_BYTE, unpack_base3_to
from repro_torch.core.quantization import quantize_activations_int8
from repro_torch.kernels.dequant_matmul import launch_packed


def _check(x_q: torch.Tensor, packed: torch.Tensor, n: int):
    if x_q.dtype != torch.int8:
        raise ValueError(f"w2a8_matmul takes int8 activations; got {x_q.dtype}")
    B, N = x_q.shape
    O, NB = packed.shape
    if N < n or NB * TRITS_PER_BYTE < N:
        raise ValueError(f"need n={n} <= x columns {N} <= 5 * packed bytes "
                         f"{NB * TRITS_PER_BYTE}")
    return B, N, O, NB


def w2a8_matmul_torch(x_q: torch.Tensor, packed: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain exact ``y[b, o] = Σ_k x_q[b, k] · trits(packed)[o, k]`` as
    int32.  The product is taken in f64, which holds every partial sum of
    int8 × trit terms exactly (and runs on both devices, where an integer
    matmul does not).  x_q: [B, N] int8, ``n <= N <= 5·NB``; packed: [O, NB]
    base-3 bytes."""
    _, N, _, _ = _check(x_q, packed, n)
    w = unpack_base3_to(packed, N, torch.float64)              # [O, N]
    return (x_q.to(torch.float64) @ w.T).to(torch.int32)


def w2a8_matmul(x_q: torch.Tensor, packed: torch.Tensor, n: int) -> torch.Tensor:
    """Exact int8 × trit product through the CUDA kernel for CUDA tensors
    (``launches`` counts the launches, ``last_grid`` keeps the last grid);
    CPU tensors take :func:`w2a8_matmul_torch`.  Any other device, and
    activations that are not int8, raise before any launch.  x is read as
    it is, at any width ``n <= N <= 5·NB``; the kernel masks by x's
    columns, so x needs no padding.  Returns unscaled [B, O] int32."""
    if x_q.device.type == "cpu" and packed.device.type == "cpu":
        return w2a8_matmul_torch(x_q, packed, n)
    _check(x_q, packed, n)
    return launch_packed(w2a8_matmul, "w2a8_matmul_s32", x_q, packed, n,
                         torch.int32)


w2a8_matmul.launches = 0
w2a8_matmul.last_grid = None


def w2a8_linear(x: torch.Tensor, packed: torch.Tensor, w_scale,
                n: int) -> torch.Tensor:
    """Full W1.58A8 linear: quantize activations per token → exact int
    product → rank-1 rescale by both scales.  x: [..., n]; returns
    ``[..., O]`` in x's dtype."""
    lead = x.shape[:-1]
    x_q, x_scale = quantize_activations_int8(x.reshape(-1, x.shape[-1]))
    y = w2a8_matmul(x_q, packed, n).to(torch.float32) * x_scale
    y = y * torch.as_tensor(w_scale, dtype=torch.float32, device=y.device)
    return y.reshape(*lead, -1).to(x.dtype)
