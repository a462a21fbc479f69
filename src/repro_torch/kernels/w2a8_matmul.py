"""W1.58A8 matmul: int8 activations against base-3 packed trits, exact
int32 sums (the paper's Table I operating point).

Activations arrive as int8 with a per-token f32 scale, weights as base-3
bytes (1.6 bits per weight); the product is exact in int32 (the largest
sum, 6912 · 127 at bitnet's widest K, is far inside it) and both scales are
a rank-1 correction on the way out.

:func:`w2a8_matmul` is the CUDA kernel's wrapper (``csrc/w2a8_matmul.cu``);
:func:`w2a8_matmul_torch` is its plain PyTorch version, used for CPU tensors
and as the kernel's reference on the card; :func:`w2a8_linear` is the whole
linear (quantize, product, rescale).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import TRITS_PER_BYTE, unpack_base3_to
from repro_torch.core.quantization import quantize_activations_int8


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and typed on first use."""
    from repro_torch.kernels._build import load

    fn = load("w2a8_matmul").w2a8_matmul_s32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def w2a8_matmul(x_q: torch.Tensor, packed: torch.Tensor, n: int) -> torch.Tensor:
    """Exact int8 × trit product through the CUDA kernel for CUDA tensors
    (``launches`` counts the launches); CPU tensors take
    :func:`w2a8_matmul_torch`.  Any other device, and activations that are
    not int8, raise.  The kernel masks by x's columns, so x needs no
    padding.  Returns unscaled [B, O] int32."""
    if x_q.device.type == "cpu" and packed.device.type == "cpu":
        return w2a8_matmul_torch(x_q, packed, n)
    if x_q.device.type != "cuda" or packed.device != x_q.device:
        raise ValueError(f"w2a8_matmul runs on CUDA (kernel) or CPU (plain); "
                         f"got x on {x_q.device}, packed on {packed.device}")
    if packed.dtype != torch.uint8 or packed.ndim != 2 or x_q.ndim != 2:
        raise ValueError(f"expected x [B, K] and uint8 packed [O, NB]; got "
                         f"{tuple(x_q.shape)}, {tuple(packed.shape)} "
                         f"{packed.dtype}")
    B, N, O, NB = _check(x_q, packed, n)
    x_q = x_q.contiguous()
    packed = packed.contiguous()
    out = torch.empty((B, O), dtype=torch.int32, device=x_q.device)
    rc = _kernel()(x_q.data_ptr(), packed.data_ptr(), out.data_ptr(), B, O, N,
                   NB, torch.cuda.current_stream(x_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w2a8_matmul kernel launch failed: CUDA error {rc}")
    w2a8_matmul.launches += 1
    return out


w2a8_matmul.launches = 0


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
