"""Packed-ternary dequantize + matmul: the paper's dequant baseline on the
1.6 bit-per-weight serving artifact.

Weights stream as base-3 bytes (five trits each); each byte is decoded to
its trits by div/mod 3 and every weight is multiplied against f32
activations, with f32 accumulation.

:func:`packed_matmul` is the CUDA kernel's wrapper
(``csrc/dequant_matmul.cu``); :func:`packed_matmul_torch` is its plain
PyTorch version, used for CPU tensors and as the kernel's reference on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import TRITS_PER_BYTE, unpack_base3_to


def _check(x: torch.Tensor, packed: torch.Tensor, n: int):
    B, N = x.shape
    O, NB = packed.shape
    if N < n or NB * TRITS_PER_BYTE < N:
        raise ValueError(f"need n={n} <= x columns {N} <= 5 * packed bytes "
                         f"{NB * TRITS_PER_BYTE}")
    return B, N, O, NB


def packed_matmul_torch(x: torch.Tensor, packed: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Plain packed matmul: ``y[b, o] = Σ_k x[b, k] · unpack(packed)[o, k]``
    over x's columns, in f32.

    x: [B, N] activations (f32/bf16/int8), ``n <= N <= 5·NB`` (columns past
    the logical ``n`` must be zero, as the reference's zero padding makes
    them); packed: [O, NB] base-3 bytes.  Returns [B, O] f32."""
    _, N, _, _ = _check(x, packed, n)
    w = unpack_base3_to(packed, N, torch.float32)              # [O, N]
    return x.to(torch.float32) @ w.T


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and typed on first use."""
    from repro_torch.kernels._build import load

    fn = load("dequant_matmul").dequant_packed_matmul_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def packed_matmul(x: torch.Tensor, packed: torch.Tensor, n: int) -> torch.Tensor:
    """Packed matmul through the CUDA kernel for CUDA tensors (``launches``
    counts the launches); CPU tensors take :func:`packed_matmul_torch`.  Any
    other device raises.  The kernel masks by x's columns, so x needs no
    padding.  Returns unscaled [B, O] f32."""
    if x.device.type == "cpu" and packed.device.type == "cpu":
        return packed_matmul_torch(x, packed, n)
    if x.device.type != "cuda" or packed.device != x.device:
        raise ValueError(f"packed_matmul runs on CUDA (kernel) or CPU "
                         f"(plain); got x on {x.device}, packed on "
                         f"{packed.device}")
    if packed.dtype != torch.uint8 or packed.ndim != 2 or x.ndim != 2:
        raise ValueError(f"expected x [B, K] and uint8 packed [O, NB]; got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)} "
                         f"{packed.dtype}")
    B, N, O, NB = _check(x, packed, n)
    xf = x.to(torch.float32).contiguous()
    packed = packed.contiguous()
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    rc = _kernel()(xf.data_ptr(), packed.data_ptr(), out.data_ptr(), B, O, N,
                   NB, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
