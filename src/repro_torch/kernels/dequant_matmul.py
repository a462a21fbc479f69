"""Packed-ternary dequantize + matmul: the paper's dequant baseline on the
1.6 bit-per-weight serving artifact.

Weights stream as base-3 bytes (five trits each); each byte is decoded to
its trits and every weight multiplies the activations, with f32
accumulation (on the card, trits decoded to +1, 0 or -1 straight into the
bf16 tensor cores' fragments, exact).

:func:`packed_matmul` is the CUDA kernel's wrapper
(``csrc/packed_matmul.cu``, which ``w2a8`` shares); :func:`packed_matmul_torch`
is its plain PyTorch version, used for CPU tensors and as the kernel's
reference on the card.  :func:`fragment_trits` models the K order the
kernel feeds the tensor cores.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.encoding import TRITS_PER_BYTE, unpack_base3_to
from repro_torch.kernels.operands import X_KIND, aligned_rows

#: packed bytes of a row that one warp decodes a step: lane t of a quad
#: holds the 4-byte words at bytes 4t and 16 + 4t (20 trits each)
WARP_BYTES = 32


def fragment_trits(mma: str) -> np.ndarray:
    """The CUDA kernels' K order over one warp's ``WARP_BYTES`` bytes (160
    trits) of a row: entry ``[i, k]`` is the trit (0..159) that MMA ``i``
    takes as its k-th value, alike for the trits (A) and x (B).

    ``"bf16"`` (``dequant_packed``, m16n8k16, 10 MMAs): lane t's k slots
    {2t, 2t+1, 2t+8, 2t+9} of MMA (c, s) = 5c + s are trits 80c + 20t + 4s +
    {0, 1, 2, 3}.  ``"s8"`` (``w2a8``, m16n8k32, 5 MMAs): lane t's slots
    4t + {0..3} of MMA s are trits 20t + 4s + {0..3}, slots 4t + 16 + {0..3}
    the same 80 trits on.  So each lane's A values come out of its own two
    words and its B values are contiguous runs of x."""
    if mma == "bf16":
        order = np.empty((10, 16), np.int64)
        for c in range(2):
            for s in range(5):
                for t in range(4):
                    base = 80 * c + 20 * t + 4 * s
                    order[5 * c + s, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = \
                        base + np.arange(4)
        return order
    if mma == "s8":
        order = np.empty((5, 32), np.int64)
        for s in range(5):
            for t in range(4):
                for c in range(2):
                    order[s, 16 * c + 4 * t + np.arange(4)] = \
                        80 * c + 20 * t + 4 * s + np.arange(4)
        return order
    raise ValueError(f"unknown MMA {mma!r}: 'bf16' or 's8'")


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
def _kernel(entry: str):
    """The C entry point ``entry`` of ``csrc/packed_matmul.cu``, built and
    typed on first use."""
    from repro_torch.kernels._build import load

    fn = getattr(load("packed_matmul"), entry)
    fn.restype = ctypes.c_int
    kind = [ctypes.c_int] if entry == "dequant_packed_matmul_f32" else []
    fn.argtypes = ([ctypes.c_void_p] + kind + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    return fn


#: the grid of the last launch, written by the C entry: (column tiles, K
#: splits, row tiles, threads a block)
_GRID = (ctypes.c_int * 4)()


def launch_packed(wrapper, entry: str, x: torch.Tensor, packed: torch.Tensor,
                  n: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``entry`` of ``csrc/packed_matmul.cu`` on CUDA
    tensors, count the launch on ``wrapper`` and keep its grid in
    ``wrapper.last_grid``; any device but CUDA raises.  x and the bytes are
    read where they lie (served bf16 x and 128-byte padded rows are neither
    cast nor copied): rows are copied only where they are not 16-byte
    aligned (:func:`aligned_rows`), and x only cast where the kernel has no
    instantiation for its dtype.  Returns the unscaled [B, O] product."""
    if x.device.type != "cuda" or packed.device != x.device:
        raise ValueError(f"{wrapper.__name__} runs on CUDA (kernel) or CPU "
                         f"(plain); got x on {x.device}, packed on "
                         f"{packed.device}")
    if packed.dtype != torch.uint8 or packed.ndim != 2 or x.ndim != 2:
        raise ValueError(f"expected x [B, K] and uint8 packed [O, NB]; got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)} "
                         f"{packed.dtype}")
    B, N, O, NB = _check(x, packed, n)
    out = torch.empty((B, O), dtype=out_dtype, device=x.device)
    if B == 0 or O == 0 or N == 0:
        return out.zero_()
    if x.dtype not in X_KIND:
        x = x.to(torch.float32)
    (x, ldx), (packed, ldp) = aligned_rows(x), aligned_rows(packed)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # dequant_packed takes x's dtype; w2a8 reads int8 only
    kind = (X_KIND[x.dtype],) if entry == "dequant_packed_matmul_f32" else ()
    rc = _kernel(entry)(x.data_ptr(), *kind, packed.data_ptr(), out.data_ptr(),
                        B, O, N, NB, ldx, ldp, stream, _GRID)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")
    wrapper.launches += 1
    wrapper.last_grid = tuple(_GRID)
    return out


def packed_matmul(x: torch.Tensor, packed: torch.Tensor, n: int) -> torch.Tensor:
    """Packed matmul through the CUDA kernel for CUDA tensors (``launches``
    counts the launches, ``last_grid`` keeps the last grid); CPU tensors
    take :func:`packed_matmul_torch`.  Any other device raises.  x is read
    as it is where it is f32, bf16 or int8 (any other dtype is cast to
    f32), at any width ``n <= N <= 5·NB``; the kernel masks by x's columns,
    so x needs no padding.  Returns unscaled [B, O] f32."""
    if x.device.type == "cpu" and packed.device.type == "cpu":
        return packed_matmul_torch(x, packed, n)
    return launch_packed(packed_matmul, "dequant_packed_matmul_f32", x, packed,
                         n, torch.float32)


packed_matmul.launches = 0
packed_matmul.last_grid = None
