"""Sign-flip ternary matmul: the paper's Fig. 1 baseline, in which each
multiplier becomes a 3:1 mux of ``{+x, -x, 0}`` feeding an adder.

Weights stream as int8 trits (one byte per weight); every product is a
conditional add, subtract or skip, with f32 accumulation (on the card, a
product by a trit decoded to +1, 0 or -1 on the tensor cores, exact).

:func:`signflip_matmul` is the CUDA kernel's wrapper
(``csrc/signflip_matmul.cu``); :func:`signflip_matmul_torch` is its plain
PyTorch version, used for CPU tensors and as the kernel's reference on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.operands import X_KIND, aligned_rows as _rows


def signflip_matmul_torch(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """Plain sign-flip matmul, written as the mux-select it models:
    ``y[b, o] = Σ_k (x[b, k] if w[o, k] > 0 else -x[b, k] if w[o, k] < 0
    else 0)`` in f32.  x: [B, K] (f32/bf16/int8); w_t: [O, K] int8 trits.
    Returns [B, O] f32."""
    if x.shape[-1] != w_t.shape[-1]:
        raise ValueError(f"x K={x.shape[-1]} != weight K={w_t.shape[-1]}")
    xe = x.to(torch.float32)[:, None, :]                       # [B, 1, K]
    sel = torch.where(w_t > 0, xe, torch.where(w_t < 0, -xe,
                                               torch.zeros_like(xe)))
    return sel.sum(-1)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and typed on first use."""
    from repro_torch.kernels._build import load

    fn = load("signflip_matmul").signflip_matmul_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p])
    return fn


def signflip_matmul(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """Sign-flip matmul through the CUDA kernel for CUDA tensors
    (``launches`` counts the launches); CPU tensors take
    :func:`signflip_matmul_torch`.  Any other device raises.  Returns
    unscaled [B, O] f32."""
    if x.device.type == "cpu" and w_t.device.type == "cpu":
        return signflip_matmul_torch(x, w_t)
    if x.device.type != "cuda" or w_t.device != x.device:
        raise ValueError(f"signflip_matmul runs on CUDA (kernel) or CPU "
                         f"(plain); got x on {x.device}, trits on {w_t.device}")
    if w_t.dtype != torch.int8 or w_t.ndim != 2 or x.ndim != 2 or \
            x.shape[1] != w_t.shape[1]:
        raise ValueError(f"expected x [B, K] and int8 trits [O, K]; got "
                         f"{tuple(x.shape)}, {tuple(w_t.shape)} {w_t.dtype}")
    B, K = x.shape
    O = w_t.shape[0]
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0 or K == 0:
        return out.zero_()
    # f32 x splits into three bf16 terms in the kernel, bf16 and int8 x are
    # one exact term
    if x.dtype not in X_KIND:
        x = x.to(torch.float32)
    (x, ldx), (w_t, ldw) = _rows(x), _rows(w_t)
    rc = _kernel()(x.data_ptr(), X_KIND[x.dtype], w_t.data_ptr(),
                   out.data_ptr(), B, O, K, ldx, ldw,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"signflip_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    signflip_matmul.launches += 1
    return out


signflip_matmul.launches = 0
