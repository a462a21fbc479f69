"""Grouped (batched-expert) packed ternary matmuls: the MoE expert stacks.

Expert weights stay stacked as base-3 bytes ``[E, N, ceil(K/5)+pad]`` (1.6
bits per weight) and one launch covers every expert: each expert's rows
``x[e]`` (its capacity ``C`` of routed tokens, zero rows where fewer came)
meet that expert's trits, decoded from the bytes inside the kernel.

  * :func:`grouped_packed_matmul` — float activations, f32 sums (registry
    ``grouped_dequant``); plain version :func:`grouped_packed_matmul_torch`;
  * :func:`grouped_w2a8_matmul` — int8 activations, exact int32 sums
    (registry ``grouped_w2a8``); plain version
    :func:`grouped_w2a8_matmul_torch`.

Both wrappers launch the CUDA kernels of ``csrc/grouped_matmul.cu`` for CUDA
tensors (``launches`` counts them) and take their plain versions for CPU
tensors, which also serve as the kernels' reference on the card.  Per-expert
weight scales are the caller's rank-1 correction on the way out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import TRITS_PER_BYTE, unpack_base3_to


def _check(x: torch.Tensor, packed: torch.Tensor, n: int):
    if x.ndim != 3 or packed.ndim != 3:
        raise ValueError(f"expected x [E, C, K] and packed [E, N, NB]; got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)}")
    E, C, K = x.shape
    Ep, N, NB = packed.shape
    if E != Ep:
        raise ValueError(f"expert dims differ: x {tuple(x.shape)} vs packed "
                         f"{tuple(packed.shape)}")
    if K < n or NB * TRITS_PER_BYTE < K:
        raise ValueError(f"need n={n} <= x columns {K} <= 5 * packed bytes "
                         f"{NB * TRITS_PER_BYTE}")
    return E, C, K, N, NB


def _per_expert(x: torch.Tensor, packed: torch.Tensor, dtype: torch.dtype):
    """``[E, C, N]`` in ``dtype``: each expert's bytes decoded to ``dtype``
    and multiplied on its own, so one expert's dense ``[N, K]`` is live at
    a time (never the ``[E, N, K]`` stack)."""
    K = x.shape[-1]
    return torch.stack([x[e].to(dtype) @ unpack_base3_to(packed[e], K, dtype).T
                        for e in range(x.shape[0])])


def grouped_packed_matmul_torch(x: torch.Tensor, packed: torch.Tensor,
                                n: int) -> torch.Tensor:
    """Plain ``y[e, c, o] = Σ_k x[e, c, k] · trits(packed[e])[o, k]`` over
    x's columns, in f32.  x: [E, C, K] activations (f32/bf16/int8), ``n <=
    K <= 5·NB`` (columns past the logical ``n`` must be zero); packed:
    [E, N, NB] base-3 bytes.  Returns [E, C, N] f32."""
    _check(x, packed, n)
    return _per_expert(x, packed, torch.float32)


def grouped_w2a8_matmul_torch(x_q: torch.Tensor, packed: torch.Tensor,
                              n: int) -> torch.Tensor:
    """Plain exact ``y[e, c, o] = Σ_k x_q[e, c, k] · trits(packed[e])[o, k]``
    as int32.  The product is taken in f64, which holds every partial sum
    of int8 × trit terms exactly (and runs on both devices, where an
    integer matmul does not).  x_q: [E, C, K] int8; packed: [E, N, NB]."""
    if x_q.dtype != torch.int8:
        raise ValueError(f"grouped_w2a8_matmul takes int8 activations; got "
                         f"{x_q.dtype}")
    _check(x_q, packed, n)
    return _per_expert(x_q, packed, torch.float64).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """A C entry point of ``grouped_matmul.cu``, built and typed on first
    use."""
    from repro_torch.kernels._build import load

    fn = getattr(load("grouped_matmul"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def _launch(wrapper, entry: str, x: torch.Tensor, packed: torch.Tensor,
            n: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Check the operands, allocate the output and launch ``entry``; adds
    one to ``wrapper.launches`` for the launch."""
    who = wrapper.__name__
    if x.device.type != "cuda" or packed.device != x.device:
        raise ValueError(f"{who} runs on CUDA (kernel) or CPU (plain); got x "
                         f"on {x.device}, packed on {packed.device}")
    if packed.dtype != torch.uint8:
        raise ValueError(f"{who} takes uint8 packed bytes; got {packed.dtype}")
    E, C, K, N, NB = _check(x, packed, n)
    x = x.contiguous()
    packed = packed.contiguous()
    out = torch.empty((E, C, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = _kernel(entry)(x.data_ptr(), packed.data_ptr(), out.data_ptr(), E, C,
                        N, K, NB, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def grouped_packed_matmul(x: torch.Tensor, packed: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Grouped packed matmul through the CUDA kernel for CUDA tensors
    (``launches`` counts the launches); CPU tensors take
    :func:`grouped_packed_matmul_torch`.  Any other device raises.  The
    kernel masks by x's columns, so x needs no padding.  Returns unscaled
    [E, C, N] f32."""
    if x.device.type == "cpu" and packed.device.type == "cpu":
        return grouped_packed_matmul_torch(x, packed, n)
    return _launch(grouped_packed_matmul, "grouped_dequant_matmul_f32",
                   x.to(torch.float32), packed, n, torch.float32)


grouped_packed_matmul.launches = 0


def grouped_w2a8_matmul(x_q: torch.Tensor, packed: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Exact grouped int8 × trit product through the CUDA kernel for CUDA
    tensors (``launches`` counts the launches); CPU tensors take
    :func:`grouped_w2a8_matmul_torch`.  Any other device, and activations
    that are not int8, raise.  Returns unscaled [E, C, N] int32."""
    if x_q.device.type == "cpu" and packed.device.type == "cpu":
        return grouped_w2a8_matmul_torch(x_q, packed, n)
    if x_q.dtype != torch.int8:
        raise ValueError(f"grouped_w2a8_matmul takes int8 activations; got "
                         f"{x_q.dtype}")
    return _launch(grouped_w2a8_matmul, "grouped_w2a8_matmul_i32", x_q,
                   packed, n, torch.int32)


grouped_w2a8_matmul.launches = 0
