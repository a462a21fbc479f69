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

Both wrappers launch the CUDA kernels of ``csrc/grouped_matmul.cu`` (the
tensor-core design of ``csrc/ternary_mma.cuh`` with an expert grid
dimension) for CUDA tensors (``launches`` counts them, ``last_grid`` keeps
the last grid) and take their plain versions for CPU tensors, which also
serve as the kernels' reference on the card.  x (bf16 as served, f32 or
int8) and the served bytes are read where they lie
(:func:`grouped_operands`).  Per-expert weight scales are the caller's
rank-1 correction on the way out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import TRITS_PER_BYTE, unpack_base3_to
from repro_torch.kernels.operands import X_KIND, aligned_rows


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
def _kernel(entry: str):
    """The C entry point ``entry`` of ``csrc/grouped_matmul.cu``, built and
    typed on first use."""
    from repro_torch.kernels._build import load

    fn = getattr(load("grouped_matmul"), entry)
    fn.restype = ctypes.c_int
    kind = [ctypes.c_int] if entry == "grouped_dequant_matmul_f32" else []
    fn.argtypes = ([ctypes.c_void_p] + kind + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    return fn


#: the grid of the last launch, written by the C entry: (column tiles, K
#: splits, experts x row tiles, threads a block)
_GRID = (ctypes.c_int * 4)()


def grouped_operands(x: torch.Tensor, packed: torch.Tensor):
    """x ``[E, C, K]`` and the bytes ``[E, N, NB]`` as the kernels read
    them: ``(x2, ldx, packed2, ldw)``, x as an ``[E·C, K]`` view at row
    stride ``ldx`` (elements) and the bytes as an ``[E·N, NB]`` view at
    row stride ``ldw`` (bytes).  Read in place where the rows lie at one
    stride and start 16-byte aligned (the served bytes, rows padded to 128,
    and the MoE dispatch buffer); copied otherwise (``reshape`` where the
    experts are not one stride apart, :func:`aligned_rows` where the rows
    are not aligned)."""
    E, C, K = x.shape
    _, N, NB = packed.shape
    x2, ldx = aligned_rows(x.reshape(E * C, K))
    p2, ldw = aligned_rows(packed.reshape(E * N, NB))
    return x2, ldx, p2, ldw


def _launch(wrapper, entry: str, x: torch.Tensor, packed: torch.Tensor,
            n: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Check the operands, allocate the output and launch ``entry``; adds
    one to ``wrapper.launches`` for the launch and keeps its grid in
    ``wrapper.last_grid``.  x is read as it is where the kernel has an
    instantiation for its dtype (f32, bf16, int8), else cast to f32; x and
    the bytes are read where they lie (:func:`grouped_operands`)."""
    who = wrapper.__name__
    if x.device.type != "cuda" or packed.device != x.device:
        raise ValueError(f"{who} runs on CUDA (kernel) or CPU (plain); got x "
                         f"on {x.device}, packed on {packed.device}")
    if packed.dtype != torch.uint8:
        raise ValueError(f"{who} takes uint8 packed bytes; got {packed.dtype}")
    E, C, K, N, NB = _check(x, packed, n)
    out = torch.empty((E, C, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    if x.dtype not in X_KIND:
        x = x.to(torch.float32)
    x2, ldx, p2, ldw = grouped_operands(x, packed)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # grouped_dequant takes x's dtype; grouped_w2a8 reads int8 only
    kind = ((X_KIND[x.dtype],) if entry == "grouped_dequant_matmul_f32"
            else ())
    rc = _kernel(entry)(x2.data_ptr(), *kind, p2.data_ptr(), out.data_ptr(),
                        E, C, N, K, NB, ldx, ldw, stream, _GRID)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    wrapper.last_grid = tuple(_GRID)
    return out


def grouped_packed_matmul(x: torch.Tensor, packed: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Grouped packed matmul through the CUDA kernel for CUDA tensors
    (``launches`` counts the launches, ``last_grid`` keeps the last grid);
    CPU tensors take :func:`grouped_packed_matmul_torch`.  Any other device
    raises.  x is read as it is where it is f32, bf16 or int8 (any other
    dtype is cast to f32); the kernel masks by x's columns, so x needs no
    padding.  Returns unscaled [E, C, N] f32."""
    if x.device.type == "cpu" and packed.device.type == "cpu":
        return grouped_packed_matmul_torch(x, packed, n)
    return _launch(grouped_packed_matmul, "grouped_dequant_matmul_f32", x,
                   packed, n, torch.float32)


grouped_packed_matmul.launches = 0
grouped_packed_matmul.last_grid = None


def grouped_w2a8_matmul(x_q: torch.Tensor, packed: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Exact grouped int8 × trit product through the CUDA kernel for CUDA
    tensors (``launches`` counts the launches, ``last_grid`` keeps the last
    grid); CPU tensors take :func:`grouped_w2a8_matmul_torch`.  Any other
    device, and activations that are not int8, raise.  Returns unscaled
    [E, C, N] int32."""
    if x_q.device.type == "cpu" and packed.device.type == "cpu":
        return grouped_w2a8_matmul_torch(x_q, packed, n)
    if x_q.dtype != torch.int8:
        raise ValueError(f"grouped_w2a8_matmul takes int8 activations; got "
                         f"{x_q.dtype}")
    return _launch(grouped_w2a8_matmul, "grouped_w2a8_matmul_i32", x_q,
                   packed, n, torch.int32)


grouped_w2a8_matmul.launches = 0
grouped_w2a8_matmul.last_grid = None
