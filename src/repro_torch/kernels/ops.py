"""Entry points around the raw ternary kernels: the BitNet scale handling.

The kernels work on unscaled trits; ``ternary_linear_*`` apply the absmean
weight scale as a rank-1 correction outside the kernel and return ``x``'s
dtype, and ``encode_*`` are the offline steps from master weights to each
kernel's artifact (``(keys, scale)`` or ``(packed, scale)``).

On CUDA tensors the linears launch the hand-written kernels; on CPU tensors
they run the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding
from repro_torch.core.quantization import ternarize
from repro_torch.kernels.dequant_matmul import packed_matmul
from repro_torch.kernels.lut_matmul import lut_matmul, lut_onehot_matmul
from repro_torch.kernels.signflip_matmul import signflip_matmul


def _rescale(y: torch.Tensor, scale, x: torch.Tensor) -> torch.Tensor:
    y = y * torch.as_tensor(scale, dtype=torch.float32, device=y.device)
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def ternary_linear_lut(x: torch.Tensor, keys: torch.Tensor, scale, mu: int, *,
                       fetch: str = "onehot") -> torch.Tensor:
    """``y = (x @ decode(keys).T) * scale`` through the LUT kernel with the
    ``"onehot"`` or ``"gather"`` fetch.  x: [..., K], K the weight's
    logical width or G·mu."""
    kernels = {"onehot": lut_onehot_matmul, "gather": lut_matmul}
    if fetch not in kernels:
        raise ValueError(f"fetch must be one of {sorted(kernels)}, got {fetch!r}")
    y = kernels[fetch](x.reshape(-1, x.shape[-1]), keys, mu)
    return _rescale(y, scale, x)


def ternary_linear_signflip(x: torch.Tensor, w_t: torch.Tensor,
                            scale) -> torch.Tensor:
    """``y = (x @ w_t.T) * scale`` through the sign-flip kernel.  w_t: [O, K]
    int8 trits."""
    y = signflip_matmul(x.reshape(-1, x.shape[-1]), w_t)
    return _rescale(y, scale, x)


def ternary_linear_packed(x: torch.Tensor, packed: torch.Tensor, scale,
                          n: int) -> torch.Tensor:
    """``y = (x @ unpack(packed, n).T) * scale`` through the dequant kernel."""
    y = packed_matmul(x.reshape(-1, x.shape[-1]), packed, n)
    return _rescale(y, scale, x)


def encode_for_lut(w: torch.Tensor, mu: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline step: master weights ``[O, K]`` → ``(keys, scale)`` for the
    LUT kernel."""
    w_t, scale = ternarize(w)
    return encoding.encode_weight_matrix(w_t, mu), scale


def encode_packed(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline step: master weights → ``(packed, scale)``, the base-3
    deployment artifact."""
    w_t, scale = ternarize(w)
    return encoding.pack_base3(w_t), scale
