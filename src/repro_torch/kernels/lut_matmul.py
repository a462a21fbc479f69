"""Two-phase LUT ternary matmul (paper Fig. 2/3), gather fetch.

* **Build phase**: for each group of ``mu`` activations, the ``T+1`` table
  entries ``x_g · C[t]`` (``C`` = :func:`repro_torch.core.encoding.combo_matrix_np`,
  row ``T`` all zero).
* **Fetch phase**: each weight key splits into ``sym``/``idx``; ``idx``
  selects one table entry, ``sym`` negates it, and the entries accumulate in
  f32.

:func:`lut_matmul` is the CUDA kernel's wrapper (``csrc/lut_matmul.cu``);
:func:`lut_matmul_torch` is its plain PyTorch version, used for CPU tensors
and as the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import encoding

#: the group size the CUDA kernel is built for (every served config's mu)
KERNEL_MU = 3


def _check(x: torch.Tensor, keys: torch.Tensor, mu: int):
    B, N = x.shape
    O, G = keys.shape
    if N != G * mu:
        raise ValueError(f"N={N} != G*mu={G * mu}")
    return B, O, G


def lut_matmul_torch(x: torch.Tensor, keys: torch.Tensor, mu: int) -> torch.Tensor:
    """Plain LUT matmul: ``y[b, o] = Σ_n x[b, n] · decode(keys)[o, n]``.

    x: [B, G·mu] activations (f32/bf16/int8); keys: [O, G]
    (:func:`encoding.encode_weight_matrix`).  Returns [B, O] f32."""
    B, O, G = _check(x, keys, mu)
    C = torch.from_numpy(encoding.combo_matrix_np(mu)).to(x.device, torch.float32)
    tables = x.to(torch.float32).reshape(B, G, mu) @ C.T       # [B, G, T+1]
    ib = encoding.idx_bits(mu)
    k = keys.to(torch.int32) & 0xFFFF
    idx = (k & ((1 << ib) - 1)).long()                         # [O, G]
    sign = torch.where((k >> ib) == 1, -1.0, 1.0)              # [O, G]
    g = torch.arange(G, device=x.device)
    fetched = tables[:, g[None, :], idx]                       # [B, O, G]
    return (fetched * sign).sum(-1)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and typed on first use."""
    from repro_torch.kernels._build import load

    fn = load("lut_matmul").lut_gather_matmul_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def lut_matmul(x: torch.Tensor, keys: torch.Tensor, mu: int) -> torch.Tensor:
    """LUT matmul (gather fetch) through the CUDA kernel for CUDA tensors
    (``launches`` counts the launches); CPU tensors take
    :func:`lut_matmul_torch`.  Any other device raises.  Returns unscaled
    [B, O] f32."""
    if x.device.type == "cpu" and keys.device.type == "cpu":
        return lut_matmul_torch(x, keys, mu)
    if x.device.type != "cuda" or keys.device != x.device:
        raise ValueError(f"lut_matmul runs on CUDA (kernel) or CPU (plain); "
                         f"got x on {x.device}, keys on {keys.device}")
    if keys.dtype != torch.uint8 or mu != KERNEL_MU:
        raise ValueError(f"the CUDA LUT kernel takes uint8 keys at mu="
                         f"{KERNEL_MU}; got {keys.dtype} keys at mu={mu}")
    B, O, G = _check(x, keys, mu)
    xf = x.to(torch.float32).contiguous()
    keys = keys.contiguous()
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    rc = _kernel()(xf.data_ptr(), keys.data_ptr(), out.data_ptr(), B, O, G, mu,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lut_matmul kernel launch failed: CUDA error {rc}")
    lut_matmul.launches += 1
    return out


lut_matmul.launches = 0
