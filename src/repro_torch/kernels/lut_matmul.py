"""Two-phase LUT ternary matmul (paper Fig. 2/3), both fetch lowerings.

* **Build phase**: for each group of ``mu`` activations, the ``T+1`` table
  entries ``x_g · C[t]`` (``C`` = :func:`repro_torch.core.encoding.combo_matrix_np`,
  row ``T`` all zero).
* **Fetch phase**: each weight key splits into ``sym``/``idx``.
  - gather (``lut_gather``): ``idx`` selects one table entry, ``sym``
    negates it, and the entries accumulate in f32;
  - onehot (``lut_onehot``): the tables are contracted with the signed
    one-hot ``[O, G, T+1]`` of the keys (``sym`` folded into the one-hot's
    values), the reference's MXU lowering.

:func:`lut_matmul` and :func:`lut_onehot_matmul` are the wrappers of the
CUDA kernel's two entry points (``csrc/lut_matmul.cu``), each with its own
launch count; :func:`lut_matmul_torch` and :func:`lut_onehot_matmul_torch`
are their plain PyTorch versions, used for CPU tensors and as the kernel's
reference on the card.
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


def _tables(x: torch.Tensor, B: int, G: int, mu: int) -> torch.Tensor:
    """Build phase: ``[B, G, T+1]`` f32 tables (entry ``T`` is 0)."""
    C = torch.from_numpy(encoding.combo_matrix_np(mu)).to(x.device, torch.float32)
    return x.to(torch.float32).reshape(B, G, mu) @ C.T


def _split_keys(keys: torch.Tensor, mu: int):
    """Keys → (``idx`` long, ``sign`` ±1.0 f32), both ``[O, G]``."""
    ib = encoding.idx_bits(mu)
    k = keys.to(torch.int32) & 0xFFFF
    idx = (k & ((1 << ib) - 1)).long()
    sign = torch.where((k >> ib) == 1, -1.0, 1.0)
    return idx, sign


def lut_matmul_torch(x: torch.Tensor, keys: torch.Tensor, mu: int) -> torch.Tensor:
    """Plain LUT matmul, gather fetch: ``y[b, o] = Σ_n x[b, n] ·
    decode(keys)[o, n]``.

    x: [B, G·mu] activations (f32/bf16/int8); keys: [O, G]
    (:func:`encoding.encode_weight_matrix`).  Returns [B, O] f32."""
    B, O, G = _check(x, keys, mu)
    tables = _tables(x, B, G, mu)                              # [B, G, T+1]
    idx, sign = _split_keys(keys, mu)                          # [O, G]
    g = torch.arange(G, device=x.device)
    fetched = tables[:, g[None, :], idx]                       # [B, O, G]
    return (fetched * sign).sum(-1)


def lut_onehot_matmul_torch(x: torch.Tensor, keys: torch.Tensor,
                            mu: int) -> torch.Tensor:
    """Plain LUT matmul, one-hot fetch: the ``[B, G·(T+1)]`` tables
    contracted with the signed one-hot ``[O, G·(T+1)]`` of the keys.  Same
    arguments and result as :func:`lut_matmul_torch`."""
    B, O, G = _check(x, keys, mu)
    tables = _tables(x, B, G, mu)                              # [B, G, T+1]
    idx, sign = _split_keys(keys, mu)
    onehot = torch.nn.functional.one_hot(idx, tables.shape[-1]) * sign[..., None]
    return tables.reshape(B, -1) @ onehot.reshape(O, -1).T


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    """The C entry point ``entry``, built and typed on first use."""
    from repro_torch.kernels._build import load

    fn = getattr(load("lut_matmul"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _launch(wrapper, entry: str, plain, x: torch.Tensor, keys: torch.Tensor,
            mu: int) -> torch.Tensor:
    """CPU tensors take ``plain``; CUDA tensors launch ``entry`` and count
    the launch on ``wrapper``; any other device raises."""
    if x.device.type == "cpu" and keys.device.type == "cpu":
        return plain(x, keys, mu)
    if x.device.type != "cuda" or keys.device != x.device:
        raise ValueError(f"{wrapper.__name__} runs on CUDA (kernel) or CPU "
                         f"(plain); got x on {x.device}, keys on {keys.device}")
    if keys.dtype != torch.uint8 or mu != KERNEL_MU:
        raise ValueError(f"the CUDA LUT kernel takes uint8 keys at mu="
                         f"{KERNEL_MU}; got {keys.dtype} keys at mu={mu}")
    B, O, G = _check(x, keys, mu)
    xf = x.to(torch.float32).contiguous()
    keys = keys.contiguous()
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    rc = _kernel(entry)(xf.data_ptr(), keys.data_ptr(), out.data_ptr(), B, O,
                        G, mu, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")
    wrapper.launches += 1
    return out


def lut_matmul(x: torch.Tensor, keys: torch.Tensor, mu: int) -> torch.Tensor:
    """LUT matmul (gather fetch) through the CUDA kernel for CUDA tensors
    (``launches`` counts the launches); CPU tensors take
    :func:`lut_matmul_torch`.  Any other device raises.  Returns unscaled
    [B, O] f32."""
    return _launch(lut_matmul, "lut_gather_matmul_f32", lut_matmul_torch, x,
                   keys, mu)


def lut_onehot_matmul(x: torch.Tensor, keys: torch.Tensor,
                      mu: int) -> torch.Tensor:
    """LUT matmul (signed one-hot fetch) through the CUDA kernel for CUDA
    tensors (``launches`` counts the launches); CPU tensors take
    :func:`lut_onehot_matmul_torch`.  Any other device raises.  Returns
    unscaled [B, O] f32."""
    return _launch(lut_onehot_matmul, "lut_onehot_matmul_f32",
                   lut_onehot_matmul_torch, x, keys, mu)


lut_matmul.launches = 0
lut_onehot_matmul.launches = 0
