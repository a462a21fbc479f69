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
reference on the card.  All four take x of the weight's logical width K
(the last group short: ``G·mu − mu < K ≤ G·mu``) or zero-padded to
``G·mu``, and keys at any row stride (served keys are a view of rows padded
to 16 bytes, :meth:`repro_torch.kernels.dispatch.TernaryWeight.keys`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import encoding
from repro_torch.kernels.operands import X_KIND, aligned_rows

#: the group size the CUDA kernel is built for (every served config's mu)
KERNEL_MU = 3


def _check(x: torch.Tensor, keys: torch.Tensor, mu: int):
    """``x [B, K]`` against keys ``[O, G]``: K is the logical width
    (``G·mu − mu < K ≤ G·mu``, the last group short) or the padded ``G·mu``."""
    B, K = x.shape
    O, G = keys.shape
    if not G * mu - mu < K <= G * mu:
        raise ValueError(f"x width K={K} does not fill G={G} groups of "
                         f"mu={mu} (needs {G * mu - mu} < K <= {G * mu})")
    return B, O, G


def _padded(x: torch.Tensor, G: int, mu: int) -> torch.Tensor:
    """``x`` zero-padded to ``G·mu`` columns (the plain versions' tables)."""
    pad = G * mu - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


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

    x: [B, K] activations (f32/bf16/int8), K the logical width or padded
    to G·mu (zero-padded here); keys: [O, G]
    (:func:`encoding.encode_weight_matrix`).  Returns [B, O] f32."""
    B, O, G = _check(x, keys, mu)
    tables = _tables(_padded(x, G, mu), B, G, mu)              # [B, G, T+1]
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
    tables = _tables(_padded(x, G, mu), B, G, mu)              # [B, G, T+1]
    idx, sign = _split_keys(keys, mu)
    onehot = torch.nn.functional.one_hot(idx, tables.shape[-1]) * sign[..., None]
    return tables.reshape(B, -1) @ onehot.reshape(O, -1).T


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    """The C entry point ``entry``, built and typed on first use."""
    from repro_torch.kernels._build import load

    fn = getattr(load("lut_matmul"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    return fn


#: the grid of the last launch, written by the C entry: (column tiles, K
#: splits, row tiles, threads a block)
_GRID = (ctypes.c_int * 4)()


def _launch(wrapper, entry: str, plain, x: torch.Tensor, keys: torch.Tensor,
            mu: int) -> torch.Tensor:
    """CPU tensors take ``plain``; CUDA tensors launch ``entry``, count
    the launch on ``wrapper`` and keep its grid in ``wrapper.last_grid``;
    any other device raises.  On the card x and
    the keys are read where they lie (served bf16 x and keys are neither
    cast nor copied): rows are copied only where they are not 16-byte
    aligned (:func:`aligned_rows`), and x only cast where the kernel has no
    instantiation for its dtype."""
    if x.device.type == "cpu" and keys.device.type == "cpu":
        return plain(x, keys, mu)
    if x.device.type != "cuda" or keys.device != x.device:
        raise ValueError(f"{wrapper.__name__} runs on CUDA (kernel) or CPU "
                         f"(plain); got x on {x.device}, keys on {keys.device}")
    if keys.dtype != torch.uint8 or mu != KERNEL_MU:
        raise ValueError(f"the CUDA LUT kernel takes uint8 keys at mu="
                         f"{KERNEL_MU}; got {keys.dtype} keys at mu={mu}")
    B, O, G = _check(x, keys, mu)
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0 or G == 0:
        return out.zero_()
    if x.dtype not in X_KIND:
        x = x.to(torch.float32)
    (x, ldx), (keys, ldk) = aligned_rows(x), aligned_rows(keys)
    rc = _kernel(entry)(x.data_ptr(), X_KIND[x.dtype], keys.data_ptr(),
                        out.data_ptr(), B, O, x.shape[1], G, mu, ldx, ldk,
                        torch.cuda.current_stream(x.device).cuda_stream, _GRID)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")
    wrapper.launches += 1
    wrapper.last_grid = tuple(_GRID)
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
lut_matmul.last_grid = lut_onehot_matmul.last_grid = None
