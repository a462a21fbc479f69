"""TL2-style two-trit LUT matmul: 9-entry pair tables, base-9 packed words.

Trit pairs are base-9 digits ``d = (t0+1)·3 + (t1+1)``; five digits pack into
one 16-bit word (``9^5 = 59049``), 1.6 bits per weight.  torch's uint16
supports few operations, so words are held as int16 with the same bits; the
CUDA kernel reads them as ``unsigned short`` and the plain version widens
them with ``& 0xFFFF``.

:func:`tl2_matmul` is the CUDA kernel's wrapper (``csrc/tl2_matmul.cu``);
:func:`tl2_matmul_torch` is its plain PyTorch version, used for CPU tensors
and as the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.encoding import unpack_base3

#: base-9 digits per packed word
PAIRS_PER_WORD = 5
#: trits per packed word → 16 / 10 = 1.6 bits per weight
TRITS_PER_WORD = 2 * PAIRS_PER_WORD


def pack_tl2(w_t: torch.Tensor) -> torch.Tensor:
    """Pack ternary {-1,0,1} → int16-held 16-bit words, 10 trits per word
    (last axis zero-padded to a multiple of 10; zero trits are digit 4, whose
    table entry is identically 0)."""
    *lead, N = w_t.shape
    pad = (-N) % TRITS_PER_WORD
    if pad:
        w_t = torch.nn.functional.pad(w_t, (0, pad))
    pairs = w_t.reshape(*lead, -1, 2).to(torch.int32) + 1
    digits = pairs[..., 0] * 3 + pairs[..., 1]
    grp = digits.reshape(*lead, -1, PAIRS_PER_WORD)
    powers = torch.tensor([9**i for i in range(PAIRS_PER_WORD)],
                          dtype=torch.int32, device=w_t.device)
    v = (grp * powers).sum(-1)
    return torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16)


def repack_base3_to_tl2(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Base-3 bytes ``[..., ceil(n/5)]`` → TL2 words ``[..., ceil(n/10)]``."""
    return pack_tl2(unpack_base3(packed, n))


def unpack_tl2_digits(words: torch.Tensor) -> torch.Tensor:
    """16-bit words [..., W] → base-9 pair digits int32 [..., W*5]."""
    v = words.to(torch.int32) & 0xFFFF
    digs = []
    for _ in range(PAIRS_PER_WORD):
        digs.append(v % 9)
        v = v // 9
    return torch.stack(digs, dim=-1).reshape(*words.shape[:-1], -1)


def unpack_tl2(words: torch.Tensor, n: int, dtype=torch.int8) -> torch.Tensor:
    """16-bit words [..., ceil(n/10)] → trits [..., n] in ``dtype``."""
    d = unpack_tl2_digits(words)
    trits = torch.stack([d // 3 - 1, d % 3 - 1], dim=-1)
    return trits.reshape(*words.shape[:-1], -1)[..., :n].to(dtype)


@functools.lru_cache(maxsize=None)
def _combo9_np() -> np.ndarray:
    """[9, 2] int8: row d = the trit pair encoded by base-9 digit d."""
    d = np.arange(9, dtype=np.int64)
    return np.stack([d // 3 - 1, d % 3 - 1], axis=1).astype(np.int8)


def _pad_x(x: torch.Tensor, full: int) -> torch.Tensor:
    if x.shape[1] > full:
        raise ValueError(f"x has {x.shape[1]} columns, more than the "
                         f"{full} the packed words cover")
    x = x.to(torch.float32)
    if x.shape[1] < full:
        x = torch.nn.functional.pad(x, (0, full - x.shape[1]))
    return x


def tl2_matmul_torch(x: torch.Tensor, words: torch.Tensor, n: int) -> torch.Tensor:
    """Plain TL2 matmul: ``y[b, o] = Σ_k x[b, k] · trits(words)[o, k]``.

    Same arithmetic as the kernel: per-pair 9-entry tables (build), each
    word's digits select one entry per pair (fetch), f32 sums.  x: [B, N']
    f32/bf16/int8 (zero-padded to ``W*10``); words: [O, W].  Returns [B, O]
    f32."""
    B = x.shape[0]
    O, W = words.shape
    x = _pad_x(x, W * TRITS_PER_WORD)
    C9 = torch.from_numpy(_combo9_np()).to(x.device, torch.float32)
    tables = x.reshape(B, -1, 2) @ C9.T                       # [B, G, 9]
    digits = unpack_tl2_digits(words)                         # [O, G]
    oh = torch.nn.functional.one_hot(digits.long(), 9).to(torch.float32)
    return tables.reshape(B, -1) @ oh.reshape(O, -1).T        # [B, O]


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and typed on first use."""
    from repro_torch.kernels._build import load

    fn = load("tl2_matmul").tl2_matmul_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def tl2_matmul(x: torch.Tensor, words: torch.Tensor, n: int) -> torch.Tensor:
    """TL2 matmul through the CUDA kernel for CUDA tensors (``launches``
    counts the launches); CPU tensors take :func:`tl2_matmul_torch`.  Any
    other device raises.  Returns unscaled [B, O] f32."""
    if x.device.type == "cpu" and words.device.type == "cpu":
        return tl2_matmul_torch(x, words, n)
    if x.device.type != "cuda" or words.device != x.device:
        raise ValueError(f"tl2_matmul runs on CUDA (kernel) or CPU (plain); "
                         f"got x on {x.device}, words on {words.device}")
    if words.dtype != torch.int16 or words.ndim != 2 or x.ndim != 2:
        raise ValueError(f"expected x [B, K] and int16 words [O, W]; got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(words.shape)} "
                         f"{words.dtype}")
    B = x.shape[0]
    O, W = words.shape
    xp = _pad_x(x, W * TRITS_PER_WORD).contiguous()
    words = words.contiguous()
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    rc = _kernel()(xp.data_ptr(), words.data_ptr(), out.data_ptr(), B, O, W,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tl2_matmul kernel launch failed: CUDA error {rc}")
    tl2_matmul.launches += 1
    return out


tl2_matmul.launches = 0
