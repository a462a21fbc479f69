"""TL2-style two-trit LUT matmul: 9-entry pair tables, base-9 packed words.

Trit pairs are base-9 digits ``d = (t0+1)·3 + (t1+1)``; five digits pack into
one 16-bit word (``9^5 = 59049``), 1.6 bits per weight.  torch's uint16
supports few operations, so words are held as int16 with the same bits; the
CUDA kernel reads them as ``unsigned short`` and the plain version widens
them with ``& 0xFFFF``.

:func:`tl2_matmul` is the CUDA kernel's wrapper (``csrc/tl2_matmul.cu``, on
the design of ``csrc/ternary_mma.cuh`` that ``dequant_packed`` and ``w2a8``
share); :func:`tl2_matmul_torch` is its plain PyTorch version, used for CPU
tensors and as the kernel's reference on the card.  :func:`fragment_digits`
models which digit of which word the kernel decodes for each tensor-core k
slot.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.encoding import unpack_base3
from repro_torch.kernels.operands import X_KIND, aligned_rows

#: base-9 digits per packed word
PAIRS_PER_WORD = 5
#: trits per packed word → 16 / 10 = 1.6 bits per weight
TRITS_PER_WORD = 2 * PAIRS_PER_WORD
#: the word of ten zero trits (digit 4 in every pair), whose table entries
#: are all 0: the padding of the served rows, inert even where read
ZERO_WORD = sum(4 * 9**p for p in range(PAIRS_PER_WORD))
#: the served words' rows are padded to a multiple of this many bytes, so
#: every row starts 16-byte aligned for the kernel's 16-byte copies
ROW_BYTES = 16


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


def trit_digit(k):
    """Trit ``k`` (0..9) of a word is its base-3 digit ``k ^ 1``: each pair
    ``(t0, t1)`` is the base-9 digit ``(t0+1)·3 + (t1+1)``, so ``t1`` is
    the lower base-3 digit."""
    return k ^ 1


def fragment_digits(mma: str) -> np.ndarray:
    """Where the CUDA kernel's A operand reads each k slot of one warp's
    32 bytes (16 words, 160 trits) of a row: entry ``[i, k]``
    is ``(word, digit)``, the word (0..15) and its base-3 digit (0..9) that
    MMA ``i`` takes as its k-th value.

    Lane t of a quad decodes its own two 32-bit words, at bytes 4t and
    16 + 4t (words 2t, 2t + 1 and 8 + 2t, 9 + 2t); trit L (0..19) of a
    32-bit word is digit ``trit_digit(L % 10)`` of its word ``L // 10``.
    ``"bf16"`` (m16n8k16, 10 MMAs): MMA (c, s) = 5c + s takes trits 4s +
    {0, 1} of the word at byte 16c + 4t in slots {2t, 2t+1} and 4s + {2, 3}
    in {2t+8, 2t+9}.  ``"s8"`` (m16n8k32, 5 MMAs): MMA s takes trits 4s +
    {0..3} of the word at byte 4t in slots 4t + {0..3} and of the word at
    16 + 4t in 4t + 16 + {0..3}.  x (B) is read as contiguous runs at the
    trits ``dequant_matmul.fragment_trits`` gives, so ``10 * word +
    trit_digit(digit % 10)`` must equal it slot for slot."""
    def at(byte, L):
        return byte // 2 + L // 10, trit_digit(L % 10)

    if mma == "bf16":
        out = np.empty((10, 16, 2), np.int64)
        for c in range(2):
            for s in range(5):
                for t in range(4):
                    for j, slot in enumerate((2 * t, 2 * t + 1, 2 * t + 8,
                                              2 * t + 9)):
                        out[5 * c + s, slot] = at(16 * c + 4 * t, 4 * s + j)
        return out
    if mma == "s8":
        out = np.empty((5, 32, 2), np.int64)
        for s in range(5):
            for t in range(4):
                for c in range(2):
                    for j in range(4):
                        out[s, 16 * c + 4 * t + j] = at(16 * c + 4 * t,
                                                        4 * s + j)
        return out
    raise ValueError(f"unknown MMA {mma!r}: 'bf16' or 's8'")


@functools.lru_cache(maxsize=None)
def _combo9_np() -> np.ndarray:
    """[9, 2] int8: row d = the trit pair encoded by base-9 digit d."""
    d = np.arange(9, dtype=np.int64)
    return np.stack([d // 3 - 1, d % 3 - 1], axis=1).astype(np.int8)


def _check_width(k: int, w: int) -> None:
    if k > w * TRITS_PER_WORD:
        raise ValueError(f"x has {k} columns, more than the "
                         f"{w * TRITS_PER_WORD} the packed words cover")


def _pad_x(x: torch.Tensor, w: int) -> torch.Tensor:
    _check_width(x.shape[1], w)
    full = w * TRITS_PER_WORD
    x = x.to(torch.float32)
    if x.shape[1] < full:
        x = torch.nn.functional.pad(x, (0, full - x.shape[1]))
    return x


def tl2_matmul_torch(x: torch.Tensor, words: torch.Tensor, n: int) -> torch.Tensor:
    """Plain TL2 matmul: ``y[b, o] = Σ_k x[b, k] · trits(words)[o, k]``.

    The reference's arithmetic: per-pair 9-entry tables (build), each
    word's digits select one entry per pair (fetch), f32 sums.  x: [B, N']
    f32/bf16/int8 of any width up to ``W*10`` (zero-padded to it here);
    words: [O, W], contiguous or a view of padded rows.  Returns [B, O]
    f32."""
    B = x.shape[0]
    O, W = words.shape
    x = _pad_x(x, W)
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
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    return fn


#: the grid of the last launch, written by the C entry: (column tiles, K
#: splits, row tiles, threads a block)
_GRID = (ctypes.c_int * 4)()


def tl2_matmul(x: torch.Tensor, words: torch.Tensor, n: int) -> torch.Tensor:
    """TL2 matmul through the CUDA kernel for CUDA tensors (``launches``
    counts the launches, ``last_grid`` keeps the last grid); CPU tensors
    take :func:`tl2_matmul_torch`.  Any other device raises.  x is read as
    it is where it is f32, bf16 or int8 (any other dtype is cast to f32),
    at any width up to ``W*10``: the kernel masks by x's columns, so x
    needs no padding.  The words are read where they lie (the served view
    of rows padded to :data:`ROW_BYTES`); rows are copied only where they
    are not 16-byte aligned (:func:`aligned_rows`).  Returns unscaled
    [B, O] f32."""
    if x.device.type == "cpu" and words.device.type == "cpu":
        return tl2_matmul_torch(x, words, n)
    if x.device.type != "cuda" or words.device != x.device:
        raise ValueError(f"tl2_matmul runs on CUDA (kernel) or CPU (plain); "
                         f"got x on {x.device}, words on {words.device}")
    if words.dtype != torch.int16 or words.ndim != 2 or x.ndim != 2:
        raise ValueError(f"expected x [B, K] and int16 words [O, W]; got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(words.shape)} "
                         f"{words.dtype}")
    B, K = x.shape
    O, W = words.shape
    _check_width(K, W)
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0 or K == 0:
        return out.zero_()
    if x.dtype not in X_KIND:
        x = x.to(torch.float32)
    (x, ldx), (words, ldw) = aligned_rows(x), aligned_rows(words)
    rc = _kernel()(x.data_ptr(), X_KIND[x.dtype], words.data_ptr(),
                   out.data_ptr(), B, O, K, W, ldx, ldw,
                   torch.cuda.current_stream(x.device).cuda_stream, _GRID)
    if rc != 0:
        raise RuntimeError(f"tl2_matmul kernel launch failed: CUDA error {rc}")
    tl2_matmul.launches += 1
    tl2_matmul.last_grid = tuple(_GRID)
    return out


tl2_matmul.launches = 0
tl2_matmul.last_grid = None
