"""Offline dense ternary weight encoding (paper §III-D) + byte packings.

The port's copy of the reference encodings, byte for byte:

* a ternary combo ``c ∈ {-1,0,+1}^mu`` maps to the base-3 value
  ``v = Σ_i (c_i + 1) · 3^i`` (weight position ``i`` = base-3 digit ``i``);
* ``center = (3^mu - 1)/2`` is the all-zero combo; the stored positive half
  is ``v > center`` with table index ``idx = v - center - 1 ∈ [0, T)``;
* key = ``sym << idx_bits | idx``; the all-zero group gets the reserved
  index ``T`` (the fetch path hardwires entry ``T`` to 0).

Base-3 bytes hold 5 trits each (1.6 bits/weight); byte 0 decodes to five
``-1`` trits, so a kernel that reads past the logical width must zero the
matching activations.  The naive 2-bit packing (:func:`pack_2bit`, four
trits a byte) is the baseline of the paper's 20% density claim.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


def table_size(mu: int) -> int:
    """T = number of stored (positive-half) LUT entries."""
    return (3**mu - 1) // 2


def idx_bits(mu: int) -> int:
    """Bits for the MUX select index (zero-group representable)."""
    return max(1, int(np.ceil(np.log2(table_size(mu) + 1))))


def key_bits(mu: int) -> int:
    """Exact key width: index bits + symmetry bit."""
    return idx_bits(mu) + 1


def key_bits_paper(mu: int) -> int:
    """The paper's §III-D width formula, ceil(log2(T)) + 1."""
    return max(1, int(np.ceil(np.log2(table_size(mu))))) + 1


def bits_per_weight(mu: int, paper_formula: bool = False) -> float:
    return (key_bits_paper(mu) if paper_formula else key_bits(mu)) / mu


def key_dtype(mu: int) -> torch.dtype:
    """uint8 keys up to 8 bits; wider keys are held in int16 bit for bit
    (torch's uint16 supports few operations)."""
    return torch.uint8 if key_bits(mu) <= 8 else torch.int16


@functools.lru_cache(maxsize=None)
def combo_matrix_np(mu: int) -> np.ndarray:
    """[T+1, mu] int8: row t = the ternary combo stored at table index t;
    row ``T`` (the reserved zero entry) is all zeros."""
    T = table_size(mu)
    vals = np.arange(T + 1, 3**mu, dtype=np.int64)  # positive half
    digits = np.stack([(vals // 3**i) % 3 - 1 for i in range(mu)], axis=1)
    out = np.concatenate([digits, np.zeros((1, mu), dtype=np.int64)], axis=0)
    return out.astype(np.int8)


def encode_groups(w_t: torch.Tensor, mu: int) -> torch.Tensor:
    """int8 trits ``[..., G, mu]`` → keys ``[..., G]``."""
    T = table_size(mu)
    center = T
    powers = torch.tensor([3**i for i in range(mu)], dtype=torch.int32,
                          device=w_t.device)
    v = ((w_t.to(torch.int32) + 1) * powers).sum(-1)
    sym = (v < center).to(torch.int32)
    v_pos = torch.where(sym == 1, (3**mu - 1) - v, v)
    idx = torch.where(v_pos == center, T, v_pos - center - 1)
    sym = torch.where(v_pos == center, 0, sym)
    key = (sym << idx_bits(mu)) | idx
    return key.to(key_dtype(mu))


def decode_groups(keys: torch.Tensor, mu: int) -> torch.Tensor:
    """Inverse of :func:`encode_groups` → int8 trits ``[..., G, mu]``."""
    C = torch.from_numpy(combo_matrix_np(mu)).to(keys.device)
    ib = idx_bits(mu)
    k = keys.to(torch.int32) & 0xFFFF
    sym = k >> ib
    idx = (k & ((1 << ib) - 1)).long()
    sign = torch.where(sym == 1, -1, 1).to(torch.int8)[..., None]
    return C[idx] * sign


def split_key(keys: torch.Tensor, mu: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(sym, idx) int32 views of a key array."""
    ib = idx_bits(mu)
    k = keys.to(torch.int32) & 0xFFFF
    return k >> ib, k & ((1 << ib) - 1)


def encode_weight_matrix(w_t: torch.Tensor, mu: int) -> torch.Tensor:
    """[O, N] ternary → [O, ceil(N/mu)] keys (N padded with zero trits)."""
    O, N = w_t.shape
    pad = (-N) % mu
    if pad:
        w_t = torch.nn.functional.pad(w_t, (0, pad))
    return encode_groups(w_t.reshape(O, (N + pad) // mu, mu), mu)


TRITS_PER_BYTE = 5  # 3^5 = 243 <= 256


def pack_base3(w_t: torch.Tensor) -> torch.Tensor:
    """Pack ternary {-1,0,1} → uint8, 5 trits/byte along the last axis (last
    axis zero-padded to a multiple of 5)."""
    *lead, N = w_t.shape
    pad = (-N) % TRITS_PER_BYTE
    if pad:
        w_t = torch.nn.functional.pad(w_t, (0, pad))
    grp = w_t.reshape(*lead, -1, TRITS_PER_BYTE).to(torch.int32) + 1
    powers = torch.tensor([3**i for i in range(TRITS_PER_BYTE)],
                          dtype=torch.int32, device=w_t.device)
    return (grp * powers).sum(-1).to(torch.uint8)


#: the serving artifact pads each row of base-3 bytes to a multiple of this
#: many bytes, so the trits a row decodes to start every 640 bytes
PACKED_ROW_BYTES = 128
#: the served LUT keys' rows are padded to a multiple of this many bytes,
#: so every row starts 16-byte aligned for the kernel's 16-byte copies
KEY_ROW_BYTES = 16


def pad_rows(t: torch.Tensor, row_bytes: int, value: int = 0) -> torch.Tensor:
    """``t [..., n]`` with each row padded to a multiple of ``row_bytes``
    bytes, the padding holding ``value``: the serving artifact's base-3
    rows (:data:`PACKED_ROW_BYTES`, zeros), the served LUT keys' rows
    (:data:`KEY_ROW_BYTES`, the zero key) and the served TL2 words' rows
    (``tl2_matmul.ROW_BYTES``, the zero-trit word).  The padding lies past
    the logical width, where the kernels never read.  Rows already that
    long are returned as they are."""
    pad = (-t.shape[-1]) % (row_bytes // t.element_size())
    return torch.nn.functional.pad(t, (0, pad), value=value) if pad else t


@functools.lru_cache(maxsize=None)
def _base3_decode_table() -> np.ndarray:
    """[256, 5] int8 decode LUT: byte value → 5 trits."""
    vals = np.arange(256, dtype=np.int64)
    digits = np.stack([(vals // 3**i) % 3 - 1 for i in range(TRITS_PER_BYTE)],
                      axis=1)
    return digits.astype(np.int8)


def unpack_base3(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 [..., ceil(n/5)] → int8 trits [..., n]."""
    return unpack_base3_to(packed, n, torch.int8)


def unpack_base3_to(packed: torch.Tensor, n: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """uint8 [..., ceil(n/5)] → trits [..., n] directly in ``dtype`` (one
    gather from a typed 256×5 table)."""
    tbl = torch.from_numpy(_base3_decode_table()).to(packed.device, dtype)
    trits = tbl[packed.long()]
    return trits.reshape(*packed.shape[:-1], -1)[..., :n]


def pack_2bit(w_t: torch.Tensor) -> torch.Tensor:
    """Naive 2-bit packing, four trits a byte (``trit + 1`` at bits 0, 2, 4,
    6) along the last axis, zero-padded to a multiple of 4."""
    *lead, N = w_t.shape
    pad = (-N) % 4
    if pad:
        w_t = torch.nn.functional.pad(w_t, (0, pad))
    grp = (w_t.reshape(*lead, -1, 4).to(torch.int32) + 1) & 0b11
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32, device=w_t.device)
    return (grp << shifts).sum(-1).to(torch.uint8)


def unpack_2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 [..., ceil(n/4)] → int8 trits [..., n]."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32,
                          device=packed.device)
    trits = ((packed.to(torch.int32)[..., None] >> shifts) & 0b11) - 1
    return trits.reshape(*packed.shape[:-1], -1)[..., :n].to(torch.int8)


@dataclass(frozen=True)
class PackedTernary:
    """A ternary weight matrix in deployment form: ``data`` uint8 base-3
    bytes ``[O, ceil(N/5)]`` packed along the input (reduction) dim, the
    absmean ``scale`` and the logical ``(O, N)`` shape."""

    data: torch.Tensor
    scale: torch.Tensor
    shape: tuple[int, int]

    @property
    def bits_per_weight(self) -> float:
        return self.data.numel() * 8 / (self.shape[0] * self.shape[1])


def pack_ternary_matrix(w_t: torch.Tensor,
                        scale: torch.Tensor) -> PackedTernary:
    O, N = w_t.shape
    return PackedTernary(data=pack_base3(w_t), scale=scale, shape=(O, N))


def unpack_ternary_matrix(p: PackedTernary) -> torch.Tensor:
    return unpack_base3(p.data, p.shape[1])
