"""How the hand kernels take their operands: the activation dtypes they
read as they are, and the row layout their 16-byte copies need."""

from __future__ import annotations

import torch

#: activation dtypes the kernels built per dtype (signflip, lut_gather,
#: lut_onehot, dequant_packed, tl2, grouped_dequant) read as they are, by
#: the code their C entries take; the wrappers cast any other dtype to f32
X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def aligned_rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` (2-D) and the row stride (in elements) a kernel reads it at.
    The kernels copy 16 bytes at a time, so every row must start 16-byte
    aligned.  Rows are read in place where each is contiguous, they do not
    overlap and they are aligned (the served trits, LUT keys and TL2 words
    are views of rows padded to a multiple of 16 bytes); otherwise they are
    copied to a stride rounded up to 16 bytes, whose padding the kernel
    never reads."""
    rows, cols = t.shape
    align = 16 // t.element_size()
    padded = -(-cols // align) * align
    ld = t.stride(0) if rows > 1 else padded    # one row: any stride will do
    if t.stride(1) != 1 or ld < cols or ld % align or t.data_ptr() % 16:
        buf = t.new_empty((rows, padded))
        buf[:, :cols] = t
        t, ld = buf[:, :cols], padded
    return t, ld
