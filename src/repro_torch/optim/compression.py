"""INT8 gradient compression with error feedback: each gradient leaf plus
the error carried from the last step is quantized to int8 with one f32
scale (absmax / 127), and the quantization residual is carried to the next
step, so the scheme stays unbiased over time.  On a data-parallel mesh
this is what the all-reduce would carry (4x fewer bytes than f32); on one
device :func:`roundtrip` runs the quantize-dequantize cycle in the step,
as the reference's does.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.optimizers import tree_map


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """(grad + carried error) → (int8 payload, f32 scale, new error)."""
    g32 = g.to(torch.float32) + err
    scale = torch.clamp_min(torch.max(torch.abs(g32)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, g32 - deq


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params: Any):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _pick(tree, i: int):
    """The ``i``-th entry of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def compress_grads(grads: Any, err_state: Any):
    """Tree version → ``((payload tree, scale tree), new error tree)``."""
    out = tree_map(compress_leaf, grads, err_state)
    return (_pick(out, 0), _pick(out, 1)), _pick(out, 2)


def decompress_grads(payload) -> Any:
    q, s = payload
    return tree_map(decompress_leaf, q, s)


def roundtrip(grads: Any, err_state: Any):
    """One compress → decompress cycle: ``(f32 grads, new error)``."""
    payload, err = compress_grads(grads, err_state)
    return decompress_grads(payload), err
