"""Parameter trees across the two packages, as numpy arrays.

``from_numpy_tree`` takes a reference parameter tree (``init_params`` or
``quantize_for_serving`` output) converted leaf by leaf to numpy, and
returns the port's tree of tensors with the same structure.  bf16 leaves
cross as a 16-bit view (numpy has no native bf16), packed ``uint8`` bytes as
they are, including the 128-byte row padding.  ``to_numpy_tree`` goes back;
its bf16 leaves come out as ``uint16`` views of the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_numpy_tree(tree, device: str | torch.device = "cuda"):
    """Nested dict of numpy arrays (reference layout) → the port's tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return _leaf_to_torch(tree, device)


def to_numpy_tree(tree):
    """The port's tensor tree → nested dict of numpy arrays (bf16 → uint16
    views of the same bits)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
