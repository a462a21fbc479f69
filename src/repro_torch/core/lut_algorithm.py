"""Plain PyTorch oracle of the two-phase LUT GEMV/GEMM algorithm (paper
§II-B, Fig 2), the port's copy of the reference's.

Phase 1 — **LUT Build**: for every group of ``mu`` activations, precompute the
``T = (3^mu - 1)/2`` symmetry-reduced partial sums (plus a hardwired 0 entry).
Functionally this is ``tables = x_groups @ C.T`` with the combo matrix ``C``.

Phase 2 — **Fetch & Accumulate**: each output channel holds one encoded key
per group; fetch ``tables[g, idx]``, conditionally invert by the symmetry bit,
and accumulate over groups.

Every function runs on its tensors' device and keeps their dtype: integer
activations give exact integer results (the products are sums of
``mu`` terms, written out as such, so integer tensors work on the card as
well, where ``torch.matmul`` takes floats only).  It is the oracle of
:mod:`repro_torch.core.simulator`, and equals a plain matmul exactly on
integer inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., k] @ b [n, k].T`` → ``[..., n]``: ``torch.matmul`` for
    floating tensors, an exact broadcast sum for integer ones."""
    if a.is_floating_point():
        return a @ b.T
    return (a.unsqueeze(-2) * b).sum(-1)


def group_activations(x: torch.Tensor, mu: int) -> torch.Tensor:
    """[..., N] → [..., G, mu] with zero padding to a multiple of mu."""
    *lead, N = x.shape
    pad = (-N) % mu
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*lead, (N + pad) // mu, mu)


def lut_build(x_groups: torch.Tensor, mu: int) -> torch.Tensor:
    """Build phase: [..., G, mu] → [..., G, T+1] partial-sum tables.

    Entry ``[..., g, t]`` = ``dot(C[t], x_groups[..., g, :])``; entry ``T`` is
    the hardwired zero."""
    C = torch.from_numpy(encoding.combo_matrix_np(mu)).to(x_groups.device,
                                                          x_groups.dtype)
    return _contract(x_groups, C)


def lut_fetch_accumulate(tables: torch.Tensor, keys: torch.Tensor,
                         mu: int) -> torch.Tensor:
    """Fetch & accumulate phase.

    Args:
      tables: [..., G, T+1] built tables.
      keys:   [O, G] encoded weight keys (shared across leading batch dims).

    Returns:
      [..., O] accumulated outputs.
    """
    sym, idx = encoding.split_key(keys, mu)                    # [O, G] each
    G = tables.shape[-2]
    g = torch.arange(G, device=tables.device)[:, None]
    gathered = tables[..., g, idx.T.long()]                    # [..., G, O]
    sign = torch.where(sym == 1, -1, 1).to(tables.dtype)       # [O, G]
    return (gathered * sign.T).sum(-2)


def lut_matmul_keys(x: torch.Tensor, keys: torch.Tensor, mu: int) -> torch.Tensor:
    """y[..., o] = Σ_n x[..., n] · decode(keys)[o, n] via the two-phase
    algorithm."""
    tables = lut_build(group_activations(x, mu), mu)
    return lut_fetch_accumulate(tables, keys, mu)


def lut_matmul(x: torch.Tensor, w_t: torch.Tensor, mu: int) -> torch.Tensor:
    """LUT matmul against a raw ternary matrix ``w_t [O, N]``: exactly
    ``x @ w_t.T`` on integer inputs, allclose on floats."""
    keys = encoding.encode_weight_matrix(w_t, mu)
    return lut_matmul_keys(x, keys, mu)


def lut_matmul_onehot(x: torch.Tensor, keys: torch.Tensor, mu: int) -> torch.Tensor:
    """The fetch phase as a contraction (the reference's MXU lowering, the
    oracle of ``lut_onehot``): ``y[o] = Σ_g Σ_t onehot(keys)[o,g,t] ·
    tables[g,t]``, the symmetry flip folded into signed one-hot rows."""
    T = encoding.table_size(mu)
    sym, idx = encoding.split_key(keys, mu)
    sign = torch.where(sym == 1, -1, 1).to(x.dtype)
    onehot = torch.nn.functional.one_hot(idx.long(), T + 1).to(x.dtype) * \
        sign[..., None]                                        # [O, G, T+1]
    tables = lut_build(group_activations(x, mu), mu)           # [..., G, T+1]
    O = onehot.shape[0]
    return _contract(tables.flatten(-2), onehot.reshape(O, -1))
