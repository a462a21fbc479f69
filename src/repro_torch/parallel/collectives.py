"""The exact collectives of sharded serving.

The sharding rules (``parallel/sharding.py``) cut every projection by its
output columns and never by its contraction, so the ranks' slices of an
activation join without arithmetic: a gather along the last dim (the
model axis, in rank order) or along the batch dim (the data axes), and,
for a vocab-sharded embedding lookup where exactly one rank holds each
token's row, a sum in which every element but one is zero.  No partial
sum is ever reduced.

On ``gloo``, which takes CUDA tensors for ``all_reduce`` and
``broadcast`` only (staged through the host), a gather is an
``all_reduce`` of a zeroed buffer in which each rank has written its own
slice, summed as integers over the buffer's bytes: every byte is nonzero
on at most one rank, so the sum is that byte, bit for bit (the signs of
zeros and NaN payloads included).  The disjoint sum is the same
``all_reduce`` without the buffer.  gloo runs this form on the CPU too,
so the CPU tests run the card's path.  On ``nccl`` a gather is
``all_gather_into_tensor``.

Each mesh counts its collectives' calls, bytes (the joined tensor's) and
host wall seconds (:class:`CollectiveStats`).  Layers reach the active
mesh through :func:`mesh_scope`, which the serving engine enters around
each forward.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass

import torch


@dataclass
class CollectiveStats:
    """Per rank: collectives called, bytes of the tensors they joined, and
    host wall seconds spent in them (from the call until the joined
    tensor's values are usable by the host or the stream)."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "ms": self.seconds * 1e3}


#: the mesh of the forward in progress (:func:`mesh_scope`)
_MESH: ContextVar = ContextVar("mesh", default=None)


@contextmanager
def mesh_scope(mesh):
    """Within the block the layers join their slices over ``mesh`` (None:
    a single-device forward; a slice then raises)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def _active():
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError(
            "a sharded activation reached a join outside a mesh_scope: the "
            "weights are a rank's slice but no mesh joins them")
    return mesh


def _bit_view(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` (contiguous) as int32 words, or bytes where its size is not
    a multiple of 4: the integer form the disjoint sum runs on."""
    flat = buf.reshape(-1).view(torch.uint8)
    return flat.view(torch.int32) if flat.numel() % 4 == 0 else flat


def _all_reduce_disjoint(buf: torch.Tensor, group) -> None:
    """Sum ``buf`` over ``group`` in place, as integers over its bytes."""
    import torch.distributed as dist

    dist.all_reduce(_bit_view(buf), group=group)


def _gather(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``[n, *x.shape]``: the slices of the ranks along ``axes`` (the
    axes' linear index major to minor), this rank's ``x`` among them."""
    import torch.distributed as dist

    n = mesh.size_of(axes)
    x = x.contiguous()
    group = mesh.group(axes)
    if mesh.backend == "gloo":
        out = torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device)
        out[mesh.index(axes)] = x
        _all_reduce_disjoint(out, group)
    else:
        out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def _timed(mesh, fn, nbytes: int):
    t0 = time.perf_counter()
    out = fn()
    mesh.stats.seconds += time.perf_counter() - t0
    mesh.stats.calls += 1
    mesh.stats.bytes += nbytes
    return out


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n]`` of each rank along the active mesh's model axis
    joined in rank order: ``[..., model · n]``."""
    mesh = _active()
    m = mesh.shape["model"]
    if m == 1:
        return x

    def run():
        parts = _gather(x, mesh, ("model",))          # [m, ..., n]
        return parts.movedim(0, -2).reshape(*x.shape[:-1], m * x.shape[-1])

    return _timed(mesh, run, x.numel() * x.element_size() * m)


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x [b, ...]`` of each rank along the batch axes (pod, data) joined
    in rank order: ``[batch · b, ...]``."""
    axes = mesh.batch_axes
    n = mesh.size_of(axes)
    if n == 1:
        return x
    return _timed(mesh, lambda: _gather(x, mesh, axes).reshape(
        n * x.shape[0], *x.shape[1:]),
        x.numel() * x.element_size() * n)


def sum_disjoint(x: torch.Tensor) -> torch.Tensor:
    """The active mesh's model ranks' ``x`` joined where each element is
    nonzero on at most one rank (all bits zero elsewhere): that rank's
    value, exactly, on either backend."""
    mesh = _active()
    if mesh.shape["model"] == 1:
        return x

    def run():
        out = x.contiguous().clone()
        _all_reduce_disjoint(out, mesh.group(("model",)))
        return out

    return _timed(mesh, run, x.numel() * x.element_size())


def join_last(x: torch.Tensor, full: int) -> torch.Tensor:
    """``x [..., full]`` as it is, or a model-sharded ``x [..., full /
    model]`` gathered to ``full`` over the active mesh."""
    if x.shape[-1] == full:
        return x
    return gather_last(x)
