"""Meshes of ranks over ``torch.distributed``, and the launcher of a
mesh's rank processes.

A :class:`Mesh` holds the axis names and sizes (``("data", "model")`` or
``("pod", "data", "model")``, the reference's), this rank's coordinates
and one process group per set of axes the collectives join over (the
model axis, and the batch axes pod and data together).  Rank ``r`` sits at
the row-major coordinates of ``r`` over the axis sizes, as the reference's
``jax.make_mesh`` lays devices out.  A mesh without coordinates
(:func:`make_production_mesh`, :func:`make_mesh_for`) has a shape only:
the sharding rules and the dry run read it; nothing runs on it.

:func:`run_ranks` starts a mesh's ranks, one process each (the ``spawn``
start method: CUDA does not survive ``fork``), over a ``file://``
rendezvous in a fresh temporary directory, with the backend the caller
names: ``nccl`` by default, ``gloo`` only when asked for (NCCL refuses two
ranks on one GPU; gloo takes them, staging every collective through the
host).  Rank ``r`` runs on ``cuda:<r % device_count>`` unless the caller
passes ``device="cpu"``.

The hardware constants are the H100's (``launch/roofline.py``).
"""

from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch

from repro_torch.launch.roofline import HBM_BW, ICI_BW, PEAK_FLOPS_BF16  # noqa: F401
from repro_torch.parallel.collectives import CollectiveStats

#: the reference's production meshes: one pod of 16 x 16, two of them
CHIPS_SINGLE_POD = 256
CHIPS_MULTI_POD = 512
BACKENDS = ("nccl", "gloo")


@dataclass
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    #: this rank's coordinate per axis (None: a shape-only mesh)
    coords: tuple[int, ...] | None = None
    backend: str | None = None
    #: process group per tuple of joined axes (those of size > 1)
    groups: dict = field(default_factory=dict, repr=False)
    stats: CollectiveStats = field(default_factory=CollectiveStats,
                                   repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.axis_sizes)

    def size_of(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def coord(self, axis: str) -> int:
        if self.coords is None:
            raise ValueError(f"mesh {self.name} has a shape only: no rank "
                             "coordinates")
        return self.coords[self.axis_names.index(axis)]

    def index(self, axes) -> int:
        """This rank's linear index along ``axes`` (major to minor)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def group(self, axes):
        return self.groups[tuple(axes)]

    def batch_rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row tensor split over the batch
        axes (all of them where the split is uneven, as the rules keep
        such a dim whole)."""
        n = self.size_of(self.batch_axes)
        if n == 1 or batch % n:
            return slice(0, batch)
        b = batch // n
        i = self.index(self.batch_axes)
        return slice(i * b, (i + 1) * b)


def parse_mesh_spec(spec: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """``"DxM"`` → ``(data, model)``; ``"PxDxM"`` → ``(pod, data, model)``."""
    try:
        shape = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}; expected e.g. '1x8'")
    if len(shape) == 2:
        axes = ("data", "model")
    elif len(shape) == 3:
        axes = ("pod", "data", "model")
    else:
        raise ValueError(f"bad mesh spec {spec!r}; expected 'DxM' or 'PxDxM'")
    if min(shape) < 1:
        raise ValueError(f"bad mesh spec {spec!r}: every axis needs a rank")
    return axes, shape


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's dry-run meshes, shape only: 16 x 16, or 2 x 16 x 16
    with ``multi_pod``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh_for(devices: int, model_parallel: int = 1) -> Mesh:
    """A shape-only ``(devices / model_parallel, model_parallel)`` mesh."""
    if devices % model_parallel:
        raise ValueError(f"{model_parallel} does not divide {devices}")
    return Mesh(("data", "model"), (devices // model_parallel, model_parallel))


def _coords(rank: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_serving_mesh(spec: str, backend: str | None = None) -> Mesh:
    """The mesh ``spec`` over the initialized ``torch.distributed`` world:
    this rank's coordinates and the process groups of the model axis and
    of the batch axes.  The world's size must be the mesh's product, and
    ``backend`` (when given) the world's.  Every rank must call it (group
    creation is collective)."""
    import torch.distributed as dist

    axes, shape = parse_mesh_spec(spec)
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialized "
                           "torch.distributed world (launch.mesh.run_ranks)")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {spec!r} needs {n} ranks but the world has "
                         f"{world}")
    world_backend = dist.get_backend()
    if backend is not None and backend != world_backend:
        raise ValueError(f"mesh {spec!r} asked for backend {backend!r} but "
                         f"the world runs {world_backend!r}")
    mesh = Mesh(axes, shape, _coords(dist.get_rank(), shape), world_backend)
    batch = mesh.batch_axes
    for joined in (("model",), batch):
        if mesh.size_of(joined) == 1:
            continue
        others = [a for a in axes if a not in joined]
        # one group per coordinate of the other axes; every rank creates
        # every group, in the same order
        for r in range(n):
            c = dict(zip(axes, _coords(r, shape)))
            if any(c[a] for a in joined):
                continue
            ranks = [q for q in range(n)
                     if all(dict(zip(axes, _coords(q, shape)))[a] == c[a]
                            for a in others)]
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mesh.groups[tuple(joined)] = g
    return mesh


def rank_device(rank: int, device: str | torch.device | None = None
                ) -> torch.device:
    """``cuda:<rank % device_count>``, or the CPU when the caller asks for
    it; raises where there is no card."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _rank_main(fn, rank: int, world: int, spec: str, backend: str,
               device, init_method: str, args: tuple, results) -> None:
    import torch.distributed as dist

    try:
        dev = rank_device(rank, device)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        mesh = make_serving_mesh(spec, backend=backend)
        results.put((rank, True, fn(mesh, dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, spec: str, *, backend: str = "nccl",
              device: str | torch.device | None = None, args: tuple = (),
              timeout: float | None = None) -> list:
    """Run ``fn(mesh, device, *args)`` on each rank of the mesh ``spec``,
    one spawned process each, and return the ranks' results in rank order
    (``fn`` must be importable by name and its result picklable).  A rank
    that raises or dies, or a run past ``timeout`` seconds, stops every
    rank and raises.  Build the CUDA kernels first: the ranks load them."""
    import multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
    _, shape = parse_mesh_spec(spec)
    n = math.prod(shape)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_rendezvous-")
    init = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, spec, backend, device, init, args,
                               results)) for r in range(n)]
    out, errors = {}, []
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < n and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    errors.append(f"rank(s) {dead} died (exit "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif deadline is not None and time.monotonic() > deadline:
                    errors.append(f"mesh {spec} ran past {timeout} s")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError(f"mesh {spec} ({backend}) failed: " +
                           "\n".join(errors))
    return [out[r] for r in range(n)]
