"""Dry run: trace every (arch × shape) cell on fake tensors, on one card
or, with ``--mesh``, lay its trees out on a mesh.

The port's counterpart of the reference's multi-pod dry run.  For each cell of
``configs.registry.all_cells()`` it builds the cell's trees and inputs on
fake tensors (``FakeTensorMode`` with a ``ShapeEnv``: nothing is allocated
and nothing computed; a boolean index gets an unbacked size and the trace
carries on), runs the cell's step once under
:func:`repro_torch.launch.roofline.from_trace`, and records

  * ``param_bytes_per_device`` (the bf16 tree), with
    ``state_bytes_per_device`` (a train cell: the optimizer state) or
    ``packed_bytes_per_device`` (a serve cell: the packed tree) and
    ``cache_bytes_per_device`` (a decode cell's cache, or the one a
    prefill cell returns);
  * the roofline on the H100's peaks, the collectives (0 on one card),
    ``model_flops`` and ``model_flops_ratio``, and ``trace_s``;
  * ``fits``: whether the parameters (packed, for a serve cell), the
    optimizer state and the cache come under the card's memory
    (activations and gradients are not counted);

into ``experiments/dryrun_torch/<arch>__<shape>__1.json``, skipping cells
already recorded ``ok`` (an interrupted sweep resumes).

With ``--mesh 16x16`` (or ``2x16x16``, any ``DxM`` or ``PxDxM``) a cell
records instead the per-device bytes of its trees laid out by
``parallel.sharding`` on that mesh (a shape only; nothing runs), as the
reference's ``_sharded_bytes``: the parameters by ``param_specs``, a train
cell's optimizer state by the optimizer's ``state_specs``, a serve cell's
packed tree by ``param_specs`` and a decode cell's cache by
``cache_specs``, and ``fits`` against one card's memory, into
``<arch>__<shape>__<mesh>.json``.  No step is traced on a mesh: a rank's
program runs only in the serving engine (``launch.serve --mesh``).

The steps are the port's own: ``launch.train.make_train_step`` (train),
``decode.prefill`` (prefill) and ``decode.decode_step`` (decode, per-slot
``index [B]``).  Ternary matmuls select as a fresh card would (the prior)
and are counted as reported by dispatch.  A trace makes every op of every
loop iteration: xlstm's sLSTM steps its positions one at a time, so its
32k-token cells take the longest (``trace_s``).

Usage:
  python -m repro_torch.launch.dryrun --device cpu      # every cell, here
  python -m repro_torch.launch.dryrun                   # on the card
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k
  python -m repro_torch.launch.dryrun --device cpu --mesh 16x16
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.registry import all_cells, input_specs
from repro_torch.configs.shapes import SHAPES
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, parse_mesh_spec
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.parallel import sharding as sh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
MESH = "1"
#: the H100 SXM's memory, taken where no card is present to read it from
H100_MEMORY_BYTES = 80e9


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def device_memory(device: torch.device) -> tuple[float, str]:
    """The card's memory in bytes and where the number came from."""
    if device.type == "cuda":
        return (float(torch.cuda.get_device_properties(device).total_memory),
                torch.cuda.get_device_name(device))
    return H100_MEMORY_BYTES, "H100 SXM data sheet (no card read)"


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    return FakeTensorMode(allow_non_fake_inputs=True, shape_env=ShapeEnv())


def _fits(rec: dict, dev: torch.device) -> None:
    """Record the resident bytes a device holds (the parameters, packed
    for a serve cell, the optimizer state and the cache), whether they
    come under the device's memory, and mark the cell ``ok``."""
    resident = (rec.get("packed_bytes_per_device",
                        rec["param_bytes_per_device"])
                + rec.get("state_bytes_per_device", 0)
                + rec.get("cache_bytes_per_device", 0))
    memory, source = device_memory(dev)
    rec.update(resident_bytes_per_device=resident,
               device_memory_bytes=memory, device_memory_source=source,
               fits=resident <= memory, ok=True)


def cell_step(arch: str, shape_name: str, device: torch.device, rec: dict):
    """Under a fake mode: the cell's config, shape and its step as a
    callable with its arguments; fills ``rec``'s byte counts."""
    from repro_torch.models.decode import (decode_step, prefill,
                                           quantize_for_serving)
    from repro_torch.models.model import init_params

    cfg, shape, specs = input_specs(arch, shape_name, device)
    params = init_params(cfg, torch.Generator(device=device), device)
    rec["param_bytes_per_device"] = tree_bytes(params)
    if shape.kind == "train":
        from repro_torch.launch.train import make_train_step
        from repro_torch.optim.optimizers import make_optimizer

        opt = make_optimizer(cfg.optimizer)
        state = opt.init(params)
        rec["state_bytes_per_device"] = tree_bytes(state)
        return cfg, shape, make_train_step(cfg, opt), (params, state, {},
                                                       specs, 0)
    packed = quantize_for_serving(params, cfg)
    del params
    rec["packed_bytes_per_device"] = tree_bytes(packed)
    if shape.kind == "prefill":
        def step(p, batch):
            cache, logits = prefill(p, cfg, batch, s_max=shape.seq_len)
            rec["cache_bytes_per_device"] = tree_bytes(cache)
            return cache, logits

        return cfg, shape, step, (packed, specs)
    rec["cache_bytes_per_device"] = tree_bytes(specs["cache"])
    return cfg, shape, (lambda p, c, t, i: decode_step(p, cfg, c, t, i)), \
        (packed, specs["cache"], specs["tokens"], specs["index"])


def lower_cell(arch: str, shape_name: str, device: str | torch.device = "cpu",
               verbose: bool = True) -> dict:
    """Trace one cell on fake tensors of ``device`` and return its record."""
    dev = torch.device(device)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "chips": 1,
           "kind": SHAPES[shape_name].kind, "ok": False,
           "fake_device": str(dev)}
    t0 = time.time()
    with fake_mode():
        cfg, shape, fn, args = cell_step(arch, shape_name, dev, rec)
        rec["build_s"] = time.time() - t0
        t1 = time.time()
        roof, detail = rl.from_trace(fn, *args)
        rec["trace_s"] = time.time() - t1
    rec["roofline"] = roof.as_dict()
    rec["collectives"] = {k: detail[k] for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total")}
    rec["count"] = {k: detail[k] for k in (
        "raw_flop_counter_flops", "bytes_materialized", "bytes_read",
        "bytes_written", "bytes_returned", "ops", "flops_by_op",
        "ternary_matmuls")}
    rec["model_flops"] = rl.model_flops(cfg, shape, shape.kind)
    rec["model_flops_ratio"] = rec["model_flops"] / max(
        roof.flops_per_device * rec["chips"], 1.0)
    _fits(rec, dev)
    if verbose:
        print(f"  {arch} × {shape_name} × {MESH}: "
              f"compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms → {roof.bottleneck} "
              f"(build {rec['build_s']:.0f}s trace {rec['trace_s']:.0f}s, "
              f"{detail['ops']} ops, fits={rec['fits']})", flush=True)
    return rec


def mesh_cell(arch: str, shape_name: str, mesh: str,
              device: str | torch.device = "cpu") -> dict:
    """One cell's trees on fake tensors of ``device``, laid out on the
    shape-only mesh ``mesh``: their per-device bytes (see the module
    docstring)."""
    from repro_torch.models.decode import quantize_for_serving
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import make_optimizer

    dev = torch.device(device)
    m = Mesh(*parse_mesh_spec(mesh))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "chips": m.size,
           "kind": SHAPES[shape_name].kind, "ok": False,
           "fake_device": str(dev)}
    t0 = time.time()
    with fake_mode():
        cfg, shape, specs = input_specs(arch, shape_name, dev)
        params = init_params(cfg, torch.Generator(device=dev), dev)
        pspecs = sh.param_specs(params, m)
        rec["param_bytes_per_device"] = sh.sharded_bytes(params, pspecs, m)
        if shape.kind == "train":
            opt = make_optimizer(cfg.optimizer)
            state = opt.init(params)
            rec["state_bytes_per_device"] = sh.sharded_bytes(
                state, opt.state_specs(pspecs, params), m)
        else:
            packed = quantize_for_serving(params, cfg)
            rec["packed_bytes_per_device"] = sh.sharded_bytes(
                packed, sh.param_specs(packed, m), m)
            if shape.kind == "decode":
                rec["cache_bytes_per_device"] = sh.sharded_bytes(
                    specs["cache"], sh.cache_specs(specs["cache"], m), m)
    rec["build_s"] = time.time() - t0
    _fits(rec, dev)
    return rec


def cell_path(arch: str, shape_name: str, out_dir: str = OUT_DIR,
              mesh: str = MESH) -> str:
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh}.json")


def run(arch: str | None = None, shape: str | None = None,
        out_dir: str = OUT_DIR, force: bool = False,
        device: str | torch.device = "cpu", mesh: str = MESH) -> list:
    """Trace every cell (or those of ``arch`` / ``shape``) not yet recorded
    ``ok``, or on ``mesh`` lay out its trees; returns the failures."""
    os.makedirs(out_dir, exist_ok=True)
    cells = [(a, s) for a, s in all_cells()
             if (arch is None or a == arch) and (shape is None or s == shape)]
    failures = []
    for a, s in cells:
        path = cell_path(a, s, out_dir, mesh)
        if os.path.exists(path) and not force:
            with open(path) as f:
                if json.load(f).get("ok"):
                    continue
        print(f"[dryrun] {a} × {s} × {mesh}", flush=True)
        try:
            rec = (lower_cell(a, s, device) if mesh == MESH
                   else mesh_cell(a, s, mesh, device))
        except Exception as e:
            rec = {"arch": a, "shape": s, "mesh": mesh, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            failures.append((a, s, mesh, str(e)[:200]))
            print(f"  FAILED: {rec['error'][:300]}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"\n{len(failures)} failures")
    for f_ in failures:
        print(" ", f_)
    return failures


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device and whose memory 'fits' "
                    "reads (default cuda; cpu takes the H100's 80 GB)")
    ap.add_argument("--mesh", default=MESH,
                    help="1 (trace on one card) or a mesh such as 16x16 or "
                    "2x16x16 (per-device bytes of the trees laid out on it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(args.arch, args.shape, args.out_dir, args.force, dev,
               args.mesh)


if __name__ == "__main__":
    main()
