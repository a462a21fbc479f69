"""Functional, cycle-structured simulation of the generated LUT core, on
tensors (the port's copy of the reference's simulator).

It executes the exact ``BuildProgram`` adder DAG emitted by the generator,
the FAC read-out (mux select by encoded key, conditional sign inversion,
L-way reduction) and the output-stationary accumulation over matrix tiles,
and must agree **bit-exactly** with ``W @ x`` for integer activations (int64)
and to float tolerance for floating ones (float64).

The reference walks the schedule one LUT, one fetcher and one tile at a
time in Python.  Here every step runs over all groups of all tiles at once
on the device, in the reference's order of operations: each DAG op in the
program's order over every group's table, every key's fetch and sign flip,
the L-way reduction within a tile one LUT after another, then the
accumulation over the reduction tiles one after another.  So float64
results equal the reference's too, and a bitnet projection takes one pass
of a few hundred small launches instead of millions of Python steps.

The cycle counts (:class:`SimStats`) are the modelled ASIC schedule of the
core (Eq. 1), not a measurement of any device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.generator import LUTCoreConfig, LUTCoreDesign, generate
from repro_torch.core.netlist import BuildProgram
from repro_torch.device import resolve_device


@dataclass
class SimStats:
    cycles: int
    build_phases: int
    fetch_cycles: int
    mac_equiv: int  # ternary multiplies performed

    @property
    def muls_per_cycle(self) -> float:
        return self.mac_equiv / max(self.cycles, 1)


def run_build_program(prog: BuildProgram, x_groups: torch.Tensor) -> torch.Tensor:
    """Evaluate the adder DAG for every LUT at once: ``x_groups [G, mu]`` →
    entries ``[G, T+1]`` (entry ``T`` the hardwired 0), op by op in the
    program's order."""
    T = encoding.table_size(prog.mu)
    G = x_groups.shape[0]
    entries = torch.zeros((G, T + 1), dtype=x_groups.dtype,
                          device=x_groups.device)

    def val(ref, neg):
        if ref[0] == "zero":
            v = torch.zeros((G,), dtype=x_groups.dtype, device=x_groups.device)
        elif ref[0] == "x":
            v = x_groups[:, ref[1]]
        else:
            v = entries[:, ref[1]]
        return -v if neg else v

    for op in prog.ops:
        a = val(op.a, op.negate_a)
        entries[:, op.out] = a if op.b is None else a + val(op.b, op.negate_b)
    return entries


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a).to(device)


def simulate_gemv(design: LUTCoreDesign, w_t, x, acc_dtype=None, *,
                  device: str | torch.device | None = None
                  ) -> tuple[torch.Tensor, SimStats]:
    """Run a full GEMV ``y = w_t @ x`` through the simulated core.

    Args:
      design: generated core (provides mu, L, K and the Build DAG).
      w_t:    [M, N] ternary weights in {-1, 0, +1} (tensor or array).
      x:      [N] activations (integer for bit-exactness, float allowed).
      acc_dtype: the datapath's dtype; int64 for integer ``x``, float64
        otherwise.
      device: where the simulation runs; ``None`` is the card
        (``repro_torch.device.resolve_device``).

    Returns:
      (y [M] on ``device``, SimStats).
    """
    dev = resolve_device(device)
    cfg = design.config
    mu, L, K = cfg.mu, cfg.L, cfg.K
    n_tile = L * mu
    w_t, x = _as_tensor(w_t, dev), _as_tensor(x, dev)
    M, N = w_t.shape
    if acc_dtype is None:
        acc_dtype = (torch.float64 if x.is_floating_point() else torch.int64)

    pad_n = (-N) % n_tile
    pad_m = (-M) % K
    xp = torch.nn.functional.pad(x.to(acc_dtype), (0, pad_n))
    wp = torch.nn.functional.pad(w_t.to(torch.int8), (0, pad_n, 0, pad_m))
    Np, Mp = N + pad_n, M + pad_m
    n_tiles, m_tiles = Np // n_tile, Mp // K

    # Build phase: every LUT of every reduction tile (an output tile's
    # rebuild computes the same tables, so they are built once here and
    # counted once per output tile in the stats)
    tables = run_build_program(design.build_program, xp.reshape(-1, mu))
    # FAC read-out: each weight group's key selects one entry, its
    # symmetry bit negates it
    sym, idx = encoding.split_key(encoding.encode_weight_matrix(wp, mu), mu)
    g = torch.arange(tables.shape[0], device=dev)
    v = tables[g, idx.long()]                                  # [Mp, G]
    v = torch.where(sym == 1, -v, v).reshape(Mp, n_tiles, L)
    # the reduction adder tree over the tile's L LUTs, then the K output
    # registers accumulating over the reduction tiles, in order
    s = torch.zeros((Mp, n_tiles), dtype=acc_dtype, device=dev)
    for lut in range(L):
        s = s + v[:, :, lut]
    y = torch.zeros((Mp,), dtype=acc_dtype, device=dev)
    for nt in range(n_tiles):
        y = y + s[:, nt]

    depth = max(design.netlist.build_pipeline_depth, 1)
    # Pipelined schedule: builds overlap fetches except the first fill.
    phases = m_tiles * n_tiles
    stats = SimStats(cycles=phases + depth, build_phases=phases,
                     fetch_cycles=phases, mac_equiv=Mp * Np)
    return y[:M], stats


def simulate_vs_reference(config: LUTCoreConfig, w_t, x, *,
                          device: str | torch.device | None = None):
    """Convenience: simulate and return (y_sim, y_ref, stats), ``y_ref``
    the plain product in int64 (integer ``x``) or float64."""
    dev = resolve_device(device)
    design = generate(config)
    y_sim, stats = simulate_gemv(design, w_t, x, device=dev)
    w_t, x = _as_tensor(w_t, dev), _as_tensor(x, dev)
    dt = torch.float64 if x.is_floating_point() else torch.int64
    y_ref = (w_t.to(dt) * x.to(dt)).sum(-1)
    return y_sim, y_ref, stats
