"""LUT-core hardware generator (paper §III), the port's copy.

The paper's generator emits Chisel RTL for any ``(mu, L, K, dtype)`` point.
This one emits, for the same design point:

  1. a structural :class:`~repro_torch.core.netlist.Netlist` with the three
     LUT optimizations applied exactly (consumed by the cost model and the
     functional simulator — the "RTL"),
  2. an area/throughput report from the §IV cost model (the paper's 16 nm
     ASIC model: µm², mm², TOPS/mm² at 800 MHz; modelled, not measured),
  3. a *kernel plan*: how the port's CUDA LUT kernel
     (``kernels/csrc/lut_matmul.cu``, ``lut_gather``) tiles the same
     product on the H100, and which wrapper realizes it,
  4. a human-readable module hierarchy (Fig. 3) for documentation/tests.

The netlist, the report and the hierarchy equal the reference's; the plan
is the CUDA kernel's, not the reference's TPU geometry.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import dse
from repro_torch.core import netlist as nl
from repro_torch.core.encoding import key_bits, table_size
from repro_torch.kernels import lut_matmul as lut

#: groups of ``mu`` weights one step of the CUDA kernel's reduction takes:
#: one 16-byte chunk of a key row, a key a group (``SG``,
#: ``csrc/lut_matmul.cu``)
KERNEL_GROUPS_PER_STEP = 16
#: output columns one warp of the gather fetch holds, one a lane; a block
#: takes 1, 2 or 4 such warps along N, as the launch plans (``Shape::BN``,
#: ``csrc/lut_matmul.cu``)
KERNEL_WARP_COLUMNS = 32


@dataclass(frozen=True)
class LUTCoreConfig:
    """A point in the paper's design space."""

    mu: int = 3
    L: int = 32
    K: int = 32
    act_dtype: str = "fp16"  # cost-model domain: "fp16" | "int8"

    def __post_init__(self):
        if not (1 <= self.mu <= 8):
            raise ValueError(f"mu={self.mu} out of supported range [1, 8]")
        if self.L < 1 or self.K < 1:
            raise ValueError("L and K must be >= 1")
        if self.act_dtype not in cm.COEFFS:
            raise ValueError(f"unknown activation dtype {self.act_dtype!r}")

    @property
    def n(self) -> int:
        return self.L * self.mu

    @property
    def m(self) -> int:
        return self.K

    @property
    def tile(self) -> tuple[int, int]:
        return (self.n, self.m)

    @property
    def throughput_mul_per_cycle(self) -> int:
        return self.n * self.m


@dataclass(frozen=True)
class KernelPlan:
    """How the CUDA LUT kernel tiles the core's product on the H100.

    ``block_n`` (reduction, in weights) is the core tile's ``n`` rounded up
    to whole kernel steps of :data:`KERNEL_GROUPS_PER_STEP` groups;
    ``block_m`` (outputs) its ``m`` rounded up to whole warp column blocks
    of :data:`KERNEL_WARP_COLUMNS`.  ``kernel`` names the wrapper that runs
    the product: ``lut_gather`` at the group size the CUDA build takes
    (``kernels.lut_matmul.KERNEL_MU``), none at any other ``mu``."""

    mu: int
    kernel: str | None
    block_n: int
    block_m: int
    table_entries: int  # (3^mu - 1)/2 + 1 (reserved zero row)
    key_bits: int

    def run(self, x: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """``x [B, K]`` times the keys ``[O, G]`` through the planned
        kernel (``kernels.lut_matmul.lut_matmul``: the CUDA ``lut_gather``
        on CUDA tensors, its plain version on CPU ones) → unscaled ``[B,
        O]`` f32.  A plan that names no kernel raises."""
        if self.kernel is None:
            raise ValueError(f"no CUDA kernel realizes mu={self.mu}: the LUT "
                             f"kernel is built for mu={lut.KERNEL_MU}")
        return lut.lut_matmul(x, keys, self.mu)


@dataclass(frozen=True)
class LUTCoreDesign:
    """Everything the generator knows about one instantiated design point."""

    config: LUTCoreConfig
    netlist: nl.Netlist
    build_program: nl.BuildProgram = field(repr=False)
    area_mm2: float
    tops_per_mm2: float
    kernel_plan: KernelPlan

    def module_hierarchy(self) -> str:
        """Fig. 3 block diagram as text (what the Chisel generator elaborates)."""
        c = self.config
        T = table_size(c.mu)
        return "\n".join([
            f"LutCore_u{c.mu}_L{c.L}_K{c.K}_{c.act_dtype}",
            f"├── ActivationBuffer[{c.n} x {c.act_dtype}]",
            f"├── LutArray[L={c.L}]",
            f"│   ├── BuildAdderTree(mu={c.mu}, adders={self.netlist.build_adders // c.L},"
            f" depth={self.netlist.build_pipeline_depth})   # symmetry+redundancy+sparsity",
            f"│   └── EntryRegisters[{T} x {c.act_dtype}]  (+ hardwired zero entry)",
            f"├── FacArray[K={c.K}]",
            f"│   ├── ReadoutMux[{T + 1}:1] x {c.L}   (key = {key_bits(c.mu)}b: 1 sym + idx)",
            f"│   ├── SignFlip x {c.L}",
            f"│   └── ReductionAdderTree[L={c.L}] + Accumulate",
            f"└── OutputBuffer[{c.K} x acc]",
        ])

    def report(self) -> str:
        c = self.config
        return (
            f"{self.netlist.summary()}\n"
            f"  area      : {self.area_mm2 * 1e6:,.0f} um^2 ({self.area_mm2:.4f} mm^2)\n"
            f"  peak      : {cm.tops(c.n, c.m):.3f} TOPS @ {cm.F_CLK_16NM/1e6:.0f} MHz"
            f" -> {self.tops_per_mm2:.1f} TOPS/mm^2\n"
            f"  encoding  : {key_bits(c.mu)} bits / {c.mu} weights"
            f" = {key_bits(c.mu)/c.mu:.3f} b/w"
        )


def _align(x: int, a: int) -> int:
    return max(a, ((x + a - 1) // a) * a)


def generate(config: LUTCoreConfig, mode: str = "paper") -> LUTCoreDesign:
    """Instantiate a design point (the generator's main entry)."""
    net = nl.make_netlist(config.mu, config.L, config.K)
    prog = nl.build_program(config.mu)
    area = cm.lut_core_area_mm2(config.mu, config.n, config.m, config.act_dtype, mode)
    eff = cm.tops_per_mm2(config.mu, config.n, config.m, config.act_dtype, mode=mode)
    mu = config.mu
    plan = KernelPlan(
        mu=mu,
        kernel="lut_gather" if mu == lut.KERNEL_MU else None,
        block_n=_align(config.n, KERNEL_GROUPS_PER_STEP * mu),
        block_m=_align(config.m, KERNEL_WARP_COLUMNS),
        table_entries=table_size(mu) + 1,
        key_bits=key_bits(mu),
    )
    return LUTCoreDesign(config=config, netlist=net, build_program=prog,
                         area_mm2=area, tops_per_mm2=eff, kernel_plan=plan)


def generate_optimal(throughput: int, act_dtype: str, mode: str = "paper") -> LUTCoreDesign:
    """Generator + DSE: emit the area-optimal core at a throughput target."""
    p = dse.optimal_config_at_throughput(throughput, act_dtype, mode=mode)
    return generate(LUTCoreConfig(mu=p.mu, L=p.L, K=p.K, act_dtype=act_dtype), mode)
