"""The analytical cost-model formulae the dispatch prior needs (paper §IV,
Eqs. 5-10, "paper" mode), with the reference's calibrated unit-cell
coefficients.  Area is in NAND2-gate-equivalents; the prior only compares
kernels against each other, so no technology scaling is needed here."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.encoding import table_size


@dataclass(frozen=True)
class Coeffs:
    """Unit-cell areas in NAND2-equivalents (paper §IV-B coefficients)."""

    name: str
    a_add: float   # scalar adder of the activation dtype (pipelined)
    a_mul: float   # scalar multiplier (dequant baseline only)
    a_mux: float   # word-sized 2:1 mux
    a_inv: float   # sign-inversion overhead, amortized per mux unit (Eq. 9)
    a_reg: float   # word-sized register
    a_deq: float   # ternary→word dequant cell (dequant baseline only)
    gamma: float   # per-dtype global scaling factor (paper §V-B)


FP16 = Coeffs(name="fp16", a_add=1041.2, a_mul=393.0, a_mux=24.4, a_inv=7.3,
              a_reg=150.6, a_deq=18.7, gamma=0.9002)
INT8 = Coeffs(name="int8", a_add=72.6, a_mul=150.8, a_mux=8.0, a_inv=14.0,
              a_reg=200.0, a_deq=11.1, gamma=0.911)

COEFFS = {"fp16": FP16, "int8": INT8}


def get_coeffs(dtype: str) -> Coeffs:
    return COEFFS[dtype.lower()]


def build_cost(mu: int, n: int) -> float:
    """Eq. 5: Build+ adders ≈ (3.069^mu / 1.938) · (n/mu)."""
    return (3.069**mu / 1.938) * (n / mu)


def accumulate_cost(mu: int, n: int, m: int) -> float:
    """Eq. 6: L·K = n·m/mu accumulate adders."""
    return n * m / mu


def mux_cost(mu: int, n: int, m: int) -> float:
    """Eq. 7: (n·m/mu) · (3^mu - 1)/2 two-to-one mux equivalents."""
    return (n * m / mu) * table_size(mu)


def outreg_cost(m: int) -> float:
    """Eq. 8: K = m output accumulator registers."""
    return float(m)


def area_gates_lut(mu: int, n: int, m: int, c: Coeffs) -> float:
    """Eq. 9 in NAND2-equivalents."""
    a = c.a_add * (build_cost(mu, n) + accumulate_cost(mu, n, m))
    a += (c.a_mux + c.a_inv) * mux_cost(mu, n, m)
    a += c.a_reg * outreg_cost(m)
    return a


def area_gates_dequant_baseline(n: int, m: int, c: Coeffs) -> float:
    """Fig. 1 left: dequantize ternary→word, full-width multiply, accumulate."""
    return n * m * (c.a_mul + c.a_add + c.a_deq) + c.a_reg * m


def area_gates_signflip_baseline(n: int, m: int, c: Coeffs) -> float:
    """Fig. 1 middle: 3:1 mux (x, -x, 0) + accumulate adder per PE."""
    per_pe = c.a_add + 2 * c.a_mux + c.a_inv
    return n * m * per_pe + c.a_reg * m


def area_per_throughput(mu: int, n: int, m: int, c: Coeffs) -> float:
    """Eq. 10: gates per (mul/cycle)."""
    return area_gates_lut(mu, n, m, c) / (n * m)
