"""Coefficient calibration against the paper's published anchors (§V-B).

The paper calibrates ``a_add, a_mux, a_inv, a_reg`` by synthesizing isolated
unit cells in TSMC 16nm and then fits a per-dtype global factor γ.  Without
EDA tools we instead fit gate-count coefficients (inside standard-cell
plausibility bounds) so that the model reproduces the paper's *published
results*, then solve γ analytically from the absolute-area anchors:

FP16 targets
  T1  argmin_mu area(32×32) = 3                       (Fig. 5 / Table IV)
  T2  dequant-baseline / LUT(mu=3) area = 2.23        (Table IV)
  T3  sign-flip-baseline / LUT(mu=3) area = 1.64      (Table IV)
  T4  optimal geometry at fixed throughput has K > L·mu  (Fig. 8)
  A1  area(mu=3, 32×32) = 0.120 mm²                   (Table IV, sets γ_fp16)

INT8 targets
  T5  argmin_mu area(32×32) ∈ {1, 2}; area(mu=1)/area(opt) ≤ 1.15 ("minimal
      LUT benefit", Fig. 6a)
  T6  TENET (L,mu,K)=(32,2,32) within ~1% of matched-throughput optimum
      (Table V model prediction 1.004×)
  T7  TeLLMe-v2 (28,3,16) vs optimum ≈ 1.22× (soft — published number is in
      FPGA LUTs, a different cost domain; we report the ASIC-model value)
  T8  optimal geometry has L·mu > K                   (Fig. 8)
  A2  area((34,2,30)) = 33 125 µm² @16nm              (Table V, sets γ_int8)

Run ``python -m repro_torch.core.calibration`` to re-fit and print the
table; the fitted values are installed as the defaults in
``repro_torch.core.cost_model``.

The port's copy of the reference's calibration.  The reference draws from
one module-level generator; here the caller passes one (``rng``), and
:func:`main` passes one ``default_rng(0)`` through the fp16 fit and then
the int8 fit, the reference's order, so it prints the reference's fitted
coefficients and scores.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core import dse

# Plausibility bounds (NAND2-equivalents) for each coefficient.
BOUNDS_FP16 = dict(a_add=(350, 1100), a_mul=(350, 1100), a_mux=(10, 36),
                   a_inv=(1, 8), a_reg=(70, 160), a_deq=(10, 60))
BOUNDS_INT8 = dict(a_add=(28, 100), a_mul=(90, 260), a_mux=(8, 20),
                   a_inv=(14, 34), a_reg=(70, 200), a_deq=(4, 24))


def _area(mu, n, m, c):
    return cm.area_gates_lut(mu, n, m, c, mode="paper")


def _score_fp16(c: cm.Coeffs) -> float:
    areas = {mu: _area(mu, 32, 32, c) for mu in range(1, 6)}
    pen = 0.0
    # strict mu=3 optimum with >=2.5% margin (robust to coefficient rounding)
    if not (areas[3] < 0.975 * areas[2] and areas[3] < 0.975 * areas[4]):
        pen += 10.0
    lut3 = areas[3]
    deq = cm.area_gates_dequant_baseline(32, 32, c)
    sf = cm.area_gates_signflip_baseline(32, 32, c)
    pen += (deq / lut3 / 2.23 - 1.0) ** 2 * 100
    pen += (sf / lut3 / 1.64 - 1.0) ** 2 * 100
    # Fig. 8 geometry: continuous-relaxation optimum n/m = sqrt(a_reg / bcoef)
    bcoef = c.a_add * 3.069**3 / (1.938 * 3)
    if c.a_reg >= bcoef:  # must favor m > n
        pen += 10.0
    # plausibility nudge: FP16 adder within ~2.6x of multiplier either way
    # (deeply pipelined FP adders carry large staging-register overhead)
    r = c.a_add / c.a_mul
    if r < 0.5 or r > 2.6:
        pen += (min(abs(r - 0.5), abs(r - 2.6))) ** 2 * 0.5
    return pen


def _score_int8(c: cm.Coeffs) -> float:
    areas = {mu: _area(mu, 32, 32, c) for mu in range(1, 6)}
    pen = 0.0
    opt = min(areas, key=areas.get)
    if opt not in (1, 2):
        pen += 10.0
    pen += max(0.0, areas[1] / areas[opt] - 1.25) ** 2 * 60
    with _temp_coeffs("int8", c):
        # T6: TENET near-optimal at matched throughput
        tenet = dse.DesignPoint(mu=2, L=32, K=32, dtype="int8")
        best = dse.optimal_config_at_throughput(2048, "int8")
        ratio_tenet = (tenet.area_gates() / tenet.throughput) / \
                      (best.area_gates() / best.throughput)
        tellme = dse.DesignPoint(mu=3, L=28, K=16, dtype="int8")
        best_t = dse.optimal_config_at_throughput(1344, "int8")
        ratio_tellme = (tellme.area_gates() / tellme.throughput) / \
                       (best_t.area_gates() / best_t.throughput)
        # T8: discrete geometry optimum must favor L*mu > K (Fig. 8)
        for tgt in (1024, 2048):
            g = dse.optimal_geometry(tgt, "int8")
            if g.n <= g.m:
                pen += 5.0
    pen += (ratio_tenet / 1.004 - 1.0) ** 2 * 60
    pen += (ratio_tellme / 1.22 - 1.0) ** 2 * 8  # soft (FPGA domain)
    return pen


class _temp_coeffs:
    def __init__(self, dtype, c):
        self.dtype, self.c = dtype, c

    def __enter__(self):
        self.old = cm.COEFFS[self.dtype]
        cm.COEFFS[self.dtype] = self.c

    def __exit__(self, *a):
        cm.COEFFS[self.dtype] = self.old


def _sample(rng, bounds, base=None, jitter=0.0):
    out = {}
    for k, (lo, hi) in bounds.items():
        if base is None:
            out[k] = rng.uniform(lo, hi)
        else:
            span = (hi - lo) * jitter
            out[k] = float(np.clip(base[k] + rng.uniform(-span, span), lo, hi))
    return out


def fit(dtype: str, n_random: int = 3000, n_refine: int = 1500, *,
        rng: np.random.Generator) -> tuple[cm.Coeffs, float]:
    """Random search, then a shrinking refinement, over ``dtype``'s
    plausibility bounds, drawing from ``rng``; γ from the absolute anchor.
    Returns the rounded coefficients and the best score."""
    bounds = BOUNDS_FP16 if dtype == "fp16" else BOUNDS_INT8
    score = _score_fp16 if dtype == "fp16" else _score_int8
    best_kw, best_s = None, np.inf
    for _ in range(n_random):
        kw = _sample(rng, bounds)
        s = score(cm.Coeffs(name=dtype, gamma=1.0, **kw))
        if s < best_s:
            best_kw, best_s = kw, s
    for i in range(n_refine):
        kw = _sample(rng, bounds, base=best_kw, jitter=0.15 * (1 - i / n_refine) + 0.01)
        s = score(cm.Coeffs(name=dtype, gamma=1.0, **kw))
        if s < best_s:
            best_kw, best_s = kw, s
    c = cm.Coeffs(name=dtype, gamma=1.0, **{k: round(v, 1) for k, v in best_kw.items()})
    # γ from the absolute anchor.
    if dtype == "fp16":
        raw = cm.area_mm2(_area(3, 32, 32, c), c)  # gamma=1
        gamma = 0.120 / raw
    else:
        raw = cm.area_um2(_area(2, 68, 30, c), c)
        gamma = 33_125.0 / raw
    c = cm.Coeffs(name=dtype, gamma=round(float(gamma), 4),
                  **{k: round(v, 1) for k, v in best_kw.items()})
    return c, best_s


def report(c: cm.Coeffs) -> None:
    print(f"== {c.name} ==  {c}")
    with _temp_coeffs(c.name, c):
        areas = {mu: _area(mu, 32, 32, c) for mu in range(1, 6)}
        opt = min(areas, key=areas.get)
        print(f"  argmin mu @32x32: {opt}; rel areas:",
              {mu: round(a / areas[opt], 3) for mu, a in areas.items()})
        if c.name == "fp16":
            lut3 = areas[3]
            print(f"  dequant ratio  = {cm.area_gates_dequant_baseline(32,32,c)/lut3:.3f}  (paper 2.23)")
            print(f"  signflip ratio = {cm.area_gates_signflip_baseline(32,32,c)/lut3:.3f}  (paper 1.64)")
            print(f"  area(mu=3,32x32) = {cm.lut_core_area_mm2(3,32,32,'fp16'):.4f} mm^2  (paper 0.120)")
        else:
            tenet = dse.DesignPoint(mu=2, L=32, K=32, dtype="int8")
            best = dse.optimal_config_at_throughput(2048, "int8")
            print(f"  TENET ratio = {tenet.area_gates()/best.area_gates():.4f} (paper 1.004), "
                  f"opt={best.mu,best.L,best.K}")
            tellme = dse.DesignPoint(mu=3, L=28, K=16, dtype="int8")
            best_t = dse.optimal_config_at_throughput(1344, "int8")
            print(f"  TeLLMe ratio = {tellme.area_gates()/best_t.area_gates():.4f} (paper 1.22 in FPGA LUTs), "
                  f"opt={best_t.mu,best_t.L,best_t.K}")
            print(f"  area((34,2,30)) = {dse.DesignPoint(mu=2,L=34,K=30,dtype='int8').area_um2():.0f} um^2 (paper 33125)")
        g = dse.optimal_geometry(1024, c.name)
        print(f"  optimal geometry @1024: n={g.n} m={g.m} mu={g.mu} "
              f"({'K>L*mu' if g.m > g.n else 'L*mu>K'})")


def main():
    rng = np.random.default_rng(0)
    for dtype in ("fp16", "int8"):
        c, s = fit(dtype, rng=rng)
        cm.COEFFS[dtype] = c
        print(f"fit score {s:.4f}")
        report(c)
        print(f"  -> install in cost_model.py: {c!r}")


if __name__ == "__main__":
    main()
