"""Design-space exploration engine (paper §VI-VII).

Sweeps the ``(mu, L, K, dtype)`` space with the analytical cost model,
reproduces the paper's exploration figures/tables, and re-derives the
state-of-the-art comparison (Table V): given a published design's throughput,
find the area-optimal configuration at matched throughput and report the
model-predicted improvement.

The port's copy of the reference's DSE: scalar bookkeeping in numpy/float64
on the port's cost model, whose results equal the reference's exactly.
Areas are the paper's 16 nm ASIC model (µm², mm²) and TOPS/mm² is at its
800 MHz clock (``cost_model.F_CLK_16NM``): modelled, not measured.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import cost_model as cm
from repro_torch.core import netlist as nl


@dataclass(frozen=True)
class DesignPoint:
    mu: int
    L: int
    K: int
    dtype: str

    @property
    def n(self) -> int:
        return self.L * self.mu

    @property
    def m(self) -> int:
        return self.K

    @property
    def throughput(self) -> int:
        return self.n * self.m

    def area_gates(self, mode: str = "paper") -> float:
        return cm.area_gates_lut(self.mu, self.n, self.m, cm.get_coeffs(self.dtype), mode)

    def area_mm2(self, mode: str = "paper") -> float:
        return cm.lut_core_area_mm2(self.mu, self.n, self.m, self.dtype, mode)

    def area_um2(self, mode: str = "paper") -> float:
        return self.area_mm2(mode) * 1e6

    def tops_per_mm2(self, f_clk: float = cm.F_CLK_16NM, mode: str = "paper") -> float:
        return cm.tops(self.n, self.m, f_clk) / self.area_mm2(mode)


def sweep_square_tiles(tile_sizes=(8, 32, 64, 96), mus=(1, 2, 3, 4, 5),
                       dtypes=("int8", "fp16"), mode: str = "paper") -> list[dict]:
    """The Table III grid: square tiles × group sizes × dtypes."""
    out = []
    for dt in dtypes:
        for t in tile_sizes:
            for mu in mus:
                if t % mu:
                    continue  # L = n/mu must be integral
                p = DesignPoint(mu=mu, L=t // mu, K=t, dtype=dt)
                out.append({
                    "dtype": dt, "tile": t, "mu": mu, "L": p.L, "K": p.K,
                    "area_mm2": p.area_mm2(mode),
                    "tops_per_mm2": p.tops_per_mm2(mode=mode),
                })
    return out


def optimal_mu_for_tile(n: int, m: int, dtype: str, mus=range(1, 6), mode="paper") -> int:
    valid = [mu for mu in mus if n % mu == 0]
    return min(valid, key=lambda mu: cm.area_gates_lut(mu, n, m, cm.get_coeffs(dtype), mode))


def optimal_config_at_throughput(target: int, dtype: str, tol: float = 0.02,
                                 mus=range(1, 6), mode: str = "paper") -> DesignPoint:
    """Area-optimal (L, mu, K) whose throughput is within ``tol`` of target
    without exceeding it (the paper matches from below: 2040 ≤ 2048,
    1334 ≤ 1344).  Vectorized with numpy: the calibration loop calls this
    thousands of times."""
    import numpy as np

    c = cm.get_coeffs(dtype)
    best = None
    best_area = math.inf
    for mu in mus:
        K = np.arange(1, target // mu + 1)
        L_hi = target // (mu * K)
        # candidate L values: floor and floor-1 (throughput from below)
        for L in (L_hi, np.maximum(L_hi - 1, 1)):
            t = L * mu * K
            ok = (t >= target * (1 - tol)) & (t <= target) & (L >= 1)
            if not ok.any():
                continue
            Lv, Kv = L[ok], K[ok]
            n = Lv * mu
            m = Kv
            if mode == "paper":
                badd = (3.069**mu / 1.938) * (n / mu)
            else:
                per = nl.constructive_adders(mu) if mode == "exact" else nl.bound_adders(mu)
                badd = per * (n / mu)
            T = (3**mu - 1) // 2
            area = (c.a_add * (badd + n * m / mu)
                    + (c.a_mux + c.a_inv) * (n * m / mu) * T
                    + c.a_reg * m)
            # Normalize by achieved throughput so the within-tolerance band
            # does not bias toward lower-throughput (hence smaller) designs.
            eff = area / t[ok]
            i = int(np.argmin(eff))
            if eff[i] < best_area:
                best_area = float(eff[i])
                best = DesignPoint(mu=mu, L=int(Lv[i]), K=int(Kv[i]), dtype=dtype)
    assert best is not None
    return best


def optimal_geometry(throughput: int, dtype: str, mus=range(1, 6),
                     mode: str = "paper") -> DesignPoint:
    """Unconstrained-aspect optimum at ~exact throughput (Fig. 8)."""
    return optimal_config_at_throughput(throughput, dtype, tol=0.05, mus=mus, mode=mode)


def geometry_sweep(throughput: int, dtype: str, mode: str = "paper") -> list[dict]:
    """Fig. 8: area across aspect ratios at fixed throughput, each point using
    its own optimal mu.  Returns records with n, m, mu, area and Δ vs square."""
    recs = []
    for m in range(4, throughput // 4 + 1):
        n = throughput // m
        if n * m != throughput or n < 4:
            continue
        mus = [mu for mu in range(1, 6) if n % mu == 0]
        if not mus:
            continue
        mu = min(mus, key=lambda u: cm.area_gates_lut(u, n, m, cm.get_coeffs(dtype), mode))
        recs.append({
            "n": n, "m": m, "mu": mu, "aspect": n / m,
            "area_mm2": cm.lut_core_area_mm2(mu, n, m, dtype, mode),
        })
    side = int(round(math.sqrt(throughput)))
    square = min(recs, key=lambda r: abs(r["n"] - side))
    for r in recs:
        r["delta_vs_square"] = 1.0 - r["area_mm2"] / square["area_mm2"]
    return recs


# ---------------------------------------------------------------------------
# State-of-the-art reconfiguration (Table V)
# ---------------------------------------------------------------------------

#: Published designs (paper Table II / V).  TeLLMe-v2's "ours" row lists
#: (26,2,23) with throughput 1334; 26·2·23 = 1196 ≠ 1334 while 29·2·23 = 1334,
#: so we take L=29 as the intended value (typo in the paper) and report both.
SOTA = {
    "tenet": dict(L=32, mu=2, K=32, dtype="int8", tech="28nm",
                  area_um2=640_000.0, throughput=2048),
    "tellme_v2": dict(L=28, mu=3, K=16, dtype="int8", tech="fpga",
                      area_lut=35_200, throughput=1344),
    "slim_llama": dict(L=8, mu=3, K=2, dtype="int8", tech="28nm",
                       throughput=48),
    "figlut": dict(L=32, mu=4, K=32, dtype="fp16", tech=None, throughput=4096),
}


def sota_comparison(mode: str = "paper") -> list[dict]:
    """Reproduce Table V: for each published design, find the model-optimal
    matched-throughput configuration and the predicted area ratio."""
    rows = []
    for name, spec in SOTA.items():
        theirs = DesignPoint(mu=spec["mu"], L=spec["L"], K=spec["K"], dtype=spec["dtype"])
        ours = optimal_config_at_throughput(spec["throughput"], spec["dtype"], mode=mode)
        ratio = theirs.area_gates(mode) / ours.area_gates(mode)
        row = {
            "work": name,
            "theirs": (theirs.L, theirs.mu, theirs.K),
            "theirs_throughput": theirs.throughput,
            "ours": (ours.L, ours.mu, ours.K),
            "ours_throughput": ours.throughput,
            "model_prediction": ratio,
            "ours_area_um2": ours.area_um2(mode),
        }
        if spec.get("tech") == "28nm" and "area_um2" in spec:
            row["theirs_area_16nm_um2"] = cm.roundtrip_16nm_from_28nm(spec["area_um2"])
            row["area_decrease_vs_published"] = row["theirs_area_16nm_um2"] / row["ours_area_um2"]
        rows.append(row)
    return rows


def frontier(dtype: str, throughputs=(256, 512, 1024, 2048, 4096), mode="paper") -> list[dict]:
    """Efficiency frontier: optimal design per throughput target."""
    out = []
    for t in throughputs:
        p = optimal_config_at_throughput(t, dtype, mode=mode)
        out.append({"throughput": t, "mu": p.mu, "L": p.L, "K": p.K,
                    "n": p.n, "m": p.m, "area_mm2": p.area_mm2(mode),
                    "tops_per_mm2": p.tops_per_mm2(mode=mode)})
    return out
