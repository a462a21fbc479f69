"""The port's hardware-generation side against the JAX package's: the
netlist (Eqs. 2-4, the Build-phase DAG, the core's unit counts), the §IV
cost model in its three modes, the DSE, the generator's report and module
hierarchy, the calibration fit, the two-phase LUT oracle and the
functional simulator, on the same inputs from numpy seeds.

Tolerances, and why:
  * netlist, cost model, DSE, generator and calibration: exactly equal.
    Both sides run the same scalar float64 formulas in the same order.
  * the LUT oracle: exact on integer activations (sums of integers), 1e-5
    relative to the largest magnitude on f32 (a ``mu``-term dot product
    and a sum over groups, each summed in its own order).
  * the simulator: bit-exact ``y`` in int64 with equal ``SimStats``; in
    float64 equal to the reference's simulator (the same adds in the same
    order) and within the reference's own rtol 1e-9 of ``w @ x``.
"""

import dataclasses
from dataclasses import astuple

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import calibration as jcal
from repro.core import cost_model as jcm
from repro.core import dse as jdse
from repro.core import encoding as jenc
from repro.core import generator as jgen
from repro.core import lut_algorithm as jlut
from repro.core import netlist as jnl
from repro.core import simulator as jsim
from repro_torch.core import calibration as tcal
from repro_torch.core import cost_model as tcm
from repro_torch.core import dse as tdse
from repro_torch.core import encoding as tenc
from repro_torch.core import generator as tgen
from repro_torch.core import lut_algorithm as tlut
from repro_torch.core import netlist as tnl
from repro_torch.core import simulator as tsim
from repro_torch.kernels import lut_matmul as tkern

MODES = ["paper", "exact", "bound"]
#: design points of the generator's report: the paper's Table IV core, the
#: Table V rows' configurations, and edges of the mu range
DESIGNS = [(3, 32, 32, "fp16"), (2, 32, 32, "int8"), (2, 34, 30, "int8"),
           (3, 28, 16, "int8"), (4, 32, 32, "fp16"), (1, 8, 8, "int8"),
           (5, 6, 30, "fp16"), (6, 2, 3, "int8")]


# ---------------------------------------------------------------------------
# netlist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mu", [1, 2, 3, 4, 5, 6])
def test_netlist_counts_and_build_program_equal_jax(mu):
    for fn in ("naive_adders", "naive_adders_nonzero", "symmetry_adders",
               "S_redundancy", "R_sparsity", "bound_adders",
               "adder_reduction_vs_naive", "constructive_adders"):
        assert getattr(tnl, fn)(mu) == getattr(jnl, fn)(mu), fn
    tp, jp = tnl.build_program(mu), jnl.build_program(mu)
    assert [astuple(op) for op in tp.ops] == [astuple(op) for op in jp.ops]
    assert (tp.n_adders, tp.depth) == (jp.n_adders, jp.depth)
    for L, K in ((1, 1), (32, 32), (34, 30), (7, 5)):
        tn, jn = tnl.make_netlist(mu, L, K), jnl.make_netlist(mu, L, K)
        assert astuple(tn) == astuple(jn)
        assert (tn.summary(), tn.throughput) == (jn.summary(), jn.throughput)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_cost_model_equals_jax_over_the_table_iii_grid(mode):
    for dt in ("int8", "fp16"):
        tc, jc = tcm.get_coeffs(dt), jcm.get_coeffs(dt)
        assert astuple(tc) == astuple(jc)
        for t in (8, 32, 64, 96):
            for mu in (1, 2, 3, 4, 5):
                if t % mu:
                    continue
                args = (mu, t, t)
                assert tcm.build_cost(mu, t, mode) == jcm.build_cost(mu, t, mode)
                assert tcm.area_gates_lut(*args, tc, mode) == \
                    jcm.area_gates_lut(*args, jc, mode)
                assert tcm.lut_core_area_mm2(*args, dt, mode) == \
                    jcm.lut_core_area_mm2(*args, dt, mode)
                assert tcm.tops_per_mm2(*args, dt, mode=mode) == \
                    jcm.tops_per_mm2(*args, dt, mode=mode)
                assert tcm.area_per_throughput(*args, tc, mode) == \
                    jcm.area_per_throughput(*args, jc, mode)
                assert tcm.breakdown(*args, dt, mode) == \
                    jcm.breakdown(*args, dt, mode)
                assert tcm.power_proxy_breakdown(*args, dt) == \
                    jcm.power_proxy_breakdown(*args, dt)
            assert tcm.optimal_mu(t, t, dt, mode=mode) == \
                jcm.optimal_mu(t, t, dt, mode=mode)
            for fn in ("area_gates_dequant_baseline",
                       "area_gates_signflip_baseline"):
                assert getattr(tcm, fn)(t, t, tc) == getattr(jcm, fn)(t, t, jc)
            assert tcm.tops(t, t) == jcm.tops(t, t)
            assert tcm.area_um2(t * 100.0, tc) == jcm.area_um2(t * 100.0, jc)
    assert tcm.roundtrip_16nm_from_28nm(640_000.0) == \
        jcm.roundtrip_16nm_from_28nm(640_000.0)
    for name in ("UM2_PER_GATE_16NM", "SCALE_28_TO_16_AREA",
                 "SCALE_28_TO_16_DELAY", "F_CLK_SYNTH", "F_CLK_16NM"):
        assert getattr(tcm, name) == getattr(jcm, name)


def test_set_coeffs_installs_and_the_default_stays():
    old = tcm.COEFFS["int8"]
    try:
        tcm.set_coeffs("INT8", a_add=50.0)
        assert tcm.get_coeffs("int8") == dataclasses.replace(old, a_add=50.0)
    finally:
        tcm.COEFFS["int8"] = old
    with pytest.raises(ValueError):
        tcm.build_cost(3, 96, mode="bogus")


# ---------------------------------------------------------------------------
# DSE and the generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_dse_equals_jax(mode):
    assert tdse.sweep_square_tiles(mode=mode) == jdse.sweep_square_tiles(mode=mode)
    assert tdse.sota_comparison(mode) == jdse.sota_comparison(mode)
    for dt in ("int8", "fp16"):
        assert tdse.geometry_sweep(1024, dt, mode) == \
            jdse.geometry_sweep(1024, dt, mode)
        assert tdse.frontier(dt, mode=mode) == jdse.frontier(dt, mode=mode)
        for t in (1024, 1334, 2048):
            tp = tdse.optimal_geometry(t, dt, mode=mode)
            jp = jdse.optimal_geometry(t, dt, mode=mode)
            assert astuple(tp) == astuple(jp)
            assert tp.area_um2(mode) == jp.area_um2(mode)
        assert tdse.optimal_mu_for_tile(96, 32, dt, mode=mode) == \
            jdse.optimal_mu_for_tile(96, 32, dt, mode=mode)
    assert tdse.SOTA == jdse.SOTA


@pytest.mark.parametrize("mu,L,K,dt", DESIGNS)
def test_generated_design_equals_jax(mu, L, K, dt):
    td = tgen.generate(tgen.LUTCoreConfig(mu=mu, L=L, K=K, act_dtype=dt))
    jd = jgen.generate(jgen.LUTCoreConfig(mu=mu, L=L, K=K, act_dtype=dt))
    assert td.report() == jd.report()
    assert td.module_hierarchy() == jd.module_hierarchy()
    assert astuple(td.netlist) == astuple(jd.netlist)
    assert (td.area_mm2, td.tops_per_mm2) == (jd.area_mm2, jd.tops_per_mm2)
    plan = td.kernel_plan
    assert plan.kernel == ("lut_gather" if mu == tkern.KERNEL_MU else None)
    assert plan.block_n % (tgen.KERNEL_GROUPS_PER_STEP * mu) == 0
    assert plan.block_n >= td.config.n and plan.block_m >= td.config.m
    assert plan.block_m % tgen.KERNEL_WARP_COLUMNS == 0
    assert (plan.table_entries, plan.key_bits) == \
        (jd.kernel_plan.table_entries, jd.kernel_plan.key_bits)


def test_generate_optimal_and_config_checks_equal_jax():
    for t, dt in ((2048, "int8"), (1024, "fp16"), (1344, "int8")):
        td, jd = tgen.generate_optimal(t, dt), jgen.generate_optimal(t, dt)
        assert astuple(td.config) == astuple(jd.config)
        assert td.report() == jd.report()
    for bad in (dict(mu=0), dict(mu=9), dict(L=0), dict(act_dtype="bf16")):
        with pytest.raises(ValueError):
            tgen.LUTCoreConfig(**bad)


def test_kernel_plan_runs_lut_gather_at_mu_3_and_names_none_elsewhere():
    rng = np.random.default_rng(3)
    w = rng.integers(-1, 2, size=(40, 50)).astype(np.int8)
    x = torch.tensor(rng.integers(-128, 128, size=(2, 50)), dtype=torch.float32)
    keys = tenc.encode_weight_matrix(torch.from_numpy(w), 3)
    plan = tgen.generate(tgen.LUTCoreConfig()).kernel_plan
    assert torch.equal(plan.run(x, keys), tkern.lut_matmul_torch(x, keys, 3))
    assert torch.equal(plan.run(x, keys), x @ torch.from_numpy(w).float().T)
    other = tgen.generate(tgen.LUTCoreConfig(mu=2)).kernel_plan
    with pytest.raises(ValueError, match="mu=2"):
        other.run(x, tenc.encode_weight_matrix(torch.from_numpy(w), 2))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_calibration_fit_equals_jax_in_mains_order(monkeypatch, capsys):
    """Both dtypes fitted from one ``default_rng(0)``, fp16 first, as each
    package's ``main`` does; the reports printed alike."""
    monkeypatch.setattr(jcal, "RNG", np.random.default_rng(0))
    rng = np.random.default_rng(0)
    for dt in ("fp16", "int8"):
        jc, js = jcal.fit(dt, n_random=60, n_refine=30)
        tc, ts = tcal.fit(dt, n_random=60, n_refine=30, rng=rng)
        assert (astuple(tc), ts) == (astuple(jc), js)
        capsys.readouterr()
        jcal.report(jc)
        want = capsys.readouterr().out
        tcal.report(tc)
        assert capsys.readouterr().out == want
    # fitting installs nothing: the cost model keeps its calibrated defaults
    assert tcm.COEFFS == {"fp16": tcm.FP16, "int8": tcm.INT8}


# ---------------------------------------------------------------------------
# the two-phase LUT oracle
# ---------------------------------------------------------------------------


def _j(a):
    return np.array(a)


@pytest.mark.parametrize("mu", [1, 3])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_lut_algorithm_equals_jax(mu, dtype):
    rng = np.random.default_rng(10 + mu)
    w = rng.integers(-1, 2, size=(13, 29)).astype(np.int8)
    if dtype == "int32":
        x = rng.integers(-128, 128, size=(3, 29)).astype(np.int32)
    else:
        x = rng.normal(size=(3, 29)).astype(np.float32)
    keys = jenc.encode_weight_matrix(w, mu)
    tkeys = tenc.encode_weight_matrix(torch.from_numpy(w), mu)
    np.testing.assert_array_equal(tkeys.numpy().astype(np.int32),
                                  _j(keys).astype(np.int32))
    tx = torch.from_numpy(x)

    def check(got, want):
        got, want = got.numpy(), _j(want)
        assert got.shape == want.shape
        if dtype == "int32":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())

    check(tlut.group_activations(tx, mu), jlut.group_activations(x, mu))
    tables = jlut.lut_build(jlut.group_activations(x, mu), mu)
    check(tlut.lut_build(tlut.group_activations(tx, mu), mu), tables)
    check(tlut.lut_fetch_accumulate(torch.from_numpy(_j(tables)), tkeys, mu),
          jlut.lut_fetch_accumulate(tables, keys, mu))
    check(tlut.lut_matmul_keys(tx, tkeys, mu), jlut.lut_matmul_keys(x, keys, mu))
    check(tlut.lut_matmul(tx, torch.from_numpy(w), mu), jlut.lut_matmul(x, w, mu))
    check(tlut.lut_matmul_onehot(tx, tkeys, mu),
          jlut.lut_matmul_onehot(x, keys, mu))
    if dtype == "int32":
        np.testing.assert_array_equal(
            tlut.lut_matmul(tx, torch.from_numpy(w), mu).numpy(),
            x.astype(np.int64) @ w.T.astype(np.int64))


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

#: (mu, L, K, M, N, seed): the ranges of tests/test_simulator.py's cases
SIM_CASES = [(1, 1, 1, 1, 1, 0), (1, 5, 3, 30, 40, 1), (2, 3, 5, 17, 23, 2),
             (2, 1, 4, 8, 39, 3), (3, 2, 2, 29, 11, 4), (3, 5, 5, 1, 40, 5),
             (4, 1, 1, 12, 7, 6), (4, 4, 2, 25, 33, 7), (3, 32, 32, 30, 40, 8)]


@pytest.mark.parametrize("mu,L,K,M,N,seed", SIM_CASES)
def test_simulator_bit_exact_with_equal_stats(mu, L, K, M, N, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-1, 2, size=(M, N)).astype(np.int8)
    x = rng.integers(-100, 100, size=N).astype(np.int64)
    cfg = dict(mu=mu, L=L, K=K, act_dtype="int8")
    jy, jstats = jsim.simulate_gemv(jgen.generate(jgen.LUTCoreConfig(**cfg)), w, x)
    ty, tstats = tsim.simulate_gemv(tgen.generate(tgen.LUTCoreConfig(**cfg)),
                                    torch.from_numpy(w), torch.from_numpy(x),
                                    device="cpu")
    assert ty.dtype == torch.int64
    np.testing.assert_array_equal(ty.numpy(), jy)
    np.testing.assert_array_equal(ty.numpy(), w.astype(np.int64) @ x)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    y, y_ref, _ = tsim.simulate_vs_reference(tgen.LUTCoreConfig(**cfg), w, x,
                                             device="cpu")
    assert torch.equal(y, y_ref)


def test_simulator_float64_and_the_schedule():
    rng = np.random.default_rng(0)
    w = rng.integers(-1, 2, size=(9, 21)).astype(np.int8)
    x = rng.normal(size=21).astype(np.float64)
    cfg = dict(mu=3, L=2, K=4, act_dtype="fp16")
    jy, jstats = jsim.simulate_gemv(jgen.generate(jgen.LUTCoreConfig(**cfg)), w, x)
    ty, tstats = tsim.simulate_gemv(tgen.generate(tgen.LUTCoreConfig(**cfg)),
                                    w, x, device="cpu")
    assert ty.dtype == torch.float64
    np.testing.assert_array_equal(ty.numpy(), jy)
    np.testing.assert_allclose(ty.numpy(), w.astype(np.float64) @ x, rtol=1e-9)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    # Eq. 1: steady state approaches n·m multiplies a cycle
    d = tgen.generate(tgen.LUTCoreConfig(mu=2, L=4, K=4, act_dtype="int8"))
    w = np.random.default_rng(0).integers(-1, 2, size=(64, 64)).astype(np.int8)
    _, stats = tsim.simulate_gemv(d, w, np.arange(64), device="cpu")
    assert stats.muls_per_cycle / d.config.throughput_mul_per_cycle > 0.9


def test_simulator_at_mu_3_equals_the_lut_kernels_plain_version():
    rng = np.random.default_rng(21)
    w = torch.from_numpy(rng.integers(-1, 2, size=(70, 100)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-128, 128, size=100).astype(np.int64))
    d = tgen.generate(tgen.LUTCoreConfig(mu=3, L=32, K=32, act_dtype="int8"))
    y, _ = tsim.simulate_gemv(d, w, x, device="cpu")
    keys = tenc.encode_weight_matrix(w, 3)
    want = tkern.lut_matmul_torch(x.to(torch.float32)[None], keys, 3)[0]
    assert torch.equal(y.to(torch.float32), want)
    assert torch.equal(y, (w.to(torch.int64) * x).sum(-1))
