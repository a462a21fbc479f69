"""The port's dry-run tooling against the JAX package's: the shapes and
cells (``configs/shapes.py``, ``configs/registry.py``), the op counter
(``launch/op_cost.py``, the counterpart of ``launch/hlo_cost.py``), the
roofline on the H100's peaks (``launch/roofline.py``), the one-card dry
run (``launch/dryrun.py``), its report and the packing ablation.

Tolerances, and why:
  * shapes, cells, configs, input specs, ``model_flops`` and the trees'
    leaves: exact (the same numbers; the decode cell's ``index`` is the
    documented exception: ``int32 [B]`` where the reference's is a
    scalar).
  * ``tests/test_hlo_cost.py``'s programs: the counter sees every product
    as torch issues it, and the reference's ``analyze`` re-derives XLA's
    from HLO text; both are held to the programs' exact FLOPs within 1%
    (the reference's own test holds its gradient to 2%).
  * a reduced qwen3 train step: the counter counts the products torch
    issues (its remat recomputes each block's forward) and ``analyze`` the
    dots XLA kept after fusion and simplification; within 10% of each
    other, and both within [0.9, 2.5] x 6·N·D as the reference's test
    holds its own.
  * a reduced bitnet decode step's ``flops`` and ``bytes`` under every
    kernel policy, and on fake tensors against the real run: equal.

Models run at reduced configs (bitnet-b1.58-2b at 2 layers, d_model 128;
qwen3 at 4 layers and a 256-token vocab, as the reference's test), except
the tree-bytes test, which builds every assigned arch's parameter, packed,
optimizer-state and cache trees at full size on fake tensors (llama4 at
one dense/MoE group of its 24: depth is a stacked axis, and packing its
48 layers' 128 experts one at a time takes a minute on fake tensors).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.launch import roofline as jrl
from repro.launch.hlo_cost import analyze as hlo_analyze
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import ablate, dryrun, op_cost, report
from repro_torch.launch import roofline as trl
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch.models.config import reduced
from repro_torch.optim import optimizers as topt

CELLS = jreg.all_cells()


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


# ---------------------------------------------------------------------------
# shapes, cells, configs, specs, model FLOPs
# ---------------------------------------------------------------------------


def test_shapes_and_cells_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    assert treg.ASSIGNED == jreg.ASSIGNED
    for arch in jreg.ARCHS:
        assert tshapes.cells_for(arch) == jshapes.cells_for(arch)
    assert treg.all_cells() == CELLS
    assert len(CELLS) == 32


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (str(k),))
    else:
        yield "/".join(path), tree


def _jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), _dtype(leaf.dtype)) for path, leaf in flat}


def _torch_leaves(tree) -> dict:
    return {p: (tuple(t.shape), _dtype(t.dtype))
            for p, t in _leaves_with_paths(tree)}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_config_and_input_specs_equal_the_reference(arch, shape):
    jcfg, jshape, jspecs = jreg.input_specs(arch, shape)
    tcfg, tshape, tspecs = treg.input_specs(arch, shape)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.astuple(tshape) == dataclasses.astuple(jshape)
    assert treg.shape_adapted_config(treg.get_config(arch), tshape) == tcfg
    assert all(t.device.type == "meta" for _, t in _leaves_with_paths(tspecs))
    if tshape.kind != "decode":
        assert _torch_leaves(tspecs) == _jax_leaves(jspecs)
        return
    # the documented difference: per-slot positions [B], not a scalar
    B = tshape.global_batch
    assert jspecs["index"].shape == () and tuple(tspecs["index"].shape) == (B,)
    assert _dtype(tspecs["index"].dtype) == _dtype(jspecs["index"].dtype)
    jspecs, tspecs = dict(jspecs), dict(tspecs)
    del jspecs["index"], tspecs["index"]
    assert _torch_leaves(tspecs) == _jax_leaves(jspecs)


def test_model_flops_equal_the_reference_exactly():
    for arch, shape in CELLS:
        jcfg, jshape, _ = jreg.input_specs(arch, shape)
        tcfg, tshape, _ = treg.input_specs(arch, shape)
        assert trl.model_flops(tcfg, tshape, tshape.kind) == \
            jrl.model_flops(jcfg, jshape, jshape.kind), (arch, shape)
    bit = "bitnet-b1.58-2b"
    for kind in ("train", "prefill", "decode"):
        assert trl.model_flops(treg.get_config(bit),
                               tshapes.Shape("ablate", 4096, 128, kind),
                               kind) == \
            jrl.model_flops(jreg.get_config(bit),
                            jshapes.Shape("ablate", 4096, 128, kind), kind)


# ---------------------------------------------------------------------------
# the counter against hlo_cost on tests/test_hlo_cost.py's programs
# ---------------------------------------------------------------------------

FLOPS_ONE = 2 * 64 * 128 * 128
FLOPS_ALL = 10 * FLOPS_ONE


def _xw(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    w = (rng.normal(size=(10, 128, 128)) / 16).astype(np.float32)
    return x, w


def _t_unroll(x, w):
    for i in range(10):
        x = torch.tanh(x @ w[i])
    return x


def _t_nested(x, w):
    for group in w.reshape(5, 2, 128, 128):
        for wi in group:
            x = torch.tanh(x @ wi)
    return x


def _t_grad_remat(w, x):
    w = w.detach().requires_grad_()
    x = x.detach().requires_grad_()
    y = x
    for i in range(10):
        y = torch.utils.checkpoint.checkpoint(
            lambda c, wi: torch.tanh(c @ wi), y, w[i], use_reentrant=False)
    return torch.autograd.grad(torch.sum(y ** 2), (w, x))


def _j_unroll(x, w):
    for i in range(10):
        x = jnp.tanh(x @ w[i])
    return x


def _j_scan(x, w):
    return jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)[0]


def _j_nested(x, w):
    return jax.lax.scan(lambda c, wg: (_j_scan(c, wg), None), x,
                        w.reshape(5, 2, 128, 128))[0]


def _j_grad_remat(w, x):
    def loss(w, x):
        y, _ = jax.lax.scan(
            jax.checkpoint(lambda c, wi: (jnp.tanh(c @ wi), None)), x, w)
        return jnp.sum(y ** 2)
    return jax.grad(loss, argnums=(0, 1))(w, x)


@pytest.mark.parametrize("name,tfn,jfn,args,want", [
    ("unrolled", _t_unroll, _j_unroll, "xw", FLOPS_ALL),
    ("nested", _t_nested, _j_nested, "xw", FLOPS_ALL),
    ("grad_remat", _t_grad_remat, _j_grad_remat, "wx", 4 * FLOPS_ALL)])
def test_counter_counts_hlo_cost_programs(name, tfn, jfn, args, want):
    x, w = _xw()
    order = (x, w) if args == "xw" else (w, x)
    counted = op_cost.analyze(tfn, *map(torch.from_numpy, order))
    assert counted["flops"] == pytest.approx(want, rel=0.01)
    assert counted["collective_bytes"] == 0
    assert set(counted["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    text = jax.jit(jfn).lower(*map(jnp.asarray, order)).compile().as_text()
    assert hlo_analyze(text)["flops"] == pytest.approx(counted["flops"],
                                                       rel=0.01)


def test_counter_bytes_count_what_the_step_did_not_create_once():
    """Reads of the inputs once however often and however sliced; writes
    into an input once per region; returned tensors once."""
    x = torch.ones(8, 16)
    cache = torch.zeros(4, 8, 16)

    def step(x, cache):
        y = x[:, :8] * 2 + x[:, :8]         # the half read twice: once
        for i in range(4):
            cache[i, :2] = y[:2, :].repeat(1, 2)   # 2 x 16 f32 each
        cache[0, :2] = 0.0                  # the same region again
        return y.sum(0)

    r = op_cost.analyze(step, x, cache)
    assert r["bytes_read"] == 8 * 8 * 4
    assert r["bytes_written"] == 4 * 2 * 16 * 4
    assert r["bytes_returned"] == 8 * 4
    assert r["bytes"] == r["bytes_read"] + r["bytes_written"] + \
        r["bytes_returned"]


# ---------------------------------------------------------------------------
# a reduced qwen3 train step against hlo_cost on the compiled JAX step
# ---------------------------------------------------------------------------


def test_qwen3_train_step_count_against_hlo_cost():
    jcfg = jreg.get_smoke_config("qwen3-0.6b").with_(
        n_layers=4, vocab_size=256, loss_chunk=32)
    tcfg = treg.get_smoke_config("qwen3-0.6b").with_(
        n_layers=4, vocab_size=256, loss_chunk=32)
    B, S = 4, 64
    params = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "loss_mask": jax.ShapeDtypeStruct((B, S), jnp.float32)}
    g = jax.jit(jax.grad(lambda p, b: jmodel.train_loss(p, jcfg, b)[0]))
    ref = hlo_analyze(g.lower(params, batch).compile().as_text())
    hlo = ref["flops"]

    from repro_torch.launch.train import make_train_step

    with dryrun.fake_mode():
        p = tmodel.init_params(tcfg, torch.Generator(), "cpu")
        opt = topt.make_optimizer(tcfg.optimizer)
        state = opt.init(p)
        specs = treg.train_input_specs(tcfg, tshapes.Shape("t", S, B,
                                                           "train"), "cpu")
        count = op_cost.analyze(make_train_step(tcfg, opt), p, state, {},
                                specs, 0)
    counted = count["flops"]
    analytic = 6 * tcfg.param_count() * B * S
    # the gap PERF.md quotes (``pytest -s`` shows it)
    print(f"qwen3 train step: FLOPs counted {counted:.6g}, hlo_cost "
          f"{hlo:.6g}, 6ND {analytic:.6g}; bytes_materialized "
          f"{count['bytes_materialized']:.6g}, hlo_cost bytes "
          f"{ref['bytes']:.6g}, roofline bytes {count['bytes']:.6g}")
    assert 0.9 * analytic < counted < 2.5 * analytic
    assert 0.9 * analytic < hlo < 2.5 * analytic
    assert counted == pytest.approx(hlo, rel=0.10), (counted, hlo)


# ---------------------------------------------------------------------------
# a reduced bitnet decode step: every policy counts the same
# ---------------------------------------------------------------------------

_BIT = treg.get_smoke_config("bitnet-b1.58-2b", n_layers=2)


@functools.lru_cache(maxsize=None)
def _served():
    return tdecode.init_serving_params(
        _BIT, torch.Generator().manual_seed(0), "cpu")


def _decode_count(cfg, bound: bool = True) -> dict:
    p = _served()
    if bound:
        p = tdecode.bind_serving_weights(p, cfg)
    cache = tdecode.init_cache(cfg, 2, 64, device="cpu")
    tokens = torch.tensor([5, 7], dtype=torch.int32)
    index = torch.tensor([3, 9], dtype=torch.int32)
    return op_cost.analyze(tdecode.decode_step, p, cfg, cache, tokens, index)


@pytest.mark.parametrize("act,policy", [
    ("none", p) for p in ("fixed:lut_gather", "fixed:lut_onehot",
                          "fixed:tl2", "fixed:tl2_ref",
                          "fixed:dequant_packed", "fixed:signflip", "prior",
                          "auto")] + [
    ("int8", p) for p in ("fixed:w2a8", "fixed:tl2", "prior")])
def test_decode_step_counts_the_same_under_every_policy(act, policy,
                                                        tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    from repro_torch.kernels import dispatch

    dispatch.reset_autotune_cache()
    ref = _decode_count(_BIT.with_(act_dtype=act, matmul_policy="fixed:ref"))
    got = _decode_count(_BIT.with_(act_dtype=act, matmul_policy=policy))
    dispatch.reset_autotune_cache()
    assert got["flops"] == ref["flops"] > 0
    assert got["bytes"] == ref["bytes"] > 0
    assert got["bytes_materialized"] == ref["bytes_materialized"]
    want = {p.name for p in dispatch.REGISTRY.values()} if policy in (
        "prior", "auto") else {policy.removeprefix("fixed:")}
    assert {m["kernel"] for m in got["ternary_matmuls"]} <= want
    # each projection counted once, as 2·M·K·N
    calls = sum(m["calls"] for m in got["ternary_matmuls"])
    assert calls == 7 * _BIT.n_layers
    assert sum(m["flops"] for m in got["ternary_matmuls"]) == sum(
        2 * m["M"] * m["K"] * m["N"] * m["calls"]
        for m in got["ternary_matmuls"])


def test_decode_step_on_fake_tensors_counts_what_the_real_run_counts():
    """The dry run's form (fake tensors, the ring write's boolean index an
    unbacked size) against the real step on the CPU, unbound weights."""
    cfg = _BIT.with_(matmul_policy="prior")
    real = _decode_count(cfg, bound=False)
    with dryrun.fake_mode():
        p = tdecode.init_serving_params(cfg, torch.Generator(), "cpu")
        cache = tdecode.init_cache(cfg, 2, 64, device="cpu")
        tokens = torch.empty(2, dtype=torch.int32)
        index = torch.empty(2, dtype=torch.int32)
        fake = op_cost.analyze(tdecode.decode_step, p, cfg, cache, tokens,
                               index)
    for key in ("flops", "bytes", "bytes_read", "bytes_written",
                "bytes_returned", "bytes_materialized"):
        assert fake[key] == real[key], key
    # a fresh card's selection: the prior on cuda
    assert {m["kernel"] for m in fake["ternary_matmuls"]} == {"tl2"}


def test_fake_tensors_reach_dispatch_only_inside_a_count():
    from repro_torch.kernels.dispatch import TernaryWeight, ternary_matmul

    with dryrun.fake_mode():
        x = torch.empty(2, 10)
        w = TernaryWeight.from_packed(torch.empty(4, 128, dtype=torch.uint8),
                                      1.0, 10)
        with pytest.raises(ValueError, match="fake or meta"):
            ternary_matmul(x, w)
    x = torch.empty(2, 10, device="meta")
    w = TernaryWeight.from_packed(
        torch.empty(4, 128, dtype=torch.uint8, device="meta"), 1.0, 10)
    with pytest.raises(ValueError, match="fake or meta"):
        ternary_matmul(x, w)
    counter = op_cost.OpCounter()
    with counter:
        y = ternary_matmul(x, w)
    assert y.shape == (2, 4) and y.device.type == "meta"
    assert counter.flops == 2 * 2 * 10 * 4


# ---------------------------------------------------------------------------
# the trees at full size, leaf for leaf
# ---------------------------------------------------------------------------


def _depth(arch):
    cfg = treg.get_config(arch)
    return cfg.with_(n_layers=2) if arch.startswith("llama4") else cfg


@pytest.mark.parametrize("arch", jreg.ASSIGNED)
def test_trees_at_full_size_equal_the_references_leaf_for_leaf(arch):
    tcfg = _depth(arch)
    jcfg = jreg.get_config(arch).with_(n_layers=tcfg.n_layers)
    key = jax.random.PRNGKey(0)
    jparams = jax.eval_shape(functools.partial(jmodel.init_params, jcfg), key)
    jpacked = jax.eval_shape(
        functools.partial(jdecode.quantize_for_serving, cfg=jcfg), jparams)
    jstate = jax.eval_shape(jopt.make_optimizer(jcfg.optimizer).init, jparams)
    shape = tshapes.SHAPES[tshapes.cells_for(arch)[-1]]
    jc = jreg.shape_adapted_config(jcfg, shape)
    jcache = jax.eval_shape(lambda: jdecode.init_cache(
        jc, shape.global_batch, shape.seq_len))
    with dryrun.fake_mode():
        params = tmodel.init_params(tcfg, torch.Generator(), "cpu")
        state = topt.make_optimizer(tcfg.optimizer).init(params)
        packed = tdecode.quantize_for_serving(params, tcfg)
        cache = tdecode.init_cache(treg.shape_adapted_config(tcfg, shape),
                                   shape.global_batch, shape.seq_len,
                                   device="cpu")
        for name, t, j in (("params", params, jparams),
                           ("packed", packed, jpacked),
                           ("state", state, jstate),
                           ("cache", cache, jcache)):
            tl, jl = _torch_leaves(t), _jax_leaves(j)
            extra = sorted(set(tl) - set(jl))
            # the port keeps no operand the reference lacks
            assert extra == [], (name, extra)
            assert tl == jl, name
            assert dryrun.tree_bytes(t) == sum(
                int(np.prod(s)) * np.dtype(jnp.dtype(d)).itemsize
                for s, d in jl.values()), name


# ---------------------------------------------------------------------------
# the dry run, its report, the ablation
# ---------------------------------------------------------------------------


def test_dry_run_records_a_cell_and_resumes(tmp_path, monkeypatch):
    """One reduced cell through ``run`` (the registry patched to reduced
    configs): the record's keys, and a second run skips the cell."""
    full = treg.get_config
    monkeypatch.setattr(treg, "get_config",
                        lambda name: reduced(full(name), n_layers=2))
    monkeypatch.setattr(dryrun, "all_cells",
                        lambda: [("qwen3-0.6b", "decode_32k")])
    monkeypatch.setattr(treg, "SHAPES", dict(
        treg.SHAPES, decode_32k=tshapes.Shape("decode_32k", 64, 2,
                                              "decode")))
    assert dryrun.run(out_dir=str(tmp_path), device="cpu") == []
    rec = report.load(str(tmp_path))[0]
    assert rec["ok"] and rec["mesh"] == "1" and rec["chips"] == 1
    for key in ("param_bytes_per_device", "packed_bytes_per_device",
                "cache_bytes_per_device", "roofline", "collectives",
                "model_flops", "model_flops_ratio", "trace_s", "fits"):
        assert key in rec
    assert rec["fits"] and rec["collectives"]["total"] == 0
    assert rec["roofline"]["bottleneck"] == "memory"
    mtime = (tmp_path / "qwen3-0.6b__decode_32k__1.json").stat().st_mtime_ns
    dryrun.run(out_dir=str(tmp_path), device="cpu")
    assert (tmp_path / "qwen3-0.6b__decode_32k__1.json").stat() \
        .st_mtime_ns == mtime


def _record(arch, shape, kind, flops, nbytes, **extra):
    roof = trl.Roofline(1, flops, nbytes, 0.0)
    return {"arch": arch, "shape": shape, "mesh": "1", "chips": 1,
            "kind": kind, "ok": True, "roofline": roof.as_dict(),
            "model_flops_ratio": 0.5, "param_bytes_per_device": 2e9,
            "fits": True, "trace_s": 3.0, "count": {"ops": 1234}, **extra}


def test_report_renders_from_two_records():
    recs = [_record("qwen3-0.6b", "decode_32k", "decode", 1e12, 3.35e10,
                    packed_bytes_per_device=4e8, cache_bytes_per_device=5e9),
            _record("qwen3-0.6b", "train_4k", "train", 9.89e15, 1e9,
                    state_bytes_per_device=4.8e9),
            {"arch": "xlstm-125m", "shape": "prefill_32k", "mesh": "1",
             "ok": False, "error": "RuntimeError: boom"}]
    table = report.roofline_table(recs).splitlines()
    assert len(table) == 4
    assert "| qwen3-0.6b | decode_32k | 1.01 | 10.00 | 0.00 | memory |" \
        in table[2]
    assert "| compute |" in table[3] and "| 10,000 |" in table[3]
    mem = report.dryrun_table(recs).splitlines()
    assert len(mem) == 4
    assert "| 2.00 | 0.40 | — | 5.00 | yes | 1,234 | 3 |" in mem[2]
    s = report.summary(recs)
    assert s.startswith("2/3 cells traced on one card")
    assert "xlstm-125m × prefill_32k: RuntimeError: boom" in s


def test_ablation_on_the_cpu_at_smoke_size():
    """Both trees of a reduced bitnet: the packed tree and its memory term
    are the smaller, the logits agree within 2^-3."""
    cfg = treg.get_smoke_config("bitnet-b1.58-2b", n_layers=2)
    r = ablate.run(cfg, 2, 32, torch.device("cpu"), steps=1, warmup=1)
    b, p = r["bf16"], r["packed"]
    assert p["weight_gb"] < b["weight_gb"]
    assert p["ternary_weight_gb"] * 2 < b["ternary_weight_gb"]
    assert p["memory_term_ms"] < b["memory_term_ms"]
    assert p["roofline_flops"] == b["roofline_flops"]
    assert r["logits_held"] and r["logits_max_abs_diff"] <= 2.0 ** -3
    assert b["busy_ms"] is None and "not measured" in ablate.report(r)
