"""The port's MoE slice against the JAX package: the grouped kernels, the
grouped half of dispatch, ``moe_ffn``, per-expert packing, the
layer-by-layer serving build, and phi3.5-moe serving.

Both packages run the same packed serving artifact (the JAX
``quantize_for_serving`` tree, converted) at the reduced phi3.5-moe-42b-a6.6b
(4 layers, d_model 128, 8 experts, top-2, d_ff 256); inputs come from
numpy seeds.  At batch 2 the decode capacity is ``max(int(1.25·2·2/8), 1) =
1``, so the four token-expert assignments of a step compete for single-row
expert buffers and drops happen; dead rows route and take capacity too.

Tolerances, and why:
  * grouped kernels, float inputs: both sides accumulate in f32 in
    different orders, atol = 1e-5 · max_row Σ_k |x| (as the dense kernels);
    ``grouped_w2a8`` is held exactly against the int64 numpy product.
  * ``moe_ffn`` and the engine against JAX run op by op: bitwise equal
    (atol 0).  The port follows the reference op for op (f32 router
    softmax, ties to the lower expert, stable sort, bf16 scatter-add), so
    every routing choice and every rounding is the same.
  * the engine against the compiled JAX engine: XLA keeps f32 between
    fused elementwise ops where the op-by-op form rounds to bf16 (a few
    bf16 ulps, 2^-4 on the dense model), and in an MoE a few ulps can move
    a near-tied router choice, sending one token of one layer to another
    expert: the compiled JAX engine itself differs from its op-by-op run by
    up to 0.52 in the logits here (measured, bf16 and int8).  So against
    it the logits are held to ``TOL_COMPILED`` = 1.0 and the streams
    step for step until a step whose JAX top-2 margin is below that; the
    op-by-op comparison above is the exact oracle.
  * int8 among the port's own kernels: every product is an exact integer
    sum, so ``fixed:w2a8`` logits are bitwise equal to ``fixed:ref``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import encoding as jenc
from repro.kernels import dispatch as jdispatch
from repro.kernels.grouped_matmul import \
    grouped_packed_matmul as j_grouped_packed_matmul
from repro.kernels.tl2_matmul import pack_tl2 as j_pack_tl2
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro_torch.configs.registry import get_config as t_config
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import grouped_matmul as tgm
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
from repro_torch.serving import engine as tengine

ARCH = "phi3.5-moe-42b-a6.6b"
TOL_COMPILED = 1.0
PROMPT_LENS = [3, 11, 17, 6]
NEW_TOKENS = 6
CHUNK = 8
MAX_LEN = 48


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced model's tensors are tiny: one intra-op thread is faster
    than a pool, and a pool per test worker oversubscribes the host's cores
    when the suite runs its files in parallel (the port's engine steps then
    wait on spinning threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _atol(x) -> float:
    return 1e-5 * float(np.abs(np.asarray(x, np.float64)).sum(-1).max()) + 1e-6


def _served_packed(w: np.ndarray) -> np.ndarray:
    """Stacked base-3 bytes with the serving artifact's 128-byte row
    padding (byte 0, five -1 trits each, past the logical K)."""
    packed = np.asarray(jenc.pack_base3(jnp.asarray(w)))
    return np.pad(packed, ((0, 0), (0, 0), (0, (-packed.shape[-1]) % 128)))


def _grouped_case(seed, E, C, K, N, int8=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-127, 128, size=(E, C, K)).astype(np.int8) if int8
         else rng.normal(size=(E, C, K)).astype(np.float32))
    w = rng.integers(-1, 2, size=(E, N, K)).astype(np.int8)
    return x, w


# (E, C, K, N): decode capacity 1, ragged K (not a multiple of 5 or 10),
# every row tile the kernels are built for (C = 1, 2, 5, 9), N past 128;
# more of the admission chunk's C = 5 and past one 8-row tile (C = 9)
GROUPED = [(3, 1, 50, 37), (2, 5, 301, 130), (4, 2, 64, 20), (2, 9, 133, 7),
           (4, 5, 97, 70), (3, 9, 286, 40)]


@pytest.mark.parametrize("E,C,K,N", GROUPED)
def test_plain_grouped_dequant_matches_pallas(E, C, K, N):
    x, w = _grouped_case(1, E, C, K, N)
    packed = _served_packed(w)
    want = j_grouped_packed_matmul(jnp.asarray(x), jnp.asarray(packed), K,
                                   interpret=True)
    got = tgm.grouped_packed_matmul(torch.from_numpy(x),
                                    torch.from_numpy(packed), K)
    assert got.dtype == torch.float32 and got.shape == (E, C, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_atol(x))


@pytest.mark.parametrize("E,C,K,N", GROUPED)
def test_plain_grouped_w2a8_exact_against_int64_product(E, C, K, N):
    x, w = _grouped_case(2, E, C, K, N, int8=True)
    got = tgm.grouped_w2a8_matmul(torch.from_numpy(x),
                                  torch.from_numpy(_served_packed(w)), K)
    assert got.dtype == torch.int32 and got.shape == (E, C, N)
    want = np.einsum("eck,enk->ecn", x.astype(np.int64), w.astype(np.int64))
    assert np.array_equal(got.numpy().astype(np.int64), want)


def test_grouped_kernels_refuse_what_they_do_not_take():
    x, w = _grouped_case(3, 2, 1, 30, 8)
    packed = torch.from_numpy(_served_packed(w))
    with pytest.raises(ValueError, match="int8"):
        tgm.grouped_w2a8_matmul(torch.from_numpy(x), packed, 30)
    with pytest.raises(ValueError, match="expert dims"):
        tgm.grouped_packed_matmul(torch.from_numpy(x[:1]), packed, 30)
    meta = torch.empty((2, 1, 30), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgm.grouped_packed_matmul(meta, packed.to("meta"), 30)


def test_grouped_weight_round_trips():
    _, w = _grouped_case(4, 3, 1, 47, 24)
    gw = tdispatch.GroupedTernaryWeight.from_ternary(torch.from_numpy(w), 0.5)
    assert (gw.n_experts, gw.out_features, gw.in_features) == (3, 24, 47)
    assert np.array_equal(gw.packed().numpy(),
                          np.asarray(jenc.pack_base3(jnp.asarray(w))))
    served = tdispatch.GroupedTernaryWeight.from_packed(
        torch.from_numpy(_served_packed(w)), torch.ones(3), 47)
    assert np.array_equal(served.trits().numpy(), w)
    # the dense stack is decoded anew each time, never kept
    assert served.trits() is not served.trits()
    assert served.tl2() is served.tl2()
    assert np.array_equal(served.tl2().numpy().view(np.uint16),
                          np.asarray(j_pack_tl2(jnp.asarray(w))))
    with pytest.raises(ValueError, match="stacked"):
        tdispatch.GroupedTernaryWeight.from_packed(
            gw.packed()[0], 1.0, 47)


@pytest.mark.parametrize("act", ["bfloat16", "int8"])
def test_grouped_and_dense_kernels_never_eligible_for_each_other(act):
    dense = {s.name for s in tdispatch.eligible_kernels(4, 64, 32, act)}
    grouped = {s.name for s in tdispatch.eligible_kernels(4, 64, 32, act,
                                                          e=8)}
    assert dense and grouped and not dense & grouped
    assert all(tdispatch.REGISTRY[n].grouped for n in grouped)
    assert dense == {s.name for s in jdispatch.eligible_kernels(
        4, 64, 32, act)}
    assert grouped == {s.name for s in jdispatch.eligible_kernels(
        4, 64, 32, act, e=8)}


@pytest.mark.parametrize("name", list(jdispatch.REGISTRY))
def test_fixed_pins_map_to_grouped_variants_as_jax_does(name):
    """A dense pin maps to its grouped counterpart on an MoE problem; the
    LUT and sign-flip pins, which have none, raise as the reference's do."""
    act = "int8" if "w2a8" in name else "bfloat16"
    policy = f"fixed:{name}"
    try:
        want = jdispatch.select_kernel(1, 64, 32, act, policy=policy,
                                       backend="tpu", e=8).name
    except ValueError as exc:
        with pytest.raises(ValueError, match="no grouped" if "variant" in
                           str(exc) else "does not support"):
            tdispatch.select_kernel(1, 64, 32, act, policy=policy, e=8)
        return
    assert tdispatch.select_kernel(1, 64, 32, act, policy=policy,
                                   e=8).name == want


def _phi_problems():
    """Every dense and grouped problem of full-width phi3.5-moe at decode
    (batch 1, 2, 4) and at the 32-token admission chunk."""
    cfg = j_config(ARCH)
    dense, grouped = set(), set()
    for bs, sl in ((1, 1), (2, 1), (4, 1), (1, 32)):
        dense |= set(jdecode.layer_matmul_shapes(cfg, bs, sl))
        grouped |= set(jdecode.layer_grouped_matmul_shapes(cfg, bs, sl))
    return sorted(dense), sorted(grouped)


@pytest.mark.parametrize("act", ["bfloat16", "float32", "int8"])
def test_prior_on_cuda_matches_jax_prior_on_tpu_at_phi_full_width(act):
    dense, grouped = _phi_problems()
    assert {(e, c) for e, c, _, _ in grouped} == {(16, 1), (16, 5)}
    for m, k, n in dense:
        want = jdispatch.select_kernel(m, k, n, act, policy="prior",
                                       backend="tpu").name
        assert tdispatch.select_kernel(m, k, n, act, policy="prior",
                                       device="cuda").name == want
    for e, c, k, n in grouped:
        want = jdispatch.select_kernel(c, k, n, act, policy="prior",
                                       backend="tpu", e=e).name
        got = tdispatch.select_kernel(c, k, n, act, policy="prior",
                                      device="cuda", e=e).name
        assert got == want == "grouped_dequant", (e, c, k, n, act)


def test_grouped_cache_keys_equal_jax():
    for e in (None, 16):
        for m, k, n in ((1, 4096, 6400), (5, 6400, 4096)):
            assert tdispatch.AutotuneCache.key(m, k, n, "bfloat16", "cuda",
                                               e=e) == \
                jdispatch.AutotuneCache.key(m, k, n, "bfloat16", "cuda", e=e)
    cache = tdispatch.AutotuneCache(path="unused.json")
    cache.record(1, 64, 32, "bfloat16", "cpu", "grouped_tl2", 1.0, e=8)
    cache.record(1, 64, 32, "bfloat16", "cpu", "grouped_ref", 2.0, e=8)
    assert cache.best(1, 64, 32, "bfloat16", "cpu", e=8) == "grouped_tl2"
    assert cache.best(1, 64, 32, "bfloat16", "cpu") is None
    assert tdispatch.select_kernel(1, 64, 32, "bfloat16", device="cpu",
                                   cache=cache, e=8).name == "grouped_tl2"


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trees():
    jcfg = j_smoke(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    return jp, jdecode.quantize_for_serving(jp, jcfg)


def _layer0_moe(tree):
    return jax.tree.map(lambda a: np.asarray(a[0]), tree["blocks"]["moe"])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("act_dtype", ["none", "int8"])
def test_moe_ffn_matches_jax_op_by_op(jax_trees, act_dtype, capacity_factor):
    """Layer 0's MoE on a [3, 5] batch whose row 4 is all zeros: its router
    logits tie across all experts (ties go to the lowest indices), and at
    capacity factor 0.25 (capacity 1) most assignments drop."""
    kw = dict(act_dtype=act_dtype, capacity_factor=capacity_factor)
    jcfg, tcfg = j_smoke(ARCH).with_(**kw), t_smoke(ARCH).with_(**kw)
    x = np.random.default_rng(5).normal(size=(3, 5, 128)).astype(np.float32)
    x[0, 4] = 0.0
    moe = _layer0_moe(jax_trees[1])
    jy, jaux = jlayers.moe_ffn(jax.tree.map(jnp.asarray, moe),
                               jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, taux = tlayers.moe_ffn(from_numpy_tree(moe, "cpu"),
                               torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert ty.dtype == torch.bfloat16 and ty.shape == (3, 5, 128)
    assert np.array_equal(ty.float().numpy(),
                          np.asarray(jy.astype(jnp.float32)))
    assert float(taux) == float(jaux)
    cap = tlayers.moe_capacity(tcfg, 15)
    assert cap == jlayers.moe_capacity(jcfg, 15)
    if capacity_factor < 1:
        assert cap == 1 and 15 * 2 > 8 * cap       # drops are certain


def test_moe_ffn_with_shared_expert_matches_jax_op_by_op():
    """The shared-expert branch (no served config sets it yet): one layer's
    MoE with ``moe_shared_expert``, packed by the reference, bitwise."""
    jcfg = j_smoke(ARCH).with_(moe_shared_expert=True)
    tcfg = t_smoke(ARCH).with_(moe_shared_expert=True)
    packed = jdecode.quantize_for_serving(
        {"moe": jlayers.init_moe(jax.random.PRNGKey(4), jcfg)}, jcfg)["moe"]
    assert "shared" in packed and packed["shared"]["wi"]["scale"].ndim == 0
    x = np.random.default_rng(6).normal(size=(2, 3, 128)).astype(np.float32)
    jy, _ = jlayers.moe_ffn(packed, jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, _ = tlayers.moe_ffn(
        from_numpy_tree(jax.tree.map(np.asarray, packed), "cpu"),
        torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert np.array_equal(ty.float().numpy(),
                          np.asarray(jy.astype(jnp.float32)))


def test_quantize_for_serving_per_expert_matches_jax_bytes(jax_trees):
    jp, js = jax_trees
    tcfg = t_smoke(ARCH)
    tq = tdecode.quantize_for_serving(
        from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu"), tcfg)
    got = to_numpy_tree(tq)
    want = jax.tree.map(np.asarray, js)
    assert got["blocks"]["moe"]["wi"]["scale"].shape == (4, 8)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = flat_got[path]
        if leaf.dtype.name == "bfloat16":
            leaf = leaf.view(np.uint16)
        assert g.dtype == leaf.dtype and np.array_equal(g, leaf), path


@pytest.mark.parametrize("arch", [ARCH, "bitnet-b1.58-2b"])
def test_layer_by_layer_build_equals_whole_tree_build(arch):
    cfg = t_smoke(arch)
    whole = tdecode.quantize_for_serving(
        tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu"), cfg)
    layered = tdecode.init_serving_params(
        cfg, torch.Generator().manual_seed(3), "cpu")
    a, b = to_numpy_tree(whole), to_numpy_tree(layered)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_interleaved_moe_is_refused_naming_the_slice_that_brings_it():
    jcfg = j_smoke("llama4-maverick-400b-a17b")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    assert tcfg.moe_every > 1
    with pytest.raises(NotImplementedError, match="dense_blocks"):
        tmodel.init_params(tcfg, torch.Generator(), "cpu")


@pytest.mark.parametrize("cfg_of", [j_config, j_smoke])
def test_layer_grouped_problems_match_jax(cfg_of):
    jcfg = cfg_of(ARCH)
    tcfg = (t_config if cfg_of is j_config else t_smoke)(ARCH)
    for bs, sl in ((1, 1), (2, 1), (4, 1), (1, 8), (1, 32), (3, 7)):
        assert tdecode.layer_grouped_matmul_problems(tcfg, bs, sl) == \
            jdecode.layer_grouped_matmul_problems(jcfg, bs, sl)
        assert tdecode.layer_grouped_matmul_shapes(tcfg, bs, sl) == \
            jdecode.layer_grouped_matmul_shapes(jcfg, bs, sl)
        assert tdecode.layer_matmul_problems(tcfg, bs, sl) == \
            jdecode.layer_matmul_problems(jcfg, bs, sl)
    assert tdecode.layer_grouped_matmul_problems(
        t_smoke("bitnet-b1.58-2b"), 2) == []


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(2, 512, size=n).tolist() for n in PROMPT_LENS]


def _record(eng) -> list:
    """Log ``(logits, live)`` of the state each scheduler step samples from
    (the decode logits of live rows, and the prefill logits of rows just
    admitted)."""
    log = []
    step = eng.sched_step

    def recorded(state):
        log.append((np.array(state["logits"], np.float32),
                    np.array(state["live"])))
        return step(state)

    eng.sched_step = recorded
    return log


def _jax_serve(js, jcfg, *, op_by_op: bool):
    ctx = jax.disable_jit() if op_by_op else contextlib.nullcontext()
    with ctx:
        eng = jengine.DecodeEngine(
            js, jcfg, batch_size=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
            sampler=jengine.SamplerConfig(canonical_greedy=True))
        log = _record(eng)
        reqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
                for p in _prompts()]
        eng.serve(reqs)
    return [r.out for r in reqs], log


def _port_engine(js, tcfg, policy):
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    eng = tengine.DecodeEngine(
        ts, tcfg, batch_size=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
        matmul_policy="auto" if policy == "autotuned" else policy,
        device="cpu", sampler=tengine.SamplerConfig(canonical_greedy=True))
    if policy == "autotuned":
        eng.autotune_shapes(reps=1)
        assert any(k.startswith("E8:")
                   for k in tdispatch.get_autotune_cache().entries)
    return eng


def _port_serve(eng):
    log = _record(eng)
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in _prompts()]
    eng.serve(reqs)
    assert all(r.done and len(r.out) == NEW_TOKENS for r in reqs)
    return [r.out for r in reqs], log


def _greedy(logits: np.ndarray) -> np.ndarray:
    r = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    return np.argmax(r, axis=-1)


def _top2_margin(logits: np.ndarray) -> np.ndarray:
    r = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    top = np.sort(r, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _assert_served_match(port, ref, tol: float):
    """Step by step, the live rows' logits within ``tol`` and the same
    greedy tokens, until a step where a token differs: there the
    reference's top-2 margin must be below ``tol``, and the schedules part.
    With ``tol = 0`` everything must be equal."""
    (pstreams, plog), (rstreams, rlog) = port, ref
    if tol == 0:
        assert pstreams == rstreams and len(plog) == len(rlog)
    for (pl, plive), (rl, rlive) in zip(plog, rlog):
        assert np.array_equal(plive, rlive)
        if not rlive.any():
            continue
        assert np.abs(pl[rlive] - rl[rlive]).max() <= tol
        differ = (_greedy(pl) != _greedy(rl)) & rlive
        if differ.any():
            assert (_top2_margin(rl)[differ] < tol).all()
            return
    assert pstreams == rstreams


def _forced_compiled(jcfg):
    """Teacher-forced JAX logits through one compiled chunk and one compiled
    step (batch 1): before each emitted token of ``stream``."""
    chunk = jax.jit(lambda p, c, t, pos, take: jdecode.prefill_chunk(
        p, jcfg, c, t, pos, take))
    step = jax.jit(lambda p, c, t, i: jdecode.decode_step(p, jcfg, c, t, i))

    def forced(js, prompt, stream):
        cache = jdecode.init_cache(jcfg, 1, MAX_LEN)
        for toks, pos, take in _chunks(prompt):
            cache, logits = chunk(js, cache, jnp.asarray(toks),
                                  jnp.asarray(pos), jnp.asarray(take, jnp.int32))
        out = [np.asarray(logits[0])]
        for i, tok in enumerate(stream[:-1]):
            logits, cache = step(js, cache, jnp.asarray([tok], jnp.int32),
                                 jnp.asarray([len(prompt) + i], jnp.int32))
            out.append(np.asarray(logits[0]))
        return np.stack(out)

    return forced


def _chunks(prompt):
    for start, valid in tdecode.prefill_chunks_of(len(prompt), CHUNK):
        toks = np.ones((1, CHUNK), np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        pos = np.full((1, CHUNK), -1, np.int32)
        pos[0, :valid] = np.arange(start, start + valid)
        yield toks, pos, valid - 1


def _port_forced(eng, prompt, stream) -> np.ndarray:
    cache = tdecode.init_cache(eng.cfg, 1, MAX_LEN, device="cpu")
    for toks, pos, take in _chunks(prompt):
        cache, logits = tdecode.prefill_chunk(eng.params, eng.cfg, cache,
                                              torch.from_numpy(toks).long(),
                                              torch.from_numpy(pos), take)
    out = [logits[0].numpy()]
    for i, tok in enumerate(stream[:-1]):
        logits, cache = tdecode.decode_step(
            eng.params, eng.cfg, cache, torch.tensor([tok]),
            torch.tensor([len(prompt) + i], dtype=torch.int32))
        out.append(logits[0].numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_op_by_op(jax_trees):
    return _jax_serve(jax_trees[1], j_smoke(ARCH), op_by_op=True)


def _compiled(js, jcfg):
    streams, log = _jax_serve(js, jcfg, op_by_op=False)
    run = _forced_compiled(jcfg)
    forced = [run(js, p, s) for p, s in zip(_prompts(), streams)]
    return (streams, log), forced


@pytest.fixture(scope="module")
def jax_compiled(jax_trees):
    return _compiled(jax_trees[1], j_smoke(ARCH))


@pytest.fixture(scope="module")
def jax_compiled_int8(jax_trees):
    return _compiled(jax_trees[1], j_smoke(ARCH).with_(act_dtype="int8"))


POLICIES = ["auto", "fixed:ref", "fixed:dequant_packed", "autotuned"]


@pytest.mark.parametrize("policy", POLICIES)
def test_port_engine_matches_jax_engine_op_by_op(jax_trees, jax_op_by_op,
                                                 policy):
    """Bitwise: the same streams and the same logits at every step."""
    eng = _port_engine(jax_trees[1], t_smoke(ARCH), policy)
    served = _port_serve(eng)
    chosen = {tdispatch.select_kernel(*shape[-3:], "bfloat16", device="cpu",
                                      policy=eng.cfg.matmul_policy,
                                      e=shape[0] if len(shape) == 4 else None
                                      ).name
              for shape in eng.matmul_shape_universe()}
    # on the CPU these four run the same f32 matmul over the same decoded
    # trits as the reference; a kernel whose plain version sums in another
    # order (the LUT, TL2 and sign-flip products), which a CPU autotune may
    # pick, is held to the compiled tolerance instead
    exact = chosen <= {"ref", "dequant_packed", "grouped_ref",
                       "grouped_dequant"}
    assert exact or policy == "autotuned"
    _assert_served_match(served, jax_op_by_op, 0.0 if exact else TOL_COMPILED)


@pytest.mark.parametrize("policy", POLICIES)
def test_port_engine_matches_compiled_jax_engine(jax_trees, jax_compiled,
                                                 policy):
    served_ref, forced = jax_compiled
    eng = _port_engine(jax_trees[1], t_smoke(ARCH), policy)
    _assert_served_match(_port_serve(eng), served_ref, TOL_COMPILED)
    for prompt, stream, jl in zip(_prompts(), served_ref[0], forced):
        assert np.abs(_port_forced(eng, prompt, stream) - jl).max() \
            <= TOL_COMPILED


@pytest.mark.parametrize("policy", ["auto", "fixed:w2a8", "autotuned"])
def test_port_int8_engine_matches_jax_int8_engine(jax_trees,
                                                  jax_compiled_int8, policy):
    """W1.58A8 MoE serving against the compiled JAX engine, and every
    kernel's logits bitwise equal to the port's int8 ``fixed:ref``."""
    served_ref, forced = jax_compiled_int8
    tcfg = t_smoke(ARCH).with_(act_dtype="int8")
    eng = _port_engine(jax_trees[1], tcfg, policy)
    _assert_served_match(_port_serve(eng), served_ref, TOL_COMPILED)
    ref = _port_engine(jax_trees[1], tcfg, "fixed:ref")
    for prompt, stream, jl in zip(_prompts(), served_ref[0], forced):
        got = _port_forced(eng, prompt, stream)
        assert np.abs(got - jl).max() <= TOL_COMPILED
        assert np.array_equal(got, _port_forced(ref, prompt, stream))


@pytest.mark.parametrize("batch_size,chunk", [(2, CHUNK), (4, 32)])
def test_engine_shape_universe_matches_jax(jax_trees, batch_size, chunk):
    js = jax_trees[1]
    jeng = jengine.DecodeEngine(js, j_smoke(ARCH), batch_size=batch_size,
                                max_len=MAX_LEN, prefill_chunk=chunk)
    teng = tengine.DecodeEngine(
        from_numpy_tree(jax.tree.map(np.asarray, js), "cpu"), t_smoke(ARCH),
        batch_size=batch_size, max_len=MAX_LEN, prefill_chunk=chunk,
        device="cpu")
    universe = teng.matmul_shape_universe()
    # the port drops the dense d_ff problems the reference lists for an MoE
    # config: every FFN here is the MoE, whose matmuls are the grouped ones
    cfg = t_smoke(ARCH)
    d, f = cfg.d_model, cfg.d_ff
    assert f not in (cfg.q_dim, cfg.kv_dim)
    ffn_only = {(m, k, n) for m in (batch_size, chunk)
                for k, n in ((d, f), (f, d))}
    jax_universe = jeng.matmul_shape_universe()
    assert ffn_only <= set(jax_universe)
    assert universe == [s for s in jax_universe if s not in ffn_only]
    assert any(len(s) == 4 for s in universe)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "bitnet-b1.58-2b"])
@pytest.mark.parametrize("batch_size,seq_len", [(1, 1), (4, 1), (1, 32)])
def test_serving_problems_drop_only_moe_dense_ffn(arch, batch_size, seq_len):
    """At full width: on phi3.5-moe the engine's dense problems are the
    reference's without the d_ff ones (no dense d_ff problem is left); on
    the dense bitnet they are the reference's, every one."""
    tcfg, jcfg = t_config(arch), j_config(arch)
    got = tengine.serving_matmul_problems(tcfg, batch_size, seq_len)
    want = jdecode.layer_matmul_problems(jcfg, batch_size, seq_len)
    M, d, f = batch_size * seq_len, tcfg.d_model, tcfg.d_ff
    if tcfg.n_experts:
        assert not {(M, d, f), (M, f, d)} & {p[1:] for p in got}
        want = [p for p in want if p[1:] not in ((M, d, f), (M, f, d))]
    assert got == want


def test_autotune_shapes_times_grouped_kernels_at_grouped_shapes(jax_trees):
    eng = _port_engine(jax_trees[1], t_smoke(ARCH), "auto")
    results = eng.autotune_shapes(reps=1)
    assert sorted(results) == eng.matmul_shape_universe()
    cache = tdispatch.AutotuneCache.load()
    for shape, us in results.items():
        e = shape[0] if len(shape) == 4 else None
        m, k, n = shape[-3:]
        want = {s.name for s in tdispatch.eligible_kernels(m, k, n,
                                                           "bfloat16", e)}
        assert set(us) == want
        assert all(tdispatch.REGISTRY[name].grouped == (e is not None)
                   for name in us)
        assert cache.best(m, k, n, "bfloat16", "cpu", e=e) == \
            min(us, key=us.get)


def test_serve_launcher_serves_phi_on_the_cpu(capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", "phi3p5_moe_42b_a6p6b", "--smoke",
                       "--device", "cpu", "--batch", "2", "--requests", "3",
                       "--new-tokens", "3", "--policy", "fixed:w2a8",
                       "--act-dtype", "int8"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    report = capsys.readouterr().out.split("kernel launches: ")[1]
    assert "grouped_dequant 0, grouped_w2a8 0" in report
