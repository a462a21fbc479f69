"""The port's llama4-maverick against the JAX package: its config, the
``dense_blocks``/``moe_blocks`` interleave with the shared expert (init,
conversion, packing, the layer-by-layer serving build, each packed
projection's logical width), the forward trunk, and serving through
whole-prompt admission.

Both packages run the reduced llama4-maverick-400b-a17b (4 layers: two
groups of a dense block then an MoE block; d_model 128, 8 experts top-1
with a shared expert, d_ff 256, and ``dense_ff`` 512, twice d_ff as in
the full config), on the JAX init converted leaf for leaf; inputs come
from numpy seeds.

Tolerances, and why (the MoE margin rule of ``test_torch_moe.py``):
  * against JAX run op by op: bitwise (the port follows the reference op
    for op, routing included).
  * against compiled JAX: XLA keeps f32 between fused elementwise ops
    where the op-by-op form rounds to bf16, a few bf16 ulps.  Top-1
    routing is discontinuous in the hidden state, and with a per-expert
    capacity one rerouted token can push another out of its expert's
    buffer, so a near tie anywhere changes the whole batch.  The forward
    is therefore held to compiled JAX (hidden states within 2^-4, aux
    within 2^-7) only where every token's top-1 router probability beats
    its second by at least ``ROUTER_MARGIN`` = 2^-8 in every MoE layer
    (measured: ulp-level differences move the router probabilities by
    under 1e-4 here); otherwise the near tie is asserted and the op-by-op
    comparison is the oracle.  The engines' logits are held to
    ``TOL_COMPILED`` = 1.0 and their streams step for step until a step
    whose JAX top-2 margin is below it, as phi3.5-moe's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as j_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.configs.registry import get_config as t_config
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import ContinuousScheduler

ARCH = "llama4-maverick-400b-a17b"
SMOKE = {"dense_ff": 512}
TOL_COMPILED = 1.0
HIDDEN_TOL = 2.0 ** -4
AUX_TOL = 2.0 ** -7
ROUTER_MARGIN = 2.0 ** -8
PROMPT_LENS = [5, 12, 12, 5]
NEW_TOKENS = 5
MAX_LEN = 48


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def cfgs():
    return j_smoke(ARCH, **SMOKE), t_smoke(ARCH, **SMOKE)


@pytest.fixture(scope="module")
def trees():
    jcfg, _ = cfgs()
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(2))
    return (jax.tree.map(np.asarray, jp),
            jax.tree.map(np.asarray, jdecode.quantize_for_serving(jp, jcfg)))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _equal_trees(want, got):
    """JAX numpy tree against the port's ``to_numpy_tree`` output."""
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        assert _bits(w).dtype == g.dtype and np.array_equal(_bits(w), g), \
            jax.tree_util.keystr(path)


def test_registry_holds_every_reference_arch():
    assert sorted(T_ARCHS) == sorted(J_ARCHS)
    assert len(T_ARCHS) == 11


@pytest.mark.parametrize("smoke", [False, True])
def test_llama4_config_is_the_reference_config(smoke):
    if smoke:
        assert t_smoke(ARCH).__dict__ == j_smoke(ARCH).__dict__
    else:
        assert t_config(ARCH).__dict__ == j_config(ARCH).__dict__
        assert t_config("llama4_maverick_400b_a17b").name == ARCH
    tcfg = t_config(ARCH)
    assert (tcfg.moe_every, tcfg.dense_ff, tcfg.n_experts,
            tcfg.experts_per_token, tcfg.moe_shared_expert) == \
        (2, 16_384, 128, 1, True)


def test_params_convert_leaf_for_leaf(trees):
    """The JAX tree's stacks are the port's: the same keys, shapes and
    dtypes as the port's own ``init_params``, and the bytes cross both
    ways unchanged."""
    jp, _ = trees
    _, tcfg = cfgs()
    tcfg_check = tmodel.check_supported(tcfg)
    assert tcfg_check is None
    assert tmodel.layer_stacks(tcfg) == {"dense_blocks": 2, "moe_blocks": 2}
    own = to_numpy_tree(tmodel.init_params(tcfg, torch.Generator()
                                           .manual_seed(0), "cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == _bits(b).dtype
    assert jp["dense_blocks"]["ffn"]["wo"]["w"].shape == (2, 512, 128)
    assert jp["moe_blocks"]["moe"]["shared"]["wo"]["w"].shape == (2, 256, 128)
    _equal_trees(jp, to_numpy_tree(from_numpy_tree(jp, "cpu")))


def test_quantize_for_serving_bytes_equal_jax(trees):
    jp, js = trees
    _, tcfg = cfgs()
    got = to_numpy_tree(tdecode.quantize_for_serving(
        from_numpy_tree(jp, "cpu"), tcfg))
    _equal_trees(js, got)
    assert got["moe_blocks"]["moe"]["wi"]["scale"].shape == (2, 8)
    assert got["moe_blocks"]["moe"]["shared"]["wi"]["scale"].shape == (2,)


def test_init_params_and_init_serving_params_build_byte_identically():
    _, tcfg = cfgs()
    whole = tdecode.quantize_for_serving(
        tmodel.init_params(tcfg, torch.Generator().manual_seed(3), "cpu"),
        tcfg)
    layered = tdecode.init_serving_params(
        tcfg, torch.Generator().manual_seed(3), "cpu")
    a, b = to_numpy_tree(whole), to_numpy_tree(layered)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_logical_k_gives_dense_ff_for_a_dense_blocks_wo(trees):
    _, tcfg = cfgs()
    k = tdecode._logical_k
    assert k(tcfg, ("dense_blocks", "ffn", "wo")) == tcfg.dense_ff == 512
    assert k(tcfg, ("dense_blocks", "ffn", "wi")) == tcfg.d_model
    assert k(tcfg, ("moe_blocks", "moe", "shared", "wo")) == tcfg.d_ff
    assert k(tcfg, ("moe_blocks", "moe", "wo")) == tcfg.d_ff
    assert k(tcfg, ("blocks", "ffn", "wo")) == tcfg.d_ff
    bound = tdecode.bind_serving_weights(from_numpy_tree(trees[1], "cpu"),
                                         tcfg)
    dense, moe = bound["dense_blocks"][0], bound["moe_blocks"][0]
    assert dense["ffn"]["wo"]["tw"].in_features == 512
    assert dense["ffn"]["wi"]["tw"].in_features == 128
    assert moe["moe"]["shared"]["wo"]["tw"].in_features == 256
    assert moe["moe"]["wo"]["gw"].in_features == 256


@pytest.mark.parametrize("batch_size,seq_len", [(4, 1), (1, 120)])
def test_serving_problems_keep_the_shared_expert_d_ff(batch_size, seq_len):
    """Full width: llama4's dense problems are the reference's, every one,
    the shared expert's d_ff ones and the dense blocks' dense_ff ones
    among them; its grouped problems are the reference's too."""
    tcfg, jcfg = t_config(ARCH), j_config(ARCH)
    got = tengine.serving_matmul_problems(tcfg, batch_size, seq_len)
    assert got == jdecode.layer_matmul_problems(jcfg, batch_size, seq_len)
    M = batch_size * seq_len
    assert {("wi", M, 5120, 8192), ("wo", M, 8192, 5120),
            ("wi", M, 5120, 16384), ("wo", M, 16384, 5120)} <= set(got)
    assert tdecode.layer_grouped_matmul_problems(tcfg, batch_size, seq_len) \
        == jdecode.layer_grouped_matmul_problems(jcfg, batch_size, seq_len)


# ---------------------------------------------------------------------------
# the forward trunk
# ---------------------------------------------------------------------------


def _tokens(seed):
    return np.random.default_rng(seed).integers(2, 512, size=(2, 9)).astype(
        np.int32)


def _port_forward(tp, tcfg, toks):
    """Hidden states, aux and each token's smallest router margin (top-1
    minus top-2 probability) over the MoE layers."""
    gaps, route = [], tlayers.route

    def recording(router, xf, cfg):
        probs, vals, idx = route(router, xf, cfg)
        top = probs.sort(-1, descending=True)[0]
        gaps.append(top[:, 0] - top[:, 1])
        return probs, vals, idx

    tlayers.route = recording
    try:
        with torch.no_grad():
            h, aux = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(
                toks).long()})
    finally:
        tlayers.route = route
    assert len(gaps) == tcfg.n_layers // tcfg.moe_every
    return h.float().numpy(), float(aux), float(torch.stack(gaps).min())


def test_forward_matches_jax_op_by_op(trees):
    """One group (a dense block, then an MoE block with its shared
    expert): hidden states bitwise, the aux loss within f32 ulps (its
    means and sum reduce in another order)."""
    jp, _ = trees
    jcfg, tcfg = (c.with_(n_layers=2) for c in cfgs())
    jp = {k: (jax.tree.map(lambda a: a[:1], v) if k.endswith("_blocks")
              else v) for k, v in jp.items()}
    toks = _tokens(0)
    with jax.disable_jit():
        jh, jaux = jmodel.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                                  {"tokens": jnp.asarray(toks)})
    h, aux, _ = _port_forward(from_numpy_tree(jp, "cpu"), tcfg, toks)
    assert np.array_equal(h, np.asarray(jh.astype(jnp.float32)))
    np.testing.assert_allclose(aux, float(jaux), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_compiled_jax_by_the_margin_rule(trees, seed):
    jp, _ = trees
    jcfg, tcfg = cfgs()
    toks = _tokens(seed)
    jh, jaux = jax.jit(lambda p, t: jmodel.forward(p, jcfg, {"tokens": t}))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(toks))
    h, aux, gap = _port_forward(from_numpy_tree(jp, "cpu"), tcfg, toks)
    assert np.isfinite(h).all() and h.shape == (2, 9, 128)
    if gap < ROUTER_MARGIN:
        return      # a near tie: the op-by-op test is the oracle
    assert np.abs(h - np.asarray(jh.astype(jnp.float32))).max() <= HIDDEN_TOL
    assert abs(aux - float(jaux)) <= AUX_TOL


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(2, 512, size=n).tolist() for n in PROMPT_LENS]


def _top2_margin(logits: np.ndarray) -> float:
    r = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(
        jnp.float32))
    top = np.sort(r)[-2:]
    return float(top[1] - top[0])


@pytest.fixture(scope="module")
def jax_served(trees):
    _, js = trees
    jcfg, _ = cfgs()
    eng = jengine.DecodeEngine(
        jax.tree.map(jnp.asarray, js), jcfg, batch_size=2, max_len=MAX_LEN,
        sampler=jengine.SamplerConfig(canonical_greedy=True))
    reqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in _prompts()]
    eng.serve(reqs)
    return eng, [r.out for r in reqs]


def _jax_forced(jeng, js, prompt, stream):
    """JAX logits before each token of ``stream`` (batch 1): the engine's
    compiled whole-prompt prefill, then its compiled decode step."""
    cache, logits = jeng._prefill(js, {"tokens": jnp.asarray([prompt],
                                                             jnp.int32)})
    out = [np.asarray(logits[0])]
    for i, tok in enumerate(stream[:-1]):
        logits, cache = jeng._step(js, cache, jnp.asarray([tok], jnp.int32),
                                   jnp.asarray([len(prompt) + i], jnp.int32))
        out.append(np.asarray(logits[0]))
    return np.stack(out)


def _port_forced(eng, prompt, stream):
    cache, logits = tdecode.prefill(eng.params, eng.cfg, {
        "tokens": torch.tensor([prompt])}, MAX_LEN)
    out = [logits[0].numpy()]
    for i, tok in enumerate(stream[:-1]):
        logits, cache = tdecode.decode_step(
            eng.params, eng.cfg, cache, torch.tensor([tok]),
            torch.tensor([len(prompt) + i], dtype=torch.int32))
        out.append(logits[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("policy", ["auto", "fixed:ref"])
def test_engine_streams_match_the_jax_engine(trees, jax_served, policy):
    """Whole-prompt admission (the interleave has no chunked prefill):
    every request's port logits, teacher-forced on the JAX stream, within
    ``TOL_COMPILED`` of the JAX engine's compiled prefill and step, and
    the streams equal up to a step whose JAX top-2 margin is below it."""
    _, js = trees
    _, tcfg = cfgs()
    jeng, jstreams = jax_served
    eng = tengine.DecodeEngine(
        from_numpy_tree(js, "cpu"), tcfg, batch_size=2, max_len=MAX_LEN,
        matmul_policy=policy, device="cpu",
        sampler=tengine.SamplerConfig(canonical_greedy=True))
    assert not eng.chunked_admission
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in _prompts()]
    sched = ContinuousScheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    jjs = jax.tree.map(jnp.asarray, js)
    for prompt, r, jstream in zip(_prompts(), reqs, jstreams):
        assert r.done and len(r.out) == NEW_TOKENS
        jl = _jax_forced(jeng, jjs, prompt, jstream)
        assert np.abs(_port_forced(eng, prompt, jstream) - jl).max() <= \
            TOL_COMPILED
        for t, (a, b) in enumerate(zip(r.out, jstream)):
            if a != b:
                assert _top2_margin(jl[t]) < TOL_COMPILED
                break


def test_serve_launcher_serves_llama4_on_the_cpu(capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", "llama4_maverick_400b_a17b", "--smoke",
                       "--device", "cpu", "--batch", "2", "--requests", "3",
                       "--new-tokens", "3"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert "grouped_dequant 0" in capsys.readouterr().out
