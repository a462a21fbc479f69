"""The port's recurrent families against the JAX package: zamba2's Mamba2
mixer (``_causal_conv``, ``_ssd_chunked``, ``mamba2_block``) and xlstm's
mLSTM and sLSTM cells, then the model paths over them (``init_cache``,
``prefill``, ``prefill_into_slot``, ``decode_step`` with a dead row), the
matmul shapes a step issues and each bound projection's width.

Both packages run the same parameters: the JAX ``init_params`` →
``quantize_for_serving`` tree, converted (``from_numpy_tree``), at
zamba2's smoke config with 4 layers and a shared block every 2 (two shared
invocations) and xlstm's smoke config (4 layers, d_model 128).  Inputs come
from numpy seeds.

Tolerances, each with its reason:
  * f32 paths (``_ssd_chunked``, the sLSTM recurrence, the mLSTM chunk
    scan on f32 inputs): the same contractions summed in other orders, so
    a few f32 ulps of the largest magnitude: relative 1e-5.
  * bf16 paths (the conv, each block's output): XLA keeps f32 between the
    fused elementwise ops of a block where the port rounds every op to
    bf16 as written, so outputs move by a few bf16 ulps of the block's
    largest magnitude: relative 2^-5 (eight ulps at the top binade).
  * recurrent states after a block: f32 states fed by those bf16 values:
    relative 2^-5 of the state's largest magnitude.
  * logits (magnitude < 4) through the whole model: those bf16 roundings
    through every layer, measured up to 0.06 at these configs: max abs
    diff 2^-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.registry import get_config as j_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs.registry import get_config as t_config
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.config import ModelConfig

ZAMBA = "zamba2-2.7b"
XLSTM = "xlstm-125m"
#: zamba2 at 4 layers with the shared block after every 2nd
OVERRIDES = {ZAMBA: dict(n_layers=4, attn_every=2), XLSTM: {}}
REL_F32 = 1e-5
REL_BF16 = 2.0 ** -5
TOL_LOGITS = 2.0 ** -3
MAX_LEN = 160


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def cfgs(arch):
    return j_smoke(arch, **OVERRIDES[arch]), t_smoke(arch, **OVERRIDES[arch])


@pytest.fixture(scope="module", params=[ZAMBA, XLSTM])
def model(request):
    """(arch, jcfg, tcfg, JAX serving tree, the port's bound tree)."""
    arch = request.param
    jcfg, tcfg = cfgs(arch)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(3)), jcfg)
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    return arch, jcfg, tcfg, js, tdecode.bind_serving_weights(ts, tcfg)


@functools.lru_cache(maxsize=None)
def _zamba_layer(seed=3):
    """Layer 0 of zamba2's Mamba2 stack on both sides."""
    jcfg, tcfg = cfgs(ZAMBA)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(seed)), jcfg)
    jl = jax.tree.map(lambda t: t[0], js["mamba_blocks"])["mixer"]
    tl = tdecode.bind_serving_weights(
        from_numpy_tree(jax.tree.map(np.asarray, js), "cpu"),
        tcfg)["mamba_blocks"][0]["mixer"]
    return jcfg, tcfg, jl, tl


@functools.lru_cache(maxsize=None)
def _xlstm_layers(seed=3):
    jcfg, tcfg = cfgs(XLSTM)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(seed)), jcfg)
    tb = tdecode.bind_serving_weights(
        from_numpy_tree(jax.tree.map(np.asarray, js), "cpu"), tcfg)
    pick = lambda name: jax.tree.map(lambda t: t[0], js[name])["cell"]  # noqa
    return (jcfg, tcfg, pick("mlstm_blocks"), tb["mlstm_blocks"][0]["cell"],
            pick("slstm_blocks"), tb["slstm_blocks"][0]["cell"])


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bf16(a):
    """numpy f32 → (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _close(j, t, rel, what=""):
    a = np.asarray(jnp.asarray(j).astype(jnp.float32))
    b = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(a).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, (what, err, rel * scale)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    K, C, S = 4, 48, 9 if not with_state else 1
    jx, tx = _bf16(_x((2, S, C), 0))
    jk, tk = _bf16(_x((K, C), 1) * 0.1)
    if with_state:
        js_, ts_ = _bf16(_x((2, K - 1, C), 2))
        (jy, jst), (ty, tst) = (jssm._causal_conv(jx, jk, js_),
                                tssm._causal_conv(tx, tk, ts_))
        _close(jst, tst, 0.0, "conv state")
    else:
        jy, ty = jssm._causal_conv(jx, jk), tssm._causal_conv(tx, tk)
    _close(jy, ty, REL_BF16, "conv out")


@pytest.mark.parametrize("S,chunk", [(7, 128), (20, 8), (16, 16)])
def test_ssd_chunked_matches_jax(S, chunk):
    B, H, P, N = 2, 3, 4, 5
    u = _x((B, S, H, P), 0)
    Bi, Ci = _x((B, S, N), 1), _x((B, S, N), 2)
    log_a = -np.abs(_x((B, S, H), 3)) * 0.3
    h0 = _x((B, H, N, P), 4)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, (u, Bi, Ci, log_a)), chunk,
                               jnp.asarray(h0))
    ty, th = tssm._ssd_chunked(*map(torch.from_numpy, (u, Bi, Ci, log_a)),
                               chunk, torch.from_numpy(h0))
    _close(jy, ty, REL_F32, "y")
    _close(jh, th, REL_F32, "h")


def test_mamba2_block_prefill_and_decode_match_jax():
    jcfg, tcfg, jl, tl = _zamba_layer()
    jx, tx = _bf16(_x((2, 6, jcfg.d_model), 5))
    block = jax.jit(lambda p, x, st, cv: jssm.mamba2_block(
        p, x, jcfg, state=st, conv_state=cv))
    jy, (jh, jc) = block(jl, jx, None, None)
    ty, (th, tc) = tssm.mamba2_block(tl, tx, tcfg)
    _close(jy, ty, REL_BF16, "prefill y")
    _close(jh, th, REL_BF16, "ssm state")
    _close(jc, tc, REL_BF16, "conv state")
    # one decode step from the JAX states, on both sides
    jx1, tx1 = _bf16(_x((2, 1, jcfg.d_model), 6))
    th0 = torch.from_numpy(np.asarray(jh))
    tc0 = torch.from_numpy(np.asarray(jc.astype(jnp.float32))).to(
        torch.bfloat16)
    jy1, (jh1, jc1) = block(jl, jx1, jh, jc)
    ty1, (th1, tc1) = tssm.mamba2_block(tl, tx1, tcfg, state=th0,
                                        conv_state=tc0)
    _close(jy1, ty1, REL_BF16, "decode y")
    _close(jh1, th1, REL_BF16, "decode ssm state")
    _close(jc1, tc1, REL_BF16, "decode conv state")


def test_mamba2_prefill_shorter_than_the_conv_leaves_no_conv_state():
    jcfg, tcfg, jl, tl = _zamba_layer()
    _, tx = _bf16(_x((1, 2, jcfg.d_model), 5))
    assert tssm.mamba2_block(tl, tx, tcfg)[1][1] is None


@pytest.mark.parametrize("S,chunk", [(9, 128), (21, 8)])
def test_mlstm_block_chunked_and_decode_match_jax(S, chunk):
    jcfg, tcfg, jm, tm, _, _ = _xlstm_layers()
    jx, tx = _bf16(_x((2, S, jcfg.d_model), 7))
    jy, jst = jax.jit(lambda p, x: jxlstm.mlstm_block(p, x, jcfg,
                                                      chunk=chunk))(jm, jx)
    ty, tst = txlstm.mlstm_block(tm, tx, tcfg, chunk=chunk)
    _close(jy, ty, REL_BF16, "prefill y")
    for n, a, b in zip("Cnm", jst, tst):
        _close(a, b, REL_BF16, f"state {n}")
    jx1, tx1 = _bf16(_x((2, 1, jcfg.d_model), 8))
    jst0 = tuple(jnp.asarray(b.numpy()) for b in tst)
    jy1, jst1 = jax.jit(lambda p, x, st: jxlstm.mlstm_block(
        p, x, jcfg, state=st, decode=True))(jm, jx1, jst0)
    ty1, tst1 = txlstm.mlstm_block(tm, tx1, tcfg, state=tst, decode=True)
    _close(jy1, ty1, REL_BF16, "decode y")
    for n, a, b in zip("Cnm", jst1, tst1):
        _close(a, b, REL_BF16, f"decode state {n}")


@pytest.mark.parametrize("S", [1, 13, 64])
def test_slstm_block_matches_jax(S):
    jcfg, tcfg, _, _, js_, ts_ = _xlstm_layers()
    jx, tx = _bf16(_x((2, S, jcfg.d_model), 9))
    jy, jst = jax.jit(lambda p, x: jxlstm.slstm_block(p, x, jcfg))(js_, jx)
    ty, tst = txlstm.slstm_block(ts_, tx, tcfg)
    _close(jy, ty, REL_BF16, "y")
    for n, a, b in zip(("c", "n", "h", "m"), jst, tst):
        _close(a, b, REL_BF16, f"state {n}")


# ---------------------------------------------------------------------------
# the sLSTM's padded steps: the port steps only the real positions
# ---------------------------------------------------------------------------


def _slstm_stepwise(jp, jx, jcfg):
    """The JAX package's own recurrence, one ``slstm_scan`` call a step."""
    state, hs = None, []
    for t in range(jx.shape[1]):
        h, state = jxlstm.slstm_scan(jp, jx[:, t:t + 1], jcfg, state)
        hs.append(h)
    return jnp.concatenate(hs, 1), state


@pytest.mark.parametrize("S", [40, 64, 128])
def test_slstm_scan_equals_jax_where_the_reference_pads_nothing(S):
    """S <= 64 or a multiple of 64: the reference steps no padding."""
    jcfg, tcfg, _, _, js_, ts_ = _xlstm_layers()
    x = _x((2, S, jcfg.d_model), 10)
    jh, jst = jax.jit(lambda p, v: jxlstm.slstm_scan(p, v, jcfg))(
        js_, jnp.asarray(x))
    th, tst = txlstm.slstm_scan(ts_, torch.from_numpy(x), tcfg)
    _close(jh, th, REL_F32, "h seq")
    for n, a, b in zip(("c", "n", "h", "m"), jst, tst):
        _close(a, b, REL_F32, f"state {n}")


def test_slstm_scan_at_70_equals_the_jax_step_by_step_recurrence():
    jcfg, tcfg, _, _, js_, ts_ = _xlstm_layers()
    x = _x((2, 70, jcfg.d_model), 11)
    jh, jst = jax.jit(lambda p, v: _slstm_stepwise(p, v, jcfg))(
        js_, jnp.asarray(x))
    th, tst = txlstm.slstm_scan(ts_, torch.from_numpy(x), tcfg)
    _close(jh, th, REL_F32, "h seq")
    for n, a, b in zip(("c", "n", "h", "m"), jst, tst):
        _close(a, b, REL_F32, f"state {n}")


def test_jax_slstm_scan_at_70_departs_from_its_own_recurrence():
    """Why the port departs: the reference's padded steps move its state
    away from the one its own recurrence reaches (measured: up to 1.3 in
    ``c`` at d_model 32)."""
    jcfg, _, _, _, js_, _ = _xlstm_layers()
    x = jnp.asarray(_x((2, 70, jcfg.d_model), 11))
    _, padded = jax.jit(lambda p, v: jxlstm.slstm_scan(p, v, jcfg))(js_, x)
    _, stepwise = jax.jit(lambda p, v: _slstm_stepwise(p, v, jcfg))(js_, x)
    diff = max(float(jnp.abs(a - b).max()) for a, b in zip(padded, stepwise))
    assert diff > 0.1


def test_xlstm_prefill_at_70_equals_the_jax_step_by_step_recurrence():
    """The port's prefill state and logits for a 70-token prompt against
    the JAX package's decode_step fed the prompt one token at a time from
    init_cache (the reference's own recurrence, without padded steps)."""
    jcfg, tcfg = cfgs(XLSTM)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(3)), jcfg)
    tb = tdecode.bind_serving_weights(
        from_numpy_tree(jax.tree.map(np.asarray, js), "cpu"), tcfg)
    prompt = np.random.default_rng(12).integers(2, 512, size=70)
    step = jax.jit(lambda p, c, t, i: jdecode.decode_step(p, jcfg, c, t, i))
    jc = jdecode.init_cache(jcfg, 1, MAX_LEN)
    for i, tok in enumerate(prompt):
        jl, jc = step(js, jc, jnp.asarray([tok], jnp.int32),
                      jnp.asarray([i], jnp.int32))
    tc, tl = tdecode.prefill(tb, tcfg, {"tokens": torch.from_numpy(
        prompt[None])}, MAX_LEN)
    assert float(np.abs(np.asarray(jl) - tl.numpy()).max()) <= TOL_LOGITS
    for name in jc:
        _close(jc[name], tc[name], REL_BF16, name)


# ---------------------------------------------------------------------------
# the model paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
@pytest.mark.parametrize("B,s_max", [(1, 16), (3, 40)])
def test_init_cache_is_bitwise_the_reference(arch, B, s_max):
    jcfg, tcfg = cfgs(arch)
    jc = jdecode.init_cache(jcfg, B, s_max)
    tc = tdecode.init_cache(tcfg, B, s_max, device="cpu")
    assert sorted(jc) == sorted(tc)
    for name in jc:
        a, b = np.asarray(jc[name]), to_numpy_tree({name: tc[name]})[name]
        assert a.shape == b.shape and np.array_equal(
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a, b), name


def _prefill_both(arch, jcfg, tcfg, js, tb, toks):
    jc, jl = jax.jit(lambda p, b: jdecode.prefill(p, jcfg, b, MAX_LEN))(
        js, {"tokens": jnp.asarray(toks, jnp.int32)})
    tc, tl = tdecode.prefill(tb, tcfg, {"tokens": torch.from_numpy(toks)},
                             MAX_LEN)
    return jc, jl, tc, tl


def test_prefill_caches_and_logits_match_jax(model):
    arch, jcfg, tcfg, js, tb = model
    toks = np.random.default_rng(13).integers(2, 512, size=(2, 11))
    jc, jl, tc, tl = _prefill_both(arch, jcfg, tcfg, js, tb, toks)
    assert float(np.abs(np.asarray(jl) - tl.numpy()).max()) <= TOL_LOGITS
    assert sorted(jc) == sorted(tc)
    for name in jc:
        rel = 0.0 if name == "pos" else REL_BF16
        _close(jc[name], tc[name], rel, name)


def test_prefill_into_slot_leaves_the_other_rows_untouched(model):
    arch, jcfg, tcfg, js, tb = model
    rng = np.random.default_rng(14)
    live, _ = tdecode.prefill(tb, tcfg, {"tokens": torch.from_numpy(
        rng.integers(2, 512, size=(3, 9)))}, MAX_LEN)
    before = {k: v.clone() for k, v in live.items()}
    prompt = rng.integers(2, 512, size=(1, 6))
    cache, logits = tdecode.prefill_into_slot(
        tb, tcfg, live, {"tokens": torch.from_numpy(prompt)}, 1, MAX_LEN)
    one, l1 = tdecode.prefill(tb, tcfg, {"tokens": torch.from_numpy(prompt)},
                              MAX_LEN)
    assert torch.equal(logits, l1[0])
    for name, leaf in cache.items():
        for row in (0, 2):
            assert torch.equal(leaf[:, row], before[name][:, row]), name
        assert torch.equal(leaf[:, 1], one[name][:, 0]), name


def test_decode_step_matches_jax_and_a_dead_row_drops_its_kv(model):
    """Teacher-forced decode from the JAX prefill's cache: logits and
    states against the JAX step, row 1 dead (-1): its KV and positions
    stay, its recurrent states advance as the reference's do."""
    arch, jcfg, tcfg, js, tb = model
    toks = np.random.default_rng(15).integers(2, 512, size=(2, 7))
    jc, _, _, _ = _prefill_both(arch, jcfg, tcfg, js, tb, toks)
    tc = from_numpy_tree(jax.tree.map(np.asarray, jc), "cpu")
    tc = {k: (v.view(torch.bfloat16) if v.dtype == torch.int16 else v)
          for k, v in tc.items()}
    before = {k: v.clone() for k, v in tc.items()}
    step = jax.jit(lambda p, c, t, i: jdecode.decode_step(p, jcfg, c, t, i))
    for t, (tok, idx) in enumerate([((5, 9), (7, -1)), ((6, 1), (8, -1))]):
        jl, jc = step(js, jc, jnp.asarray(tok, jnp.int32),
                      jnp.asarray(idx, jnp.int32))
        tl, tc = tdecode.decode_step(tb, tcfg, tc, torch.tensor(tok),
                                     torch.tensor(idx, dtype=torch.int32))
        assert float(np.abs(np.asarray(jl) - tl.numpy()).max()) <= TOL_LOGITS
        for name in jc:
            _close(jc[name], tc[name], 0.0 if name == "pos" else REL_BF16,
                   f"step {t} {name}")
    for name in ("k", "v", "pos"):
        if name in tc:
            assert torch.equal(tc[name][:, 1], before[name][:, 1]), name
    for name in ("ssm", "mC", "sc"):
        if name in tc:
            assert not torch.equal(tc[name][:, 1], before[name][:, 1]), name


def test_zamba2_prompt_shorter_than_the_conv_state_is_refused():
    jcfg, tcfg = cfgs(ZAMBA)
    tb = tdecode.bind_serving_weights(tdecode.init_serving_params(
        tcfg, torch.Generator().manual_seed(0), "cpu"), tcfg)
    for S in (1, 2):
        with pytest.raises(ValueError, match="ssm_conv - 1"):
            tdecode.prefill(tb, tcfg, {"tokens": torch.ones((1, S),
                                                            dtype=torch.long)},
                            MAX_LEN)
    tdecode.prefill(tb, tcfg, {"tokens": torch.ones((1, 3),
                                                    dtype=torch.long)}, MAX_LEN)


# ---------------------------------------------------------------------------
# shapes, widths and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("batch,seq_len", [(1, 1), (4, 1), (1, 120)])
def test_layer_matmul_problems_match_jax(arch, full, batch, seq_len):
    jcfg, tcfg = (j_config(arch), t_config(arch)) if full else cfgs(arch)
    assert tdecode.layer_matmul_problems(tcfg, batch, seq_len) == \
        jdecode.layer_matmul_problems(jcfg, batch, seq_len)


def _ternary_widths(tree, path=()):
    """``{path: din}`` of every ternary leaf of an unquantized JAX tree (a
    layer axis dropped)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if "w" in v and k in jdecode.TERNARY_KEYS and \
                    not (set(path + (k,)) & (jdecode.FP_PARENTS
                                             | jdecode.FP_TOP)):
                out[path + (k,)] = int(v["w"].shape[-2])
            else:
                out.update(_ternary_widths(v, path + (k,)))
    return out


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM, "bitnet-b1.58-2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_every_bound_leaf_has_the_reference_logical_width(arch):
    jcfg = j_smoke(arch, **OVERRIDES.get(arch, {}))
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    want = _ternary_widths(jp)
    tb = tdecode.bind_serving_weights(from_numpy_tree(jax.tree.map(
        np.asarray, jdecode.quantize_for_serving(jp, jcfg)), "cpu"), tcfg)
    got = {}
    for top, node in tb.items():
        for blk in (node if isinstance(node, list) else [node]):
            def walk(n, path):
                for k, v in n.items():
                    if isinstance(v, dict) and ("tw" in v or "gw" in v):
                        w = v.get("tw") or v.get("gw")
                        got.setdefault(path + (k,), set()).add(w.in_features)
                    elif isinstance(v, dict):
                        walk(v, path + (k,))
            walk(blk, (top,))
    assert sorted(got) == sorted(want)
    for path, widths in got.items():
        assert widths == {want[path]}, path


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_layer_by_layer_build_equals_whole_tree_build(arch):
    _, tcfg = cfgs(arch)
    whole = tdecode.quantize_for_serving(
        tmodel.init_params(tcfg, torch.Generator().manual_seed(3), "cpu"),
        tcfg)
    layered = tdecode.init_serving_params(
        tcfg, torch.Generator().manual_seed(3), "cpu")
    a, b = to_numpy_tree(whole), to_numpy_tree(layered)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the reference's tree layout, leaf for leaf
    jcfg = cfgs(arch)[0]
    jt = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(0)), jcfg)
    assert jax.tree.structure(jax.tree.map(np.asarray, jt)) == \
        jax.tree.structure(a)
    for x, y in zip(jax.tree.leaves(jt), jax.tree.leaves(a)):
        assert x.shape == y.shape
