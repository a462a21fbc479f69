"""The port's model (dense attention family) against the JAX package on
converted parameters: the converter round trip, the forward trunk, the
packed serving artifact and ``linear``'s int8 branch.

Inputs come from numpy seeds and go through both packages at a reduced
bitnet-b1.58-2b (4 layers, d_model 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

ARCH = "bitnet-b1.58-2b"


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


@pytest.fixture(scope="module")
def trees():
    jcfg = j_smoke(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, t_smoke(ARCH), jax.tree.map(np.asarray, jp)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _bits(a: np.ndarray) -> np.ndarray:
    """bf16 leaves as their 16-bit patterns; everything else as is."""
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_port_config_is_the_reference_config(trees):
    jcfg, tcfg, _ = trees
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config as tget

    assert tget(ARCH).__dict__ == jget(ARCH).__dict__
    assert tcfg.__dict__ == jcfg.__dict__
    assert tget("bitnet_b1p58_2b").name == ARCH
    # llama4-maverick, the last of the reference's archs, is ported too
    llama4 = "llama4-maverick-400b-a17b"
    assert tget(llama4).__dict__ == jget(llama4).__dict__


def test_converter_round_trip_is_byte_identical(trees):
    jcfg, _, jp = trees
    served = jax.tree.map(np.asarray,
                          jdecode.quantize_for_serving(jax.tree.map(jnp.asarray, jp),
                                                       jcfg))
    for tree in (jp, served):
        back = to_numpy_tree(from_numpy_tree(tree, "cpu"))
        want = dict(_leaves(tree))
        got = dict(_leaves(back))
        assert got.keys() == want.keys()
        for path, a in want.items():
            b = got[path]
            assert b.shape == a.shape, path
            assert _bits(b).tobytes() == _bits(a).tobytes(), path
    # packed bytes cross as they are, 128-byte row padding included
    packed = served["blocks"]["ffn"]["wo"]["packed"]
    assert packed.dtype == np.uint8 and packed.shape[-1] % 128 == 0


def test_port_quantize_for_serving_is_byte_identical(trees):
    jcfg, tcfg, jp = trees
    want = jax.tree.map(np.asarray,
                        jdecode.quantize_for_serving(jax.tree.map(jnp.asarray, jp),
                                                     jcfg))
    got = to_numpy_tree(tdecode.quantize_for_serving(from_numpy_tree(jp, "cpu"),
                                                     tcfg))
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert _bits(got[path]).tobytes() == _bits(a).tobytes(), path


def test_attn_blocks_match_jax_op_by_op(trees):
    """The first two blocks, each on the same bf16 input (every block runs
    the same code; JAX op by op is slow): the port rounds to bf16 at the
    reference's op boundaries, so against JAX run op by op the blocks agree
    to within one bf16 ulp of their outputs (magnitude < 4): atol 2^-6."""
    jcfg, tcfg, jp = trees
    tp = from_numpy_tree(jp, "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)
    jx = jmodel.embed_tokens(jax.tree.map(jnp.asarray, jp), jcfg,
                             jnp.asarray(toks))
    for i, tblk in enumerate(tmodel.layer_blocks(tp)[:2]):
        jblk = jax.tree.map(lambda t: jnp.asarray(t[i]), jp["blocks"])
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
        jy, _ = jmodel._attn_block(jblk, jx, jcfg, jnp.arange(12), 0,
                                   is_moe=False)
        ty, _ = tmodel._attn_block(tblk, tx, tcfg, torch.arange(12), 0)
        want = np.asarray(jy.astype(jnp.float32))
        assert np.abs(ty.float().numpy() - want).max() <= 2.0 ** -6, i
        jx = jy


def test_forward_logits_match_jax(trees):
    """QAT forward (fake-quant weights, int8 fake-quant activations) in bf16
    against the JAX package's compiled forward.  XLA fuses the scanned
    trunk's elementwise chains and keeps f32 between ops where the op-by-op
    form rounds to bf16, and an activation that then lands across an int8
    code boundary moves its code by one; the JAX package's own op-by-op and
    compiled forwards differ by as much.  Over 4 layers the logits
    (magnitude < 4) stay within max abs diff 2^-2, mean abs diff 2^-5."""
    jcfg, tcfg, jp = trees
    tp = from_numpy_tree(jp, "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)
    jh, _ = jmodel.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                           {"tokens": jnp.asarray(toks)})
    jl = np.asarray((jh @ jmodel.lm_head_w(jp, jcfg)).astype(jnp.float32))
    th, aux = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    tl = (th @ tmodel.lm_head_w(tp, tcfg)).float().numpy()
    assert th.dtype == torch.bfloat16 and float(aux) == 0.0
    diff = np.abs(tl - jl)
    assert diff.max() <= 2.0 ** -2 and diff.mean() <= 2.0 ** -5, \
        (diff.max(), diff.mean())


def test_serving_forward_logits_match_jax(trees):
    """The packed serving artifact through the forward trunk: trits are
    exact on both sides and the projections sum bf16 inputs in f32, so the
    logits agree to a bf16 ulp or two: max abs diff <= 2^-4."""
    jcfg, tcfg, jp = trees
    js = jdecode.quantize_for_serving(jax.tree.map(jnp.asarray, jp), jcfg)
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(2, 9)).astype(np.int32)
    jh, _ = jmodel.forward(js, jcfg, {"tokens": jnp.asarray(toks)})
    jl = np.asarray((jh @ jmodel.lm_head_w(js, jcfg)).astype(jnp.float32))
    for policy in ("fixed:ref", "fixed:lut_gather", "fixed:tl2",
                   "fixed:lut_onehot", "fixed:dequant_packed",
                   "fixed:signflip", "fixed:tl2_ref"):
        c = tcfg.with_(matmul_policy=policy)
        th, _ = tmodel.forward(ts, c, {"tokens": torch.from_numpy(toks).long()})
        tl = (th @ tmodel.lm_head_w(ts, c)).float().numpy()
        assert np.abs(tl - jl).max() <= 2.0 ** -4, policy


@pytest.mark.parametrize("policy", [
    None, "fixed:tl2", "fixed:lut_gather", "fixed:w2a8", "fixed:lut_onehot",
    "fixed:dequant_packed", "fixed:signflip"])
def test_linear_int8_branch_matches_jax(policy):
    """W1.58A8: per-token int8 codes are identical, the ternary product of
    int8 codes is exact on both sides, and the two rank-1 rescales round to
    bf16 once: results agree to one bf16 ulp (rtol 2^-8)."""
    rng = np.random.default_rng(2)
    jcfg = j_smoke(ARCH).with_(act_dtype="int8")
    tcfg = t_smoke(ARCH).with_(act_dtype="int8", matmul_policy=policy)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    x = (rng.normal(size=(2, 3, 96)) * 2).astype(np.float32)
    x[0, 1] = 0.0  # an all-zero token row
    jleaf = jdecode._pack_leaf({"w": jnp.asarray(w, jnp.bfloat16)}, False)
    jy = np.asarray(jlayers.linear(jleaf, jnp.asarray(x, jnp.bfloat16), jcfg)
                    .astype(jnp.float32))
    tleaf = from_numpy_tree(jax.tree.map(np.asarray, jleaf), "cpu")
    xt = torch.from_numpy(np.array(jnp.asarray(x, jnp.bfloat16)
                                   .astype(jnp.float32))).to(torch.bfloat16)
    ty = tlayers.linear(tleaf, xt, tcfg)
    assert ty.dtype == torch.bfloat16 and ty.shape == (2, 3, 40)
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=2.0 ** -8, atol=0)
    assert not ty[0, 1].any()


@pytest.mark.parametrize("kind", ["causal", "full", "causal_strict", "self"])
def test_sdpa_mask_kinds_match_jax(kind):
    """Per-row query positions, empty cache slots (k_pos = -1), a sliding
    window on "causal", and the appended chunk merged as one more
    online-softmax partition: f32 inputs, so both sides agree to f32
    rounding (atol 1e-5)."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    B, Sq, Sk, H, Hkv, hd = 2, 3, 7, 4, 2, 8
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    k1 = rng.normal(size=(B, Sq, Hkv, hd)).astype(np.float32)
    v1 = rng.normal(size=(B, Sq, Hkv, hd)).astype(np.float32)
    q_pos = np.array([[4, 5, 6], [2, 3, -1]], np.int32)
    k_pos = np.array([[0, 1, 2, 3, -1, -1, -1], [0, 1, -1, -1, -1, -1, -1]],
                     np.int32)
    window = 3 if kind == "causal" else 0
    jm = jlayers._chunk_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), kind, window)
    tm = tlayers._chunk_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                             kind, window)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    want = jlayers._sdpa(*map(jnp.asarray, (q, k, v)), jcfg, q_pos=q_pos,
                         k_pos=k_pos, kind=kind, window=window,
                         extra_kv=tuple(map(jnp.asarray, (k1, v1, q_pos))),
                         extra_kind="self" if kind != "full" else None)
    got = tlayers._sdpa(*map(torch.from_numpy, (q, k, v)), tcfg,
                        q_pos=torch.from_numpy(q_pos),
                        k_pos=torch.from_numpy(k_pos), kind=kind, window=window,
                        extra_kv=tuple(map(torch.from_numpy, (k1, v1, q_pos))),
                        extra_kind="self" if kind != "full" else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
