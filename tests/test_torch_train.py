"""The port's training side against the JAX package: the straight-through
quantizers, the 2-bit packing, the chunked CE loss and ``train_loss``
(values and gradients), AdamW and Adafactor, gradient compression, the
data pipeline, checkpoints (restored across the two packages), the train
step and loop, and the train → quantize → serve lifecycle.

Models run at reduced configs (bitnet-b1.58-2b with int8 activation
fake-quant, phi3.5-moe with its aux loss, llama4-maverick with
``dense_ff=512``, 4 layers, d_model 128; zamba2 with two groups of 6
Mamba2 blocks and the shared block, xlstm with 2 mLSTM/sLSTM pairs);
inputs come from numpy seeds.

Tolerances, and why:
  * quantizers, packings, the schedule, clipping, compression, data and
    checkpoints: exact (the same bytes), or f32-ulp close where both
    sides round the same f32 arithmetic (``rtol`` 1e-6 on the optimizers
    fed the same gradients; a compression code may step by one where the
    two round a value at .5 apart, never more).
  * ``chunked_ce_loss``: the same f32 log-softmax, summed in another
    order: values and gradients within rtol 1e-5.
  * ``train_loss`` against ``jax.value_and_grad`` of the compiled JAX
    loss: XLA keeps f32 between fused elementwise ops where the port
    rounds each op to bf16 as the reference written op by op does, so
    activations part by bf16 ulps, and with int8 activation fake-quant a
    ulp can move a code.  The loss is held to rtol 2^-7; each gradient
    leaf to a relative L2 distance of 2^-3 (bf16 gradients, each a sum
    over every token of products of parted activations), and the whole
    gradient's norm to rtol 2^-5.  In an MoE a parted router logit can
    send a token to another expert, so there a leaf may part more; the
    MoE configs' leaves are held at the 80th percentile of their
    distances and the gradient norm to rtol 2^-4.
  * three train steps against the JAX jitted step: every step's loss
    within rtol 2^-6 and gnorm within rtol 2^-3; the parameters within
    8 x the summed learning rates at each coordinate (AdamW and
    Adafactor normalize each coordinate's step to about the learning rate
    whatever the gradient's size, so a coordinate whose gradient is
    below the two sides' rounding difference may step either way) and
    within a quarter of it on average.
  * the lifecycle: the port's packed bytes equal JAX's on the same
    trained weights, and the served streams follow the dense serving
    rule (logits within 2^-4, the streams equal up to a step whose top-2
    margin is below it).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.checkpoint import checkpointing as jckpt
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import encoding as jenc
from repro.core import quantization as jq
from repro.data import pipeline as jdata
from repro.launch import train as jtrain
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.serving import engine as jengine
from repro_torch.checkpoint import checkpointing as tckpt
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core import encoding as tenc
from repro_torch.core import quantization as tq
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import train as ttrain
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt
from repro_torch.serving import engine as tengine

BITNET = "bitnet-b1.58-2b"
PHI = "phi3.5-moe-42b-a6.6b"
LLAMA4 = "llama4-maverick-400b-a17b"
ZAMBA = "zamba2-2.7b"
XLSTM = "xlstm-125m"
ARCHS = [BITNET, PHI, LLAMA4, ZAMBA, XLSTM]
#: reduced llama4's dense blocks at twice d_ff, as the full config's
OVERRIDES = {LLAMA4: {"dense_ff": 512}}
SEQ, BATCH = 16, 2
LR, WARMUP, TOTAL = 3e-3, 2, 10
#: the recurrent archs' three steps run at a third of LR: at LR their loss
#: after step 2 is so sensitive to the first steps' rounding that the JAX
#: step compiled and the same step run op by op part by 6.4% on xlstm (4x
#: the loss tolerance below), so no port can be held to either there; at
#: 1e-3 the port stays within 0.3x the loss and 0.63x the gnorm tolerance
#: of the compiled step on both archs
STEP_LR = {ZAMBA: 1e-3, XLSTM: 1e-3}


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def cfgs(arch):
    kw = OVERRIDES.get(arch, {})
    return j_smoke(arch, **kw), t_smoke(arch, **kw)


def _f32(a) -> np.ndarray:
    """A JAX or numpy leaf, or a port tensor, as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else \
        a.astype(np.float32)


def _pairs(jtree, ttree):
    """``(path, jax leaf, port leaf)`` over the JAX tree's leaves."""
    flat = dict(jax.tree_util.tree_leaves_with_path(ttree))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        yield jax.tree_util.keystr(path), leaf, flat[path]


def _rel(a, b) -> float:
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# quantizers and packings
# ---------------------------------------------------------------------------


def test_ste_functions_pass_gradients_straight_through():
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(6, 10)), dtype=torch.float32,
                     requires_grad=True)
    x = torch.tensor(rng.normal(size=(3, 10)) * 4, dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.normal(size=(6, 10)), dtype=torch.float32)
    for fn, t in ((tq.ste_ternarize, w), (lambda v: tq.fake_quant_ternary(
            v, axis=(-1,)), w), (tq.ste_quantize_activations, x),
            (tq.fake_quant_acts, x)):
        cot = g if t is w else g[:3]
        (grad,) = torch.autograd.grad(fn(t), t, cot)
        assert torch.equal(grad, cot)
    # the product's own gradients meet the quantized operands
    y = tq.fake_quant_matmul(x, w.T)
    gx, gw = torch.autograd.grad(y.sum(), (x, w))
    wq = tq.ste_ternarize(w.T).detach()
    xq = tq.ste_quantize_activations(x).detach()
    assert torch.equal(gx, torch.ones(3, 6) @ wq.T)
    assert torch.equal(gw, (xq.T @ torch.ones(3, 6)).T)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fake_quant_values_equal_jax(dtype):
    """``w + (wq - w).detach()`` rounds as the reference's stop-gradient
    form (in bf16 that is not bitwise ``wq``)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(2, 24, 20)).astype(np.float32) * 0.3
    x = rng.normal(size=(5, 20)).astype(np.float32) * 3
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    tw, tx = torch.from_numpy(w).to(tdt), torch.from_numpy(x).to(tdt)
    jw, jx = jnp.asarray(w, jdt), jnp.asarray(x, jdt)
    # in f32 the absmean scale is a mean summed in another order and XLA
    # divides by 127 as a product with its reciprocal: a few f32 ulps,
    # which ``x + (xq - x)`` carries relative to its smaller results
    rtol = 0.0 if dtype == "bfloat16" else 2.0 ** -16
    for got, want in (
            (tq.fake_quant_ternary(tw), jq.fake_quant_ternary(jw)),
            (tq.fake_quant_ternary(tw, axis=(-2, -1)),
             jq.fake_quant_ternary(jw, axis=(-2, -1))),
            (tq.ste_ternarize(tw[0]), jq.ste_ternarize(jw[0])),
            (tq.fake_quant_acts(tx), jq.fake_quant_acts(jx)),
            (tq.ste_quantize_activations(tx),
             jq.ste_quantize_activations(jx)),
            (tq.fake_quant_matmul(tx, tw[0].T),
             jq.fake_quant_matmul(jx, jw[0].T))):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=0)
    w_t = torch.from_numpy(rng.integers(-1, 2, size=(7, 9)).astype(np.int8))
    got = tq.ternary_weight_stats(w_t)
    want = jq.ternary_weight_stats(jnp.asarray(w_t.numpy()))
    assert got.keys() == want.keys()
    for k in want:      # XLA divides by n as a product with 1/n: one ulp
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 13), (1,), (4, 1)])
def test_pack_2bit_bytes_equal_jax(shape):
    w = np.random.default_rng(2).integers(-1, 2, size=shape).astype(np.int8)
    got = tenc.pack_2bit(torch.from_numpy(w))
    want = np.asarray(jenc.pack_2bit(jnp.asarray(w)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    back = tenc.unpack_2bit(got, shape[-1])
    assert np.array_equal(back.numpy(), w)
    assert np.array_equal(
        back.numpy(), np.asarray(jenc.unpack_2bit(jnp.asarray(want),
                                                  shape[-1])))


def test_key_widths_split_key_and_packed_matrix_equal_jax():
    for mu in range(1, 8):
        assert tenc.key_bits_paper(mu) == jenc.key_bits_paper(mu)
        for paper in (False, True):
            assert tenc.bits_per_weight(mu, paper) == \
                jenc.bits_per_weight(mu, paper)
    rng = np.random.default_rng(3)
    w = rng.integers(-1, 2, size=(6, 23)).astype(np.int8)
    for mu in (3, 5):
        keys = tenc.encode_weight_matrix(torch.from_numpy(w), mu)
        jkeys = jenc.encode_weight_matrix(jnp.asarray(w), mu)
        for got, want in zip(tenc.split_key(keys, mu),
                             jenc.split_key(jkeys, mu)):
            assert np.array_equal(got.numpy(), np.asarray(want))
    tp = tenc.pack_ternary_matrix(torch.from_numpy(w), torch.tensor(0.5))
    jp = jenc.pack_ternary_matrix(jnp.asarray(w), jnp.asarray(0.5))
    assert np.array_equal(tp.data.numpy(), np.asarray(jp.data))
    assert tp.shape == jp.shape and tp.bits_per_weight == jp.bits_per_weight
    assert np.array_equal(tenc.unpack_ternary_matrix(tp).numpy(), w)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,vocab", [(24, 8, 500), (21, 8, 512),
                                           (5, 16, 300)])
def test_chunked_ce_loss_value_and_grads_equal_jax(S, chunk, vocab):
    """Ragged S pads the last chunk; a vocab under the head's 512 columns
    masks the padded tail."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, S, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 512)) / 6).astype(np.float32)
    labels = rng.integers(0, vocab, size=(2, S)).astype(np.int32)
    mask = (rng.random((2, S)) > 0.2).astype(np.float32)

    def jloss(x, w):
        return jlayers.chunked_ce_loss(x, w, jnp.asarray(labels),
                                       jnp.asarray(mask), chunk, vocab=vocab)

    jv, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tv = tlayers.chunked_ce_loss(tx, tw, torch.from_numpy(labels),
                                 torch.from_numpy(mask), chunk, vocab=vocab)
    tgx, tgw = torch.autograd.grad(tv, (tx, tw))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for got, want in ((tgx, jgx), (tgw, jgw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def _batch(vocab, step=0, seq=SEQ, batch=BATCH):
    return jdata.SyntheticLMStream(jdata.DataConfig(vocab, seq, batch)).batch(
        step)


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for arch in ARCHS:
        jcfg, _ = cfgs(arch)
        out[arch] = jax.tree.map(np.asarray, jax.jit(
            jmodel.init_params, static_argnums=0)(jcfg,
                                                  jax.random.PRNGKey(1)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_value_and_grads_match_jax(jax_params, arch):
    jcfg, tcfg = cfgs(arch)
    jp = jax_params[arch]
    b = _batch(jcfg.vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in b.items()})
    tp = from_numpy_tree(jp, "cpu")
    leaves = [t.requires_grad_() for t in topt.tree_leaves(tp)]
    tl, tm = tmodel.train_loss(tp, tcfg, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
    grads = torch.autograd.grad(tl, leaves)
    tg = topt.tree_unflatten(tp, grads)
    moe = bool(jcfg.n_experts)
    assert abs(float(tl.detach()) - float(jl)) <= 2.0 ** -7 * abs(float(jl))
    assert abs(float(tm["aux"].detach()) - float(jm["aux"])) <= \
        2.0 ** -5 * max(abs(float(jm["aux"])), 1e-6)
    if moe:
        assert float(tm["aux"].detach()) > 0
    rels = sorted(_rel(t, j) for _, j, t in _pairs(jg, tg))
    worst = rels[int(0.8 * (len(rels) - 1))] if moe else rels[-1]
    assert worst <= 2.0 ** -3, rels
    jn = math.sqrt(sum(float((_f32(x).astype(np.float64) ** 2).sum())
                       for x in jax.tree.leaves(jg)))
    tn = float(topt.global_norm(tg))
    assert abs(tn - jn) <= (2.0 ** -4 if moe else 2.0 ** -5) * jn


def test_remat_changes_nothing_but_memory(jax_params):
    """``cfg.remat`` recomputes each block (and llama4's groups) in
    backward: the same loss and bitwise the same gradients."""
    _, tcfg = cfgs(LLAMA4)
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    out = []
    for remat in (True, False):
        tp = from_numpy_tree(jax_params[LLAMA4], "cpu")
        leaves = [t.requires_grad_() for t in topt.tree_leaves(tp)]
        loss, _ = tmodel.train_loss(tp, tcfg.with_(remat=remat), b)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, c) for a, c in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_recurrent_trunks_remat_bitwise(jax_params, arch):
    """zamba2's Mamba2 blocks and groups, xlstm's pairs and the sLSTM's
    64-step time chunks (S = 80 crosses one) recomputed in backward under
    ``cfg.remat``: the same loss and bitwise the same gradients."""
    _, tcfg = cfgs(arch)
    b = {k: torch.from_numpy(v)
         for k, v in _batch(tcfg.vocab_size, seq=80).items()}
    out = []
    for remat in (True, False):
        tp = from_numpy_tree(jax_params[arch], "cpu")
        leaves = [t.requires_grad_() for t in topt.tree_leaves(tp)]
        loss, _ = tmodel.train_loss(tp, tcfg.with_(remat=remat), b)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, c) for a, c in zip(out[0][1], out[1][1]))


def test_ssd_gradient_stays_finite_where_the_decay_overflows():
    """Decays large enough that a chunk's unmasked ``exp(cs_i - cs_j)``
    overflows (as zamba2's dt grow in training): the reference's
    ``where(causal, exp(decay), 0)`` sends NaN back through the exp; the
    port masks before the exp, with the same forward values and a finite
    gradient."""
    rng = np.random.default_rng(5)
    u = rng.normal(size=(1, 16, 2, 4)).astype(np.float32)
    bi, ci = (rng.normal(size=(1, 16, 3)).astype(np.float32) for _ in "bc")
    log_a = -rng.uniform(10.0, 20.0, size=(1, 16, 2)).astype(np.float32)
    jy, jh = jssm._ssd_chunked(u, bi, ci, log_a, 16)
    jg = jax.grad(lambda la: jssm._ssd_chunked(u, bi, ci, la, 16)[0].sum())(
        jnp.asarray(log_a))
    assert np.isnan(np.asarray(jg)).any()
    tl = torch.from_numpy(log_a).requires_grad_()
    ty, th = tssm._ssd_chunked(torch.from_numpy(u), torch.from_numpy(bi),
                               torch.from_numpy(ci), tl, 16)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-5)
    grad, = torch.autograd.grad(ty.sum(), tl)
    assert torch.isfinite(grad).all()


# ---------------------------------------------------------------------------
# optimizers, compression, data
# ---------------------------------------------------------------------------


def _small_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32)},
            "b": rng.normal(size=(7,)).astype(np.float32),
            "e": {"w": rng.normal(size=(3, 4, 5)).astype(np.float32)},
            "s": np.float32(rng.normal())}


def _as_bf16_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_jax_over_three_steps(name):
    """bf16 parameters, the same f32 gradients each step: parameters equal
    up to a bf16 rounding step where the f32 updates part by ulps, state
    within f32 ulps (rtol 1e-6)."""
    jp = _as_bf16_jax(_small_tree(5))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    jo = jopt.make_optimizer(name, base_lr=0.05, warmup=2, total=6)
    to = topt.make_optimizer(name, base_lr=0.05, warmup=2, total=6)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _small_tree(10 + step)
        jp, js = jo.update(js, jax.tree.map(jnp.asarray, g), jp,
                           jnp.asarray(step))
        tp, ts = to.update(ts, from_numpy_tree(g, "cpu"), tp, step)
    for _, j, t in _pairs(jax.tree.map(np.asarray, js), to_numpy_tree(ts)):
        if j.dtype == np.int32:
            assert np.array_equal(j, t)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-30)
    for path, j, t in _pairs(jax.tree.map(np.asarray, jp), tp):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(_f32(j)) + 1e-30)) - 7)
        assert (np.abs(_f32(t) - _f32(j)) <= ulp).all(), path
    # no update at all where ``ok`` is false, the step count included
    before = [x.clone() for x in topt.tree_leaves(tp)] + \
        [x.clone() for x in topt.tree_leaves(ts)]
    to.update(ts, from_numpy_tree(_small_tree(20), "cpu"), tp, 3,
              torch.tensor(False))
    after = topt.tree_leaves(tp) + topt.tree_leaves(ts)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_schedule_and_clipping_match_jax():
    for warmup, total in ((3, 20), (0, 5), (10, 10)):
        jl = jopt.cosine_schedule(1e-3, warmup, total)
        tl = topt.cosine_schedule(1e-3, warmup, total)
        for step in range(total + 3):     # f32 cos of two libraries
            np.testing.assert_allclose(float(tl(step)),
                                       float(jl(jnp.asarray(step))),
                                       rtol=1e-6)
    g = _small_tree(6)
    for max_norm in (0.5, 100.0):
        jg, jn = jopt.clip_by_global_norm(_as_bf16_jax(g), max_norm)
        tg, tn = topt.clip_by_global_norm(
            from_numpy_tree(jax.tree.map(np.asarray, _as_bf16_jax(g)), "cpu"),
            max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for _, j, t in _pairs(jg, tg):
            assert t.dtype == torch.bfloat16
            assert np.abs(_f32(t) - _f32(j)).max() <= \
                2.0 ** -7 * np.abs(_f32(j)).max()


def test_compression_payload_scales_and_errors_match_jax():
    grads = _small_tree(7)
    err = jax.tree.map(lambda a: (np.asarray(a) * 0.01).astype(np.float32),
                       _small_tree(8))
    (jq_, js_), je = jcomp.compress_grads(jax.tree.map(jnp.asarray, grads),
                                          jax.tree.map(jnp.asarray, err))
    (tq_, ts_), te = tcomp.compress_grads(from_numpy_tree(grads, "cpu"),
                                          from_numpy_tree(err, "cpu"))
    for _, j, t in _pairs(jq_, tq_):
        assert t.dtype == torch.int8
        assert np.abs(t.numpy().astype(int) - np.asarray(j).astype(int)
                      ).max() <= 1
    for _, j, t in _pairs(js_, ts_):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-7)
    for _, j, t in _pairs(je, te):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1.01 * float(np.asarray(
                                       js_["b"]).max()) * 64)
    jd, je2 = jcomp.roundtrip(jax.tree.map(jnp.asarray, grads),
                              jax.tree.map(jnp.asarray, err))
    td, te2 = tcomp.roundtrip(from_numpy_tree(grads, "cpu"),
                              from_numpy_tree(err, "cpu"))
    for (_, j, t), (_, j2, t2) in zip(_pairs(jd, td), _pairs(je2, te2)):
        assert t.dtype == torch.float32
        # dequantized + error = grad + carried error on both sides
        np.testing.assert_allclose(t.numpy() + t2.numpy(),
                                   np.asarray(j) + np.asarray(j2), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("step,n_hosts", [(0, 1), (3, 2), (17, 4)])
def test_data_batches_equal_jax_bitwise(step, n_hosts):
    cfg = dict(vocab_size=1000, seq_len=40, global_batch=4, mean_doc_len=16)
    for host in range(n_hosts):
        got = tdata.SyntheticLMStream(tdata.DataConfig(**cfg), host,
                                      n_hosts).batch(step)
        want = jdata.SyntheticLMStream(jdata.DataConfig(**cfg), host,
                                       n_hosts).batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state():
    tp = from_numpy_tree(jax.tree.map(np.asarray, _as_bf16_jax(
        _small_tree(9))), "cpu")
    opt = topt.make_optimizer("adamw")
    return {"params": tp, "opt": opt.init(tp)}


def _equal_trees(a, b):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_round_trip_and_commit_marker(tmp_path):
    state = _state()
    d = tckpt.save(str(tmp_path), 7, state, max_shard_bytes=64)
    assert len(json.load(open(os.path.join(d, "manifest.json")))["shards"]) > 1
    assert tckpt.latest_step(str(tmp_path)) == 7
    assert _equal_trees(tckpt.restore(str(tmp_path), 7, state), state)
    # a save that never committed is ignored
    tckpt.save(str(tmp_path), 9, state)
    os.remove(os.path.join(tmp_path, "step_00000009", "_COMMITTED"))
    assert tckpt.latest_step(str(tmp_path)) == 7
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path), 9, state)
    step, got = tckpt.restore_latest(str(tmp_path), state)
    assert step == 7 and _equal_trees(got, state)
    assert tckpt.restore_latest(str(tmp_path / "none"), state) == (None, None)


def test_checkpoint_catches_a_bad_crc_and_a_wrong_shape(tmp_path):
    state = _state()
    d = tckpt.save(str(tmp_path), 1, state)
    mpath = os.path.join(d, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["leaves"][3]["crc32"] ^= 1
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(str(tmp_path), 1, state)
    assert _equal_trees(tckpt.restore(str(tmp_path), 1, state,
                                      validate=False), state)
    bad = dict(state, params=dict(state["params"], b=torch.zeros(8)))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), 1, bad, validate=False)


def test_async_save_copies_before_returning(tmp_path):
    state = _state()
    snapshot = [t.clone() for t in topt.tree_leaves(state)]
    tckpt.save_async(str(tmp_path), 3, state)
    for t in topt.tree_leaves(state):   # the caller moves on at once
        t.add_(1)
    tckpt.wait()
    assert tckpt.latest_step(str(tmp_path)) == 3
    got = topt.tree_leaves(tckpt.restore(str(tmp_path), 3, state))
    assert all(torch.equal(a, b) for a, b in zip(got, snapshot))


def test_checkpoints_restore_across_the_two_packages(tmp_path):
    """A JAX checkpoint of an AdamW train state restores in the port leaf
    for leaf, and the port's in JAX, bitwise."""
    jp = _as_bf16_jax(_small_tree(11))
    js = jopt.make_optimizer("adamw").init(jp)
    jstate = {"params": jp, "opt": js}
    jckpt.save(str(tmp_path / "jax"), 4, jstate)
    tstate = _state()
    got = tckpt.restore(str(tmp_path / "jax"), 4, tstate)
    for _, j, t in _pairs(jax.tree.map(np.asarray, jstate), to_numpy_tree(got)):
        j = j.view(np.uint16) if j.dtype.name == "bfloat16" else j
        assert j.dtype == t.dtype and np.array_equal(j, t)
    tckpt.save(str(tmp_path / "port"), 5, tstate)
    back = jckpt.restore(str(tmp_path / "port"), 5, jstate)
    for _, j, t in _pairs(back, to_numpy_tree(tstate)):
        j = np.asarray(j)
        j = j.view(np.uint16) if j.dtype.name == "bfloat16" else j
        assert j.dtype == t.dtype and np.array_equal(j, t)


# ---------------------------------------------------------------------------
# the train step and loop
# ---------------------------------------------------------------------------


def _three_steps(jax_params, arch, compress):
    jcfg, tcfg = cfgs(arch)
    lr = STEP_LR.get(arch, LR)
    jp = jax.tree.map(jnp.asarray, jax_params[arch])
    tp = from_numpy_tree(jax_params[arch], "cpu")
    jo = jopt.make_optimizer(jcfg.optimizer, base_lr=lr, warmup=WARMUP,
                             total=TOTAL)
    to = topt.make_optimizer(tcfg.optimizer, base_lr=lr, warmup=WARMUP,
                             total=TOTAL)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jo, compress))
    tstep = ttrain.make_train_step(tcfg, to, compress)
    js, ts = jo.init(jp), to.init(tp)
    je = jcomp.init_error_state(jp) if compress else {}
    te = tcomp.init_error_state(tp) if compress else {}
    for step in range(3):
        b = _batch(jcfg.vocab_size, step)
        jp, js, je, jm = jstep(jp, js, je, {k: jnp.asarray(v)
                                            for k, v in b.items()},
                               jnp.asarray(step))
        tp, ts, te, tm = tstep(tp, ts, te, {k: torch.from_numpy(v)
                                            for k, v in b.items()}, step)
        assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            2.0 ** -6 * abs(float(jm["loss"]))
        assert abs(float(tm["gnorm"]) - float(jm["gnorm"])) <= \
            2.0 ** -3 * float(jm["gnorm"])
    lr_sum = sum(float(jopt.cosine_schedule(lr, WARMUP, TOTAL)(
        jnp.asarray(s))) for s in range(3))
    diffs = [np.abs(_f32(t) - _f32(j)) for _, j, t in _pairs(jp, tp)]
    assert max(d.max() for d in diffs) <= 8 * lr_sum
    assert np.mean([d.mean() for d in diffs]) <= lr_sum / 4


@pytest.mark.parametrize("arch,compress", [(BITNET, False), (BITNET, True),
                                           (PHI, False), (LLAMA4, True),
                                           (ZAMBA, False), (XLSTM, True)])
def test_three_train_steps_match_jax_jitted_step(jax_params, arch, compress):
    _three_steps(jax_params, arch, compress)


def test_a_non_finite_loss_skips_the_step_and_keeps_the_params(jax_params):
    _, tcfg = cfgs(BITNET)
    tp = from_numpy_tree(jax_params[BITNET], "cpu")
    tp["final_norm"]["g"][0] = float("nan")
    opt = topt.make_optimizer(tcfg.optimizer, base_lr=LR, warmup=WARMUP)
    state = opt.init(tp)
    before = [t.clone() for t in topt.tree_leaves(tp) +
              topt.tree_leaves(state)]
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    tp, state, _, m = ttrain.make_train_step(tcfg, opt)(tp, state, {}, b, 0)
    assert not math.isfinite(float(m["loss"])) and float(m["skipped"]) == 1.0
    after = topt.tree_leaves(tp) + topt.tree_leaves(state)
    assert all(torch.equal(a, c) or (torch.isnan(a) == torch.isnan(c)).all()
               and torch.equal(a.nan_to_num(), c.nan_to_num())
               for a, c in zip(before, after))


def test_train_cli_saves_then_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "bitnet_b1p58_2b", "--smoke", "--device", "cpu",
            "--global-batch", "2", "--seq-len", "16", "--ckpt-dir",
            str(tmp_path), "--checkpoint-every", "2"]
    for steps in (3, 5):
        with pytest.raises(SystemExit) as done:
            ttrain.main(argv + ["--steps", str(steps)])
        assert done.value.code == 0
        if steps == 3:
            assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                                    "step_00000002"]
    assert "resumed from step 2" in capsys.readouterr().out
    assert tckpt.latest_step(str(tmp_path)) == 4
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(t_smoke(BITNET), steps=1, global_batch=2, seq_len=8)


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_train_cli_trains_the_recurrent_archs(tmp_path, capsys, arch):
    with pytest.raises(SystemExit) as done:
        ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--steps", "2", "--global-batch", "2", "--seq-len", "16",
                     "--ckpt-dir", str(tmp_path)])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "step     1" in out and "SKIPPED" not in out
    assert tckpt.latest_step(str(tmp_path)) == 1


def test_train_resumes_bitwise(tmp_path):
    """A run checkpointed after step 2 and resumed from there ends with the
    uninterrupted run's losses and parameters, bitwise."""
    _, tcfg = cfgs(BITNET)
    kw = dict(steps=5, global_batch=2, seq_len=16, warmup=2, lr=3e-3,
              device="cpu", log_every=100)
    full = ttrain.train(tcfg, ckpt_dir=str(tmp_path / "a"),
                        checkpoint_every=3, **kw)
    import shutil
    shutil.rmtree(tmp_path / "a" / "step_00000004")
    resumed = ttrain.train(tcfg, ckpt_dir=str(tmp_path / "a"), **kw)
    assert resumed["history"] == full["history"][3:]
    assert _equal_trees(resumed["params"], full["params"])


# ---------------------------------------------------------------------------
# train, quantize, serve
# ---------------------------------------------------------------------------


def test_lifecycle_train_quantize_serve_matches_jax_engine():
    """Train the reduced bitnet with the port, pack it with both packages
    (the same bytes), and serve it on both engines: the streams follow the
    dense serving rule against the compiled JAX engine."""
    jcfg, tcfg = cfgs(BITNET)
    out = ttrain.train(tcfg, steps=3, global_batch=2, seq_len=16, lr=3e-3,
                       warmup=1, device="cpu", log_every=100)
    served = tdecode.quantize_for_serving(out["params"], tcfg)
    jserved = jdecode.quantize_for_serving(
        jax.tree.map(jnp.asarray, _to_jax(to_numpy_tree(out["params"]))),
        jcfg)
    for path, j, t in _pairs(jax.tree.map(np.asarray, jserved),
                             to_numpy_tree(served)):
        j = j.view(np.uint16) if j.dtype.name == "bfloat16" else j
        assert np.array_equal(j, t), path
    prompts = [[3, 4, 5], [9, 8, 7, 6, 5, 4, 3], [11, 12]]
    jeng = jengine.DecodeEngine(
        jserved, jcfg, batch_size=2, max_len=48, prefill_chunk=8,
        sampler=jengine.SamplerConfig(canonical_greedy=True))
    jreqs = [jengine.Request(prompt=p, max_new_tokens=5) for p in prompts]
    jeng.serve(jreqs)
    teng = tengine.DecodeEngine(
        served, tcfg, batch_size=2, max_len=48, prefill_chunk=8,
        device="cpu", sampler=tengine.SamplerConfig(canonical_greedy=True))
    treqs = [tengine.Request(prompt=p, max_new_tokens=5) for p in prompts]
    teng.serve(treqs)
    chunk = jax.jit(lambda p, c, t, pos, take: jdecode.prefill_chunk(
        p, jcfg, c, t, pos, take))
    step = jax.jit(lambda p, c, t, i: jdecode.decode_step(p, jcfg, c, t, i))
    for p, tr, jr in zip(prompts, treqs, jreqs):
        assert tr.done and len(tr.out) == 5
        # teacher-forced on the JAX stream: logits within 2^-4, and where
        # the streams part the JAX top-2 margin is below it
        toks = np.ones((1, 8), np.int32)
        toks[0, :len(p)] = p
        pos = np.where(np.arange(8) < len(p), np.arange(8), -1)[None]
        pos = pos.astype(np.int32)
        cache, jl = chunk(jserved, jdecode.init_cache(jcfg, 1, 48),
                          jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(len(p) - 1, jnp.int32))
        tcache, tl = tdecode.prefill_chunk(
            teng.params, tcfg, tdecode.init_cache(tcfg, 1, 48, device="cpu"),
            torch.from_numpy(toks).long(), torch.from_numpy(pos), len(p) - 1)
        for i, tok in enumerate(jr.out):
            jlog, tlog = np.asarray(jl[0]), tl[0].numpy()
            assert np.abs(jlog - tlog).max() <= 2.0 ** -4
            if tr.out[i] != tok:
                r = np.sort(np.asarray(jnp.asarray(jlog).astype(
                    jnp.bfloat16).astype(jnp.float32)))
                assert r[-1] - r[-2] < 2.0 ** -4
                break
            jl, cache = step(jserved, cache, jnp.asarray([tok], jnp.int32),
                             jnp.asarray([len(p) + i], jnp.int32))
            tl, tcache = tdecode.decode_step(
                teng.params, tcfg, tcache, torch.tensor([tok]),
                torch.tensor([len(p) + i], dtype=torch.int32))


def _to_jax(tree):
    """The port's numpy tree (bf16 as uint16 views) → ml_dtypes bf16."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return tree.view(jnp.bfloat16) if tree.dtype == np.uint16 else tree
