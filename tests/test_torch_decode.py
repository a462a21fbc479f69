"""The port's serving-side model paths against the JAX package: chunked
prefill and decode under teacher forcing, the KV ring invariant, chunked
vs whole-prompt prefill, dead rows, and the matmul shapes one step issues.

Both packages run the same packed serving artifact (the JAX
``quantize_for_serving`` tree, converted) at a reduced bitnet-b1.58-2b
(4 layers, d_model 128); tokens come from numpy seeds.

Tolerance for logits against the JAX package: the trits are exact on both
sides, but XLA compiles the scanned trunk with f32 kept between fused
elementwise ops where the port rounds each op to bf16, so logits (magnitude
< 4) differ by a few bf16 ulps: max abs diff <= 2^-4.  Within the port, the
chunked and the whole-prompt prefill differ only in how the attention is
partitioned (one f32 online softmax in other chunks): max abs diff <= 2^-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import dataclasses

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as j_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config as t_config
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.models.config import ModelConfig

ARCH = "bitnet-b1.58-2b"
TOL_JAX = 2.0 ** -4
TOL_CHUNKED = 2.0 ** -5


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


@pytest.fixture(scope="module")
def served():
    jcfg = j_smoke(ARCH)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(1)), jcfg)
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    return js, ts


def _chunks(prompt, C):
    """(tokens [1, C], positions [1, C], take) per chunk, padded as the
    engines pad them."""
    out = []
    for start, valid in tdecode.prefill_chunks_of(len(prompt), C):
        toks = np.ones((1, C), np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        pos = np.full((1, C), -1, np.int32)
        pos[0, :valid] = np.arange(start, start + valid)
        out.append((toks, pos, valid - 1))
    return out


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    """The reference's chunk and decode steps, compiled once per config."""
    return (jax.jit(lambda p, c, t, pos, take: jdecode.prefill_chunk(
                p, jcfg, c, t, pos, take)),
            jax.jit(lambda p, c, t, i: jdecode.decode_step(p, jcfg, c, t, i)))


def _teacher_forced(js, ts, jcfg, tcfg, prompt, forced, C, s_max):
    """Per-step logits of chunked prefill then decode on the same tokens,
    through both packages.  Returns (jax [steps, V], port [steps, V], jax
    cache, port cache)."""
    jchunk, jstep = _jax_fns(jcfg)
    tp = tdecode.bind_serving_weights(ts, tcfg)
    jc = jdecode.init_cache(jcfg, 1, s_max)
    tc = tdecode.init_cache(tcfg, 1, s_max, device="cpu")
    jl, tl = [], []
    for toks, pos, take in _chunks(prompt, C):
        jc, jlog = jchunk(js, jc, jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(take, jnp.int32))
        tc, tlog = tdecode.prefill_chunk(tp, tcfg, tc, torch.from_numpy(toks).long(),
                                         torch.from_numpy(pos), take)
    jl.append(np.asarray(jlog[0]))
    tl.append(tlog[0].numpy())
    for i, tok in enumerate(forced):
        idx = np.asarray([len(prompt) + i], np.int32)
        jlog, jc = jstep(js, jc, jnp.asarray([tok], jnp.int32), jnp.asarray(idx))
        tlog, tc = tdecode.decode_step(tp, tcfg, tc, torch.tensor([tok]),
                                       torch.from_numpy(idx))
        jl.append(np.asarray(jlog[0]))
        tl.append(tlog[0].numpy())
    return np.stack(jl), np.stack(tl), jc, tc


@pytest.mark.parametrize("policy", [
    "auto", "fixed:lut_gather", "fixed:tl2", "fixed:lut_onehot",
    "fixed:dequant_packed", "fixed:signflip"])
def test_chunked_prefill_and_decode_logits_match_jax(served, policy):
    js, ts = served
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH).with_(matmul_policy=policy)
    rng = np.random.default_rng(3)
    prompt = rng.integers(2, jcfg.vocab_size, size=13)
    forced = rng.integers(2, jcfg.vocab_size, size=5)
    jl, tl, jc, tc = _teacher_forced(js, ts, jcfg, tcfg, prompt, forced,
                                     C=8, s_max=32)
    assert tl.shape == jl.shape == (6, jcfg.padded_vocab)
    assert np.abs(tl - jl).max() <= TOL_JAX
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    kdiff = np.abs(tc["k"].float().numpy() - np.asarray(jc["k"].astype(jnp.float32)))
    assert kdiff.max() <= TOL_JAX


def test_ring_occupancy_is_position_mod_cache_len(served):
    """A sliding window makes the cache a ring of CL slots: after a prompt
    and decode steps that wrap it, slot s holds the newest position p with
    p % CL == s, in the port as in the reference."""
    js, ts = served
    jcfg = j_smoke(ARCH).with_(window=8)
    tcfg = t_smoke(ARCH).with_(window=8)
    rng = np.random.default_rng(4)
    prompt = rng.integers(2, jcfg.vocab_size, size=11)
    forced = rng.integers(2, jcfg.vocab_size, size=6)
    jl, tl, jc, tc = _teacher_forced(js, ts, jcfg, tcfg, prompt, forced,
                                     C=4, s_max=32)
    CL = tdecode.cache_len(tcfg, 32)
    assert CL == 8 and tc["pos"].shape == (tcfg.n_layers, 1, CL)
    last = len(prompt) + len(forced) - 1
    want = np.asarray([max(p for p in range(last + 1) if p % CL == s)
                       for s in range(CL)])
    assert (tc["pos"].numpy() == want).all()
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert np.abs(tl - jl).max() <= TOL_JAX


@pytest.mark.parametrize("window,plen", [(0, 19), (8, 19), (8, 5)])
def test_chunked_prefill_matches_whole_prefill(served, window, plen):
    _, ts = served
    tcfg = t_smoke(ARCH).with_(window=window)
    tp = tdecode.bind_serving_weights(ts, tcfg)
    prompt = np.random.default_rng(5).integers(2, tcfg.vocab_size, size=plen)
    whole, wlog = tdecode.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)[None]},
                                  s_max=32)
    cache = tdecode.init_cache(tcfg, 1, 32, device="cpu")
    for toks, pos, take in _chunks(prompt, 4):
        cache, clog = tdecode.prefill_chunk(tp, tcfg, cache,
                                            torch.from_numpy(toks).long(),
                                            torch.from_numpy(pos), take)
    assert torch.equal(cache["pos"], whole["pos"])
    assert float((cache["k"].float() - whole["k"].float()).abs().max()) <= TOL_CHUNKED
    assert float((cache["v"].float() - whole["v"].float()).abs().max()) <= TOL_CHUNKED
    assert float((clog - wlog).abs().max()) <= TOL_CHUNKED


def test_dead_row_writes_nothing(served):
    _, ts = served
    tcfg = t_smoke(ARCH)
    tp = tdecode.bind_serving_weights(ts, tcfg)
    cache = tdecode.init_cache(tcfg, 2, 16, device="cpu")
    g = torch.Generator().manual_seed(6)
    cache["k"].normal_(generator=g)
    cache["v"].normal_(generator=g)
    cache["pos"][:, :, :5] = torch.arange(5, dtype=torch.int32)
    before = {k: v.clone() for k, v in cache.items()}
    logits, cache = tdecode.decode_step(tp, tcfg, cache, torch.tensor([3, 4]),
                                        torch.tensor([-1, 5], dtype=torch.int32))
    assert logits.shape == (2, tcfg.padded_vocab)
    for name in ("k", "v", "pos"):
        assert torch.equal(cache[name][:, 0], before[name][:, 0]), name
    assert (cache["pos"][:, 1, 5] == 5).all()
    assert not torch.equal(cache["k"][:, 1, 5], before["k"][:, 1, 5])
    # a position past a dense cache's end drops as well
    _, cache = tdecode.decode_step(tp, tcfg, cache, torch.tensor([3, 4]),
                                   torch.tensor([16, 16], dtype=torch.int32))
    assert (cache["pos"] < 16).all()


@pytest.mark.parametrize("batch,seq_len", [(1, 1), (4, 1), (1, 32), (3, 7)])
def test_layer_matmul_shapes_match_jax_at_full_size(batch, seq_len):
    """Pure shape arithmetic, so full-size bitnet-b1.58-2b costs nothing."""
    jcfg, tcfg = j_config(ARCH), t_config(ARCH)
    assert tdecode.layer_matmul_problems(tcfg, batch, seq_len) == \
        jdecode.layer_matmul_problems(jcfg, batch, seq_len)
    assert tdecode.layer_matmul_shapes(tcfg, batch, seq_len) == \
        jdecode.layer_matmul_shapes(jcfg, batch, seq_len)


#: the reference's archs built from attention blocks (dense, MoE's dense
#: projections, the vision and encoder-decoder stubs)
ATTN_ARCHS = sorted(n for n, c in J_ARCHS.items() if c.block_pattern == "attn")


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_layer_matmul_shapes_match_jax_for_reduced_attention_archs(arch):
    """The port's copy of the shape arithmetic on each attention arch's
    reduced config (built field for field from the reference's)."""
    jcfg = j_smoke(arch)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    for batch, seq_len in ((2, 1), (1, 8)):
        assert tdecode.layer_matmul_shapes(tcfg, batch, seq_len) == \
            jdecode.layer_matmul_shapes(jcfg, batch, seq_len)


@pytest.mark.parametrize("arch", sorted(n for n, c in J_ARCHS.items()
                                        if c.block_pattern != "attn"))
def test_layer_matmul_shapes_refuse_families_not_ported(arch):
    """The name is kept from when these families were refused; since they
    are ported, their shapes equal the reference's."""
    jcfg = j_smoke(arch)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    for batch, seq_len in ((2, 1), (1, 8)):
        assert tdecode.layer_matmul_problems(tcfg, batch, seq_len) == \
            jdecode.layer_matmul_problems(jcfg, batch, seq_len)
        assert tdecode.layer_matmul_shapes(tcfg, batch, seq_len) == \
            jdecode.layer_matmul_shapes(jcfg, batch, seq_len)
