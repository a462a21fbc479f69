"""whisper-large-v3 (encoder-decoder with cross-attention, the
``audio_stub`` frontend) and internvl2-2b (the ``vit_stub`` frontend's
vision prefix) in the port against the JAX package, at their smoke configs
(whisper: 4 decoder and 2 encoder layers, ``enc_seq`` 16; internvl2: 4
layers, 8 vision tokens), on the same converted serving weights and seeded
numpy inputs.

The encoder alone, prefill and decode-step logits (with seeded non-zero
frames and vision embeddings) are held to the JAX package's compiled
functions within ``TOL = 2^-4``, the port's serving tolerance against
compiled JAX (XLA keeps f32 between fused elementwise ops where the port
rounds each op to bf16).  The engines' canonical-greedy streams, through
``serve()`` (whole-prompt admission, more requests than slots) and
``run()``, are held to the JAX engine's by the margin rule: the port's
logits teacher-forced on the JAX stream within ``STREAM_TOL`` of the JAX
logits, and the streams equal up to the first step where the JAX logits'
top-2 margin is below ``STREAM_TOL``.  That is ``TOL`` for whisper and
2^-3 for internvl2: with the engine's zero vision embeddings the first 8
positions carry zero hidden states through every layer, and there the
compiled JAX logits move up to 0.105 from the same functions run op by op,
which the port equals (0.0 at prefill, 0.016 over four decode steps).
One JAX engine per arch is shared by the module, so each compiled trace is
made once.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import ContinuousScheduler

WHISPER = "whisper-large-v3"
VLM = "internvl2-2b"
ARCHS = [WHISPER, VLM]
TOL = 2.0 ** -4
STREAM_TOL = {WHISPER: TOL, VLM: 2.0 ** -3}
MAX_LEN = 48
NEW_TOKENS = 5
B = 2
#: serve(): three requests through two slots (each length one JAX trace)
SERVE_LENGTHS = [9, 12, 9]
#: run() and the logits test: the batch's padded length
RUN_LENGTHS = [9, 12]


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _init_and_pack(key, jcfg):
    """The reference's params and their serving tree, in one compiled call
    (the same bytes as eager, several times faster)."""
    jp = jmodel.init_params(jcfg, key)
    return jp, jdecode.quantize_for_serving(jp, jcfg)


class Family:
    """One arch's configs, JAX params and serving trees, the port's tree,
    and one canonical-greedy JAX engine (batch 2) whose compiled prefill
    and step every test of the arch reuses."""

    def __init__(self, arch):
        self.jcfg, self.tcfg = j_smoke(arch), t_smoke(arch)
        self.jp, self.js = jax.jit(_init_and_pack, static_argnums=1)(
            jax.random.PRNGKey(3), self.jcfg)
        self.ts = from_numpy_tree(jax.tree.map(np.asarray, self.js), "cpu")
        self.jeng = jengine.DecodeEngine(
            self.js, self.jcfg, batch_size=B, max_len=MAX_LEN,
            sampler=jengine.SamplerConfig(canonical_greedy=True))

    def port_engine(self, **kw):
        return tengine.DecodeEngine(
            self.ts, self.tcfg, batch_size=B, max_len=MAX_LEN, device="cpu",
            sampler=tengine.SamplerConfig(canonical_greedy=True), **kw)

    def stub(self, rows, seed=None):
        """The frontend input for ``rows`` rows: the engine's zeros, or
        seeded normal values (bf16) as numpy f32."""
        c = self.jcfg
        n = c.enc_seq if c.frontend == "audio_stub" else c.vision_tokens
        shape = (rows, n, c.d_model)
        if seed is None:
            return np.zeros(shape, np.float32)
        a = np.random.default_rng(seed).standard_normal(shape)
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    def batches(self, toks, stub):
        key = "frames" if self.jcfg.frontend == "audio_stub" else \
            "vision_embeds"
        jb = {"tokens": jnp.asarray(toks, jnp.int32),
              key: jnp.asarray(stub, jnp.bfloat16)}
        tb = {"tokens": torch.from_numpy(np.asarray(toks, np.int64)),
              key: torch.from_numpy(stub).to(torch.bfloat16)}
        return jb, tb


@pytest.fixture(scope="module")
def families():
    return {}


def family(families, arch) -> Family:
    if arch not in families:
        families[arch] = Family(arch)
    return families[arch]


def _prompts(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, size=n).tolist() for n in lengths]


def _left_padded(prompts):
    plen = max(len(p) for p in prompts)
    toks = np.full((len(prompts), plen), tengine.PAD_TOKEN, np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


def _forced(fam, toks, stub, streams):
    """``(jax, port)`` logits ``[B, T, V]`` before each token of
    ``streams``: one prefill of ``toks`` with the frontend input ``stub``,
    then a decode step per stream token at a shared position, through the
    JAX engine's compiled prefill and step and the port's functions."""
    jb, tb = fam.batches(toks, stub)
    jc, jl = fam.jeng._prefill(fam.js, jb)
    tp = tdecode.bind_serving_weights(fam.ts, fam.tcfg)
    tc, tl = tdecode.prefill(tp, fam.tcfg, tb, MAX_LEN)
    jout, tout, pos = [np.asarray(jl)], [tl.numpy()], toks.shape[1] - 1
    for t in range(len(streams[0]) - 1):
        pos += 1
        tok = [s[t] for s in streams]
        jl, jc = fam.jeng._step(fam.js, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tdecode.decode_step(tp, fam.tcfg, tc, torch.tensor(tok),
                                     pos)
        jout.append(np.asarray(jl))
        tout.append(tl.numpy())
    return np.stack(jout, 1), np.stack(tout, 1)


def _top2_margin(logits: np.ndarray) -> np.ndarray:
    r = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    top = np.sort(r, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _assert_margin_rule(port_out, jax_out, jax_logits, tol):
    margin = _top2_margin(jax_logits)
    for t, (a, b) in enumerate(zip(port_out, jax_out)):
        if a != b:
            assert margin[t] < tol, (t, a, b, margin[t])
            return


def test_whisper_encoder_matches_jax(families):
    fam = family(families, WHISPER)
    frames = fam.stub(B, seed=11)
    want = np.asarray(jax.jit(lambda p, f: jmodel._whisper_encode(
        p, fam.jcfg, f))(fam.js, jnp.asarray(frames, jnp.bfloat16)).astype(
            jnp.float32))
    tp = tdecode.bind_serving_weights(fam.ts, fam.tcfg)
    got = tmodel.whisper_encode(tp, fam.tcfg, torch.from_numpy(frames).to(
        torch.bfloat16)).float().numpy()
    assert got.shape == (B, fam.tcfg.enc_seq, fam.tcfg.d_model)
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(families, arch):
    """Seeded non-zero frames (so the encoder works beyond its positions)
    or vision embeddings; the cross K/V and the self-attention ring
    written by prefill carry the decode steps."""
    fam = family(families, arch)
    toks = _left_padded(_prompts(RUN_LENGTHS, seed=5))
    streams = _prompts([NEW_TOKENS] * B, seed=6)
    jl, tl = _forced(fam, toks, fam.stub(B, seed=13), streams)
    assert np.isfinite(tl).all()
    assert np.abs(tl - jl).max() <= TOL, np.abs(tl - jl).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_streams_match_the_jax_engine(families, arch):
    fam = family(families, arch)
    prompts = _prompts(SERVE_LENGTHS)
    jreqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
             for p in prompts]
    fam.jeng.serve(jreqs)
    eng = fam.port_engine()
    assert not eng.chunked_admission
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    sched = ContinuousScheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    for prompt, r, jr in zip(prompts, reqs, jreqs):
        assert r.done and len(r.out) == NEW_TOKENS
        jl, tl = _forced(fam, np.asarray([prompt]), fam.stub(1), [jr.out])
        tol = STREAM_TOL[arch]
        assert np.abs(tl - jl).max() <= tol, np.abs(tl - jl).max()
        _assert_margin_rule(r.out, jr.out, jl[0], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_streams_match_the_jax_engine_run(families, arch):
    """Two requests of different lengths: the shorter is left-padded, and
    a VLM's vision prefix lands on the padded batch's first positions."""
    fam = family(families, arch)
    prompts = _prompts(RUN_LENGTHS, seed=9)
    jreqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
             for p in prompts]
    fam.jeng.run(jreqs)
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    assert fam.port_engine().run(reqs) is reqs
    jl, tl = _forced(fam, _left_padded(prompts), fam.stub(B),
                     [r.out for r in jreqs])
    tol = STREAM_TOL[arch]
    assert np.abs(tl - jl).max() <= tol, np.abs(tl - jl).max()
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        assert r.done and jr.done and len(r.out) == NEW_TOKENS
        _assert_margin_rule(r.out, jr.out, jl[i], tol)


def test_vlm_prompt_shorter_than_the_vision_prefix_is_refused(families):
    """The reference fails inside ``dynamic_update_slice`` (a TypeError);
    the port raises a ValueError naming the limit, in ``serve()`` for
    each prompt and in ``run()`` for the padded length."""
    fam = family(families, VLM)
    nv = fam.tcfg.vision_tokens
    assert tdecode.min_prompt_len(fam.tcfg) == nv
    eng = fam.port_engine()
    with pytest.raises(ValueError, match="vision_tokens"):
        eng.serve([tengine.Request(prompt=list(range(2, nv + 1)),
                                   max_new_tokens=2)])
    with pytest.raises(ValueError, match="vision_tokens"):
        eng.run([tengine.Request(prompt=[3, 4], max_new_tokens=2),
                 tengine.Request(prompt=list(range(2, nv)),
                                 max_new_tokens=2)])
    # at exactly vision_tokens the whole prompt is the prefix
    out = eng.serve([tengine.Request(prompt=list(range(2, nv + 2)),
                                     max_new_tokens=2)])
    assert out[0].done and len(out[0].out) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_store_stays_off_and_a_draft_is_refused(families, arch,
                                                       caplog):
    fam = family(families, arch)
    with caplog.at_level(logging.WARNING, logger="repro_torch.serving.engine"):
        eng = fam.port_engine(prefix_cache=True)
    assert eng.prefix_store is None
    assert "prefix reuse disabled" in caplog.text
    with pytest.raises(ValueError, match="does not support"):
        fam.port_engine(draft=(fam.ts, fam.tcfg))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_converter_and_packing_carry_whisper_trees_byte_for_byte(families):
    """``enc_blocks``, ``dec_blocks`` (``self_attn``, ``cross_attn``) and
    ``enc_norm`` cross the converter both ways byte for byte, and the
    port's ``quantize_for_serving`` packs the converted bf16 tree to the
    reference's bytes."""
    fam = family(families, WHISPER)
    jp = jax.tree.map(np.asarray, fam.jp)
    js = jax.tree.map(np.asarray, fam.js)
    for tree in (jp, js):
        want, got = dict(_leaves(tree)), dict(
            _leaves(to_numpy_tree(from_numpy_tree(tree, "cpu"))))
        assert got.keys() == want.keys()
        assert {p[0] for p in want} >= {"enc_blocks", "dec_blocks",
                                        "enc_norm"}
        assert ("dec_blocks", "cross_attn", "wk", "packed") in dict(
            _leaves(js))
        for path, a in want.items():
            assert _bits(got[path]).tobytes() == _bits(a).tobytes(), path
    packed = to_numpy_tree(tdecode.quantize_for_serving(
        from_numpy_tree(jp, "cpu"), fam.tcfg))
    want, got = dict(_leaves(js)), dict(_leaves(packed))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert _bits(got[path]).tobytes() == _bits(a).tobytes(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_by_layer_serving_init_packs_the_whole_tree(arch):
    """``init_serving_params`` draws the same weights as ``init_params``
    and packs them to the same bytes, one layer at a time; its cache has
    the reference's leaves and shapes."""
    cfg = t_smoke(arch)
    whole = tdecode.quantize_for_serving(
        tmodel.init_params(cfg, torch.Generator().manual_seed(4), "cpu"), cfg)
    layered = tdecode.init_serving_params(
        cfg, torch.Generator().manual_seed(4), "cpu")
    a, b = dict(_leaves(to_numpy_tree(whole))), dict(
        _leaves(to_numpy_tree(layered)))
    assert a.keys() == b.keys()
    for path, x in a.items():
        assert x.dtype == b[path].dtype and np.array_equal(x, b[path]), path
    jc = jdecode.init_cache(j_smoke(arch), 3, MAX_LEN)
    tc = tdecode.init_cache(cfg, 3, MAX_LEN, device="cpu")
    assert {k: tuple(v.shape) for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}


def test_serve_launcher_serves_whisper_and_internvl2(capsys):
    from repro_torch.launch import serve

    for arch in ARCHS:
        reqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--requests", "3",
                           "--new-tokens", "3"])
        assert all(r.done and len(r.out) == 3 for r in reqs)
    assert capsys.readouterr().out.count("[serve] continuous: 9 tokens") == 2
