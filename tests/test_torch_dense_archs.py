"""The dense attention archs qwen3-0.6b (qk_norm, head_dim 128 over
d_model 1024, tied embeddings), gemma-7b (GeGLU with the tanh GELU,
RMSNorm(1+w), scaled embeddings, head_dim 256, tied), qwen2.5-14b (QKV
bias) and yi-34b (llama-style GQA) in the port against the JAX package,
at their smoke configs (4 layers, d_model 128; each flag kept), on the
same converted serving weights and seeded numpy inputs.

Prefill and decode-step logits are held to the JAX package's compiled
functions within ``TOL = 2^-4``, the port's serving tolerance against
compiled JAX (measured 0.007–0.034 at these configs).  qwen3's engine,
through chunked admission, is held to the JAX engine's canonical-greedy
streams by the margin rule: the port's logits teacher-forced on the JAX
stream (chunk by chunk, then a decode step a token) within ``TOL`` of the
JAX logits, and the streams equal up to the first step where the JAX
logits' top-2 margin is below ``TOL``.
"""

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
from repro.serving import engine as jengine
from repro_torch.configs.registry import get_config as t_config
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import ContinuousScheduler

DENSE = ["qwen3-0.6b", "gemma-7b", "qwen2.5-14b", "yi-34b"]
TOL = 2.0 ** -4
MAX_LEN = 48
CHUNK = 8
NEW_TOKENS = 5


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _trees(arch, seed=3):
    """(JAX serving tree, the port's converted one), the reference's init
    and packing in one compiled call."""
    jcfg = j_smoke(arch)
    js = jax.jit(lambda k: jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, k), jcfg))(jax.random.PRNGKey(seed))
    return js, from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")


def _prompts(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("arch", DENSE + ["whisper-large-v3",
                                          "internvl2-2b"])
def test_port_configs_are_the_reference_configs(arch):
    assert t_config(arch).__dict__ == j_config(arch).__dict__
    assert t_smoke(arch).__dict__ == j_smoke(arch).__dict__
    assert t_config(arch.replace("-", "_").replace(".", "p")).name == arch


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits_match_jax(arch):
    """Two left-padded prompts prefilled whole, then four decode steps at
    per-row positions (the rows' positions differ by one, as in a
    continuous batch)."""
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    js, ts = _trees(arch)
    plen = 12
    toks = np.full((2, plen), tengine.PAD_TOKEN, np.int64)
    for i, p in enumerate(_prompts([9, 12], seed=5)):
        toks[i, plen - len(p):] = p
    jc, jl = jax.jit(lambda p, t: jdecode.prefill(p, jcfg, {"tokens": t},
                                                  MAX_LEN))(
        js, jnp.asarray(toks, jnp.int32))
    tp = tdecode.bind_serving_weights(ts, tcfg)
    tc, tl = tdecode.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             MAX_LEN)
    diffs = [float(np.abs(np.asarray(jl) - tl.numpy()).max())]
    step = jax.jit(lambda p, c, t, i: jdecode.decode_step(p, jcfg, c, t, i))
    streams = _prompts([NEW_TOKENS - 1] * 2, seed=6)
    for t in range(NEW_TOKENS - 1):
        index = np.asarray([plen + t, plen + t + 1], np.int32)
        if t == 0:
            index[1] = plen        # both rows start right after the prompt
        tok = [s[t] for s in streams]
        jl, jc = step(js, jc, jnp.asarray(tok, jnp.int32), jnp.asarray(index))
        tl, tc = tdecode.decode_step(tp, tcfg, tc, torch.tensor(tok),
                                     torch.from_numpy(index))
        diffs.append(float(np.abs(np.asarray(jl) - tl.numpy()).max()))
    assert np.isfinite(tl.numpy()).all()
    assert max(diffs) <= TOL, diffs


def _chunks(prompt):
    for start in range(0, len(prompt), CHUNK):
        valid = min(CHUNK, len(prompt) - start)
        toks = np.full((1, CHUNK), tengine.PAD_TOKEN, np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        pos = np.full((1, CHUNK), -1, np.int32)
        pos[0, :valid] = np.arange(start, start + valid)
        yield toks, pos, valid - 1


def test_qwen3_serve_streams_match_the_jax_engine_through_chunks():
    """Three requests through two slots, chunked admission (8-token
    chunks: the 9-, 20- and 5-token prompts take 2, 3 and 1)."""
    arch = "qwen3-0.6b"
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    js, ts = _trees(arch, seed=4)
    prompts = _prompts([9, 20, 5])
    jreqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
             for p in prompts]
    jeng = jengine.DecodeEngine(js, jcfg, batch_size=2, max_len=MAX_LEN,
                                prefill_chunk=CHUNK,
                                sampler=jengine.SamplerConfig(
                                    canonical_greedy=True))
    jeng.serve(jreqs)
    eng = tengine.DecodeEngine(
        ts, tcfg, batch_size=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
        device="cpu", sampler=tengine.SamplerConfig(canonical_greedy=True))
    assert eng.chunked_admission
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    sched = ContinuousScheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert sched.stats.prefill_chunks == 2 + 3 + 1
    # the JAX engine's own compiled chunk (traced by its admissions) and step
    chunk, step = jeng._prefill_chunk_fn, jeng._step
    for prompt, r, jr in zip(prompts, reqs, jreqs):
        assert r.done and len(r.out) == NEW_TOKENS
        jc = jdecode.init_cache(jcfg, 1, MAX_LEN)
        tc = tdecode.init_cache(tcfg, 1, MAX_LEN, device="cpu")
        for toks, pos, take in _chunks(prompt):
            jc, jl = chunk(js, jc, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(take, jnp.int32))
            tc, tl = tdecode.prefill_chunk(eng.params, tcfg, tc,
                                           torch.from_numpy(toks).long(),
                                           torch.from_numpy(pos), take)
        jout, tout = [np.asarray(jl[0])], [tl[0].numpy()]
        for i, tok in enumerate(jr.out[:-1]):
            index = np.asarray([len(prompt) + i], np.int32)
            jl, jc = step(js, jc, jnp.asarray([tok], jnp.int32),
                          jnp.asarray(index))
            tl, tc = tdecode.decode_step(eng.params, tcfg, tc,
                                         torch.tensor([tok]),
                                         torch.from_numpy(index))
            jout.append(np.asarray(jl[0]))
            tout.append(tl[0].numpy())
        jout, tout = np.stack(jout), np.stack(tout)
        assert np.abs(tout - jout).max() <= TOL
        r16 = np.asarray(jnp.asarray(jout).astype(jnp.bfloat16).astype(
            jnp.float32))
        top = np.sort(r16, axis=-1)[..., -2:]
        margin = top[..., 1] - top[..., 0]
        for t, (a, b) in enumerate(zip(r.out, jr.out)):
            if a != b:
                assert margin[t] < TOL, (t, a, b, margin[t])
                break


@pytest.mark.parametrize("arch", DENSE)
def test_serve_launcher_serves_the_dense_archs(arch, capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--requests", "3", "--new-tokens", "2"])
    assert all(r.done and len(r.out) == 2 for r in reqs)
    assert "[serve] continuous: 6 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-2.7b",
                                  "whisper-large-v3", "internvl2-2b"])
def test_plain_path_runs_in_f64_as_the_yardstick(arch):
    """``decode.f64_params`` under ``fixed:ref`` keeps every activation in
    f64 (the logits come out f64) and computes the bf16 model: its logits
    lie within 2^-3 of the bf16 plain path's, which differs only by
    rounding each activation to bf16 (0.073 at zamba2's smoke config, its
    two Mamba2 layers and shared block; under 0.03 at the others)."""
    cfg = t_smoke(arch).with_(matmul_policy="fixed:ref")
    served = tdecode.init_serving_params(cfg, torch.Generator().manual_seed(1),
                                         "cpu")
    toks = torch.from_numpy(np.asarray(_prompts([cfg.vision_tokens + 5])))
    extra = {}
    if cfg.frontend == "audio_stub":
        extra["frames"] = torch.randn((1, cfg.enc_seq, cfg.d_model),
                                      generator=torch.Generator().manual_seed(2)
                                      ).to(torch.bfloat16)
    if cfg.frontend == "vit_stub":
        extra["vision_embeds"] = torch.randn(
            (1, cfg.vision_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    _, bf = tdecode.prefill(served, cfg, {"tokens": toks, **extra}, MAX_LEN)
    cache, f64 = tdecode.prefill(
        tdecode.f64_params(served), cfg,
        {"tokens": toks, **{k: v.double() for k, v in extra.items()}},
        MAX_LEN)
    assert f64.dtype == torch.float64 and torch.isfinite(f64).all()
    assert float((f64 - bf.double()).abs().max()) <= 2.0 ** -3


@pytest.mark.parametrize("policy", [None, "auto", "prior", "fixed:lut_gather",
                                    "fixed:ref"])
def test_f64_activations_run_only_under_fixed_ref(policy):
    """``dispatch.ternary_matmul`` takes an f64 ``x`` (the yardstick's
    activations) only under ``fixed:ref``, where it is the plain product
    in f64; under every other policy it raises rather than pick a path."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 40))).double()
    w = torch.from_numpy(rng.integers(-1, 2, size=(24, 40)).astype(np.int8))
    tw = tdispatch.TernaryWeight.from_ternary(w)
    if policy != "fixed:ref":
        with pytest.raises(ValueError, match="fixed:ref"):
            tdispatch.ternary_matmul(x, tw, policy=policy)
        return
    y = tdispatch.ternary_matmul(x, tw, policy=policy)
    assert y.dtype == torch.float64
    assert torch.equal(y, x @ w.double().T)
