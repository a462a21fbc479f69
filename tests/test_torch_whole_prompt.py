"""Whole-prompt admission and the generational ``run()`` of the port's
engine against the JAX package's.

zamba2 (smoke config, 4 layers, a shared block after every 2nd) and xlstm
(smoke config) admit each request through one single-row ``prefill``
(``_admit_whole``) spliced into the live batch, recurrent states
included.  ``serve()`` runs more requests than slots, so refilled slots
decode from spliced states, and its streams are held to the JAX engine's
by canonical greedy (argmax over bf16-rounded logits) and the margin rule:
the port's logits, teacher-forced on the JAX stream, within ``TOL`` of the
JAX logits at every step, and the streams equal up to the first step where
the JAX logits' top-2 margin is below ``TOL``.

``TOL = 2^-3``: the trits are exact on both sides, but XLA keeps f32
between the fused elementwise ops of each Mamba2, mLSTM and sLSTM block
(conv, gates, norms) where the port rounds every op to bf16 as written;
through every layer the logits (magnitude < 4) move by up to 0.06 at these
configs.

xlstm prompts longer than 64 tokens are held to the JAX package's own
step-by-step recurrence (the prompt fed one token at a time through its
``decode_step`` from ``init_cache``): the reference's prefill steps padded
positions there, which the port deliberately does not
(``repro_torch.models.xlstm``).

``run()`` is held to the JAX engine's ``run()`` on bitnet-b1.58-2b and
zamba2 by the same rule, teacher-forced through one batched prefill of
the left-padded prompts and decode steps at a shared position.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import ContinuousScheduler

ZAMBA = "zamba2-2.7b"
XLSTM = "xlstm-125m"
BITNET = "bitnet-b1.58-2b"
OVERRIDES = {ZAMBA: dict(n_layers=4, attn_every=2)}
TOL = 2.0 ** -3
MAX_LEN = 96
NEW_TOKENS = 6
#: prompt lengths per arch: four through two slots; xlstm's 70 crosses
#: the reference's 64-step sLSTM chunk
LENGTHS = {ZAMBA: [3, 11, 17, 6], XLSTM: [3, 70, 17, 6]}


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def cfgs(arch):
    kw = OVERRIDES.get(arch, {})
    return j_smoke(arch, **kw), t_smoke(arch, **kw)


def _trees(arch, seed=2):
    jcfg, _ = cfgs(arch)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(seed)), jcfg)
    return js, from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")


def _prompts(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, size=n).tolist() for n in lengths]


def _top2_margin(logits: np.ndarray) -> np.ndarray:
    r = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    top = np.sort(r, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _greedy(logits) -> int:
    return int(jnp.argmax(jnp.asarray(logits).astype(jnp.bfloat16)))


class _JaxForced:
    """JAX logits before each token of a stream, teacher-forced: a batched
    prefill of the left-padded prompts (or, ``stepwise``, the prompts fed
    one token at a time through ``decode_step``), then one decode step per
    stream token at a shared position, through the JAX engine's own
    compiled prefill and step."""

    def __init__(self, jeng):
        self.jcfg = jeng.cfg
        self.prefill = jeng._prefill
        self.step = jeng._step

    def start(self, js, toks, stepwise=False):
        if not stepwise:
            cache, logits = self.prefill(js, {"tokens": jnp.asarray(
                toks, jnp.int32)})
            return cache, logits
        cache = jdecode.init_cache(self.jcfg, toks.shape[0], MAX_LEN)
        for i in range(toks.shape[1]):
            logits, cache = self.step(js, cache, jnp.asarray(toks[:, i],
                                                             jnp.int32),
                                      jnp.asarray(i, jnp.int32))
        return cache, logits

    def __call__(self, js, toks, streams, stepwise=False, greedy_steps=0):
        """``[B, T, V]`` logits along ``streams`` (``[B, T]`` token lists);
        with ``greedy_steps`` the stream is the JAX greedy one instead,
        returned with the logits."""
        cache, logits = self.start(js, np.asarray(toks), stepwise)
        out, pos = [np.asarray(logits)], toks.shape[1] - 1
        T = greedy_steps or len(streams[0])
        made = [[] for _ in range(toks.shape[0])]
        for t in range(T - 1):
            if greedy_steps:
                tok = [_greedy(row) for row in out[-1]]
                for m, x in zip(made, tok):
                    m.append(x)
            else:
                tok = [s[t] for s in streams]
            pos += 1
            logits, cache = self.step(js, cache, jnp.asarray(tok, jnp.int32),
                                      jnp.asarray(pos, jnp.int32))
            out.append(np.asarray(logits))
        if greedy_steps:
            for m, row in zip(made, out[-1]):
                m.append(_greedy(row))
        logits = np.stack(out, 1)
        return (made, logits) if greedy_steps else logits


def _port_forced(eng, toks, streams):
    cache, logits = tdecode.prefill(eng.params, eng.cfg, {
        "tokens": torch.from_numpy(np.asarray(toks, np.int64))}, MAX_LEN)
    out, pos = [logits.numpy()], toks.shape[1] - 1
    for t in range(len(streams[0]) - 1):
        pos += 1
        logits, cache = tdecode.decode_step(
            eng.params, eng.cfg, cache,
            torch.tensor([s[t] for s in streams]), pos)
        out.append(logits.numpy())
    return np.stack(out, 1)


def _assert_margin_rule(port_out, jax_out, jax_logits):
    margin = _top2_margin(jax_logits)
    for t, (a, b) in enumerate(zip(port_out, jax_out)):
        if a != b:
            assert margin[t] < TOL, (t, a, b, margin[t])
            return


def _port_engine(ts, tcfg, batch_size=2, **kw):
    return tengine.DecodeEngine(
        ts, tcfg, batch_size=batch_size, max_len=MAX_LEN, device="cpu",
        sampler=tengine.SamplerConfig(canonical_greedy=True), **kw)


def _jax_engine(js, jcfg, batch_size=2):
    return jengine.DecodeEngine(
        js, jcfg, batch_size=batch_size, max_len=MAX_LEN,
        sampler=jengine.SamplerConfig(canonical_greedy=True))


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_serve_matches_the_jax_engine_through_whole_prompt_admission(arch):
    jcfg, tcfg = cfgs(arch)
    js, ts = _trees(arch)
    prompts = _prompts(LENGTHS[arch])
    jreqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
             for p in prompts]
    jeng = _jax_engine(js, jcfg)
    jeng.serve(jreqs)
    eng = _port_engine(ts, tcfg)
    assert not eng.chunked_admission
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    sched = ContinuousScheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    forced = _JaxForced(jeng)
    for prompt, r, jr in zip(prompts, reqs, jreqs):
        assert r.done and len(r.out) == NEW_TOKENS
        toks = np.asarray([prompt])
        if arch == XLSTM and len(prompt) > 64:
            made, jl = forced(js, toks, None, stepwise=True,
                              greedy_steps=NEW_TOKENS)
            jstream = made[0]
        else:
            jstream = jr.out
            jl = forced(js, toks, [jstream])
        tl = _port_forced(eng, toks, [jstream])
        assert np.abs(tl - jl).max() <= TOL, (len(prompt),
                                             np.abs(tl - jl).max())
        _assert_margin_rule(r.out, jstream, jl[0])


@pytest.mark.parametrize("arch,lengths", [(BITNET, [5, 9, 9]),
                                          (ZAMBA, [6, 11, 11])])
def test_run_matches_the_jax_engine_run(arch, lengths):
    """Three requests in four slots (a padding row rides along), the
    shorter prompt left-padded."""
    jcfg, tcfg = cfgs(arch)
    js, ts = _trees(arch, seed=5)
    prompts = _prompts(lengths, seed=11)
    jreqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
             for p in prompts]
    jeng = _jax_engine(js, jcfg, batch_size=4)
    jeng.run(jreqs)
    eng = _port_engine(ts, tcfg, batch_size=4)
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    assert eng.run(reqs) is reqs
    plen = max(lengths)
    toks = np.full((4, plen), tengine.PAD_TOKEN, np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    jstreams = [r.out for r in jreqs] + [[tengine.PAD_TOKEN] * NEW_TOKENS]
    jl = _JaxForced(jeng)(js, toks, jstreams)
    tl = _port_forced(eng, toks, jstreams)
    assert np.abs(tl[:3] - jl[:3]).max() <= TOL
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        assert r.done and jr.done and len(r.out) == NEW_TOKENS
        _assert_margin_rule(r.out, jr.out, jl[i])


def test_run_equals_serve_for_prompts_of_one_length():
    """With every prompt the same length nothing is padded: ``run()`` and
    ``serve()`` compute the same rows, and their streams agree by the
    margin rule on the port's own logits."""
    _, tcfg = cfgs(ZAMBA)
    _, ts = _trees(ZAMBA)
    prompts = _prompts([8, 8, 8])
    eng = _port_engine(ts, tcfg, batch_size=3)
    a = eng.run([tengine.Request(prompt=p, max_new_tokens=5) for p in prompts])
    b = eng.serve([tengine.Request(prompt=p, max_new_tokens=5)
                   for p in prompts])
    logits = _port_forced(eng, np.asarray(prompts), [r.out for r in a])
    for i, (x, y) in enumerate(zip(a, b)):
        _assert_margin_rule(y.out, x.out, logits[i])


def test_whole_prompt_admission_commits_in_one_call_and_splices_states():
    _, tcfg = cfgs(XLSTM)
    _, ts = _trees(XLSTM)
    eng = _port_engine(ts, tcfg)
    state = eng.sched_start()
    before = {k: v.clone() for k, v in state["cache"].items()}
    req = tengine.Request(prompt=_prompts([9])[0], max_new_tokens=3)
    state, pending = eng.sched_admit_start(state, 1, req)
    assert pending is None and bool(state["live"][1]) and \
        not bool(state["live"][0])
    one, logits = tdecode.prefill(eng.params, tcfg, {"tokens": torch.tensor(
        [req.prompt])}, MAX_LEN)
    assert torch.equal(state["logits"][1], logits[0])
    for name, leaf in state["cache"].items():
        assert torch.equal(leaf[:, 1], one[name][:, 0]), name
        assert torch.equal(leaf[:, 0], before[name][:, 0]), name


def test_prefix_cache_on_a_whole_prompt_arch_warns_and_stays_off(caplog):
    _, tcfg = cfgs(ZAMBA)
    _, ts = _trees(ZAMBA)
    with caplog.at_level(logging.WARNING, logger="repro_torch.serving.engine"):
        eng = _port_engine(ts, tcfg, prefix_cache=True)
    assert eng.prefix_store is None
    assert "prefix reuse disabled" in caplog.text


def test_a_draft_for_a_whole_prompt_target_is_refused():
    _, tcfg = cfgs(ZAMBA)
    _, ts = _trees(ZAMBA)
    with pytest.raises(ValueError, match="does not support"):
        _port_engine(ts, tcfg, draft=(ts, tcfg))


def test_zamba2_engine_refuses_a_prompt_shorter_than_the_conv_state():
    _, tcfg = cfgs(ZAMBA)
    _, ts = _trees(ZAMBA)
    eng = _port_engine(ts, tcfg)
    with pytest.raises(ValueError, match="ssm_conv - 1"):
        eng.serve([tengine.Request(prompt=[5, 6], max_new_tokens=2)])


@pytest.mark.parametrize("S", [5, 21, 40])
def test_prefill_chunked_equals_prefill_on_bitnet(S):
    """Within the port, chunked and whole prefill differ only in how the
    attention's online softmax is partitioned: max abs diff 2^-5 on the
    logits, and the caches within 2^-5 of their largest magnitude (the
    positions equal)."""
    _, tcfg = cfgs(BITNET)
    _, ts = _trees(BITNET)
    tb = tdecode.bind_serving_weights(ts, tcfg)
    toks = torch.from_numpy(np.asarray(_prompts([S, S])))
    cw, lw = tdecode.prefill(tb, tcfg, {"tokens": toks}, 48)
    cc, lc = tdecode.prefill_chunked(tb, tcfg, {"tokens": toks}, 48, chunk=8)
    assert float((lw - lc).abs().max()) <= 2.0 ** -5
    assert torch.equal(cw["pos"], cc["pos"])
    for name in ("k", "v"):
        err = float((cw[name].float() - cc[name].float()).abs().max())
        assert err <= 2.0 ** -5 * float(cw[name].float().abs().max()), name


@pytest.mark.parametrize("arch,discipline", [(ZAMBA, "generational"),
                                             (XLSTM, "continuous"),
                                             (ZAMBA, "continuous")])
def test_serve_launcher_serves_the_recurrent_families(arch, discipline,
                                                      capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--requests", "2", "--new-tokens", "3",
                       "--discipline", discipline])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert f"[serve] {discipline}: 6 tokens" in capsys.readouterr().out
