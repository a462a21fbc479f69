"""The port's serving engine against the JAX package's, and the port's
independence from JAX.

The port's ``DecodeEngine`` under its ``ContinuousScheduler`` (policies
``auto``, ``fixed:lut_gather`` and ``fixed:tl2``, whose kernels run their
plain PyTorch versions on the CPU) serves the same requests as the JAX
engine on the same packed parameters under its CPU default (``ref``), both
with canonical greedy selection (argmax over bf16-rounded logits), at a
reduced bitnet-b1.58-2b (4 layers, d_model 128).

Tolerance: per-step logits, teacher-forced on the JAX stream, agree to
max abs diff 2^-4 (the trits are exact on both sides; XLA keeps f32 between
fused elementwise ops where the port rounds each op to bf16, which moves
logits of magnitude < 4 by a few bf16 ulps).  The token streams must then
agree step for step, except at a step where the JAX logits' top-2 margin is
below that tolerance: there the two may pick differently, and the streams
are compared no further.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

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

ARCH = "bitnet-b1.58-2b"
TOL = 2.0 ** -4
REPO = Path(__file__).resolve().parents[1]
PROMPT_LENS = [3, 11, 17, 6]
NEW_TOKENS = 6
CHUNK = 8
MAX_LEN = 48


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(2, 512, size=n).tolist() for n in PROMPT_LENS]


def _chunks(prompt):
    for start, valid in tdecode.prefill_chunks_of(len(prompt), CHUNK):
        toks = np.ones((1, CHUNK), np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        pos = np.full((1, CHUNK), -1, np.int32)
        pos[0, :valid] = np.arange(start, start + valid)
        yield toks, pos, valid - 1


def _jax_forced(jcfg):
    """``forced(js, prompt, stream)``: JAX logits before each emitted token
    (chunked prefill, then one decode step per token of ``stream`` but the
    last), through one compiled chunk and one compiled step."""
    chunk = jax.jit(lambda p, c, t, pos, take: jdecode.prefill_chunk(
        p, jcfg, c, t, pos, take))
    step = jax.jit(lambda p, c, t, i: jdecode.decode_step(p, jcfg, c, t, i))

    def forced(js, prompt, stream) -> np.ndarray:
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


def _port_forced(tp, tcfg, prompt, stream) -> np.ndarray:
    cache = tdecode.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    for toks, pos, take in _chunks(prompt):
        cache, logits = tdecode.prefill_chunk(tp, tcfg, cache,
                                              torch.from_numpy(toks).long(),
                                              torch.from_numpy(pos), take)
    out = [logits[0].numpy()]
    for i, tok in enumerate(stream[:-1]):
        logits, cache = tdecode.decode_step(
            tp, tcfg, cache, torch.tensor([tok]),
            torch.tensor([len(prompt) + i], dtype=torch.int32))
        out.append(logits[0].numpy())
    return np.stack(out)


def _top2_margin(logits: np.ndarray) -> np.ndarray:
    """Gap between the two largest bf16-rounded logits, per row."""
    r = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    top = np.sort(r, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


@pytest.fixture(scope="module")
def jax_served():
    jcfg = j_smoke(ARCH)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(2)), jcfg)
    eng = jengine.DecodeEngine(
        js, jcfg, batch_size=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
        sampler=jengine.SamplerConfig(canonical_greedy=True))
    reqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in _prompts()]
    eng.serve(reqs)
    streams = [r.out for r in reqs]
    run = _jax_forced(jcfg)
    forced = [run(js, p, s) for p, s in zip(_prompts(), streams)]
    return js, streams, forced


@pytest.mark.parametrize("policy", ["auto", "fixed:lut_gather", "fixed:tl2"])
def test_port_engine_matches_jax_engine(jax_served, policy):
    js, jstreams, jforced = jax_served
    tcfg = t_smoke(ARCH)
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    eng = tengine.DecodeEngine(
        ts, tcfg, batch_size=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
        matmul_policy=policy, device="cpu",
        sampler=tengine.SamplerConfig(canonical_greedy=True))
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in _prompts()]
    sched = ContinuousScheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert all(r.done and len(r.out) == NEW_TOKENS for r in reqs)
    for prompt, r, js_out, jl in zip(_prompts(), reqs, jstreams, jforced):
        tl = _port_forced(eng.params, eng.cfg, prompt, js_out)
        assert np.abs(tl - jl).max() <= TOL
        margin = _top2_margin(jl)
        for t, (a, b) in enumerate(zip(r.out, js_out)):
            if a != b:
                assert margin[t] < TOL, (t, a, b, margin[t])
                break


def test_engine_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device exists")
    tcfg = t_smoke(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.DecodeEngine({}, tcfg, batch_size=1, max_len=16)


@pytest.mark.parametrize("kwarg", [{"mesh": object()}, {"prefix_cache": True},
                                   {"draft": object()}])
def test_engine_rejects_features_not_ported(kwarg):
    with pytest.raises(NotImplementedError, match="not ported"):
        tengine.DecodeEngine({}, t_smoke(ARCH), batch_size=1, max_len=16,
                             device="cpu", **kwarg)


def test_generational_run_is_not_ported(jax_served):
    js, _, _ = jax_served
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    eng = tengine.DecodeEngine(ts, t_smoke(ARCH), batch_size=1, max_len=16,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="serve"):
        eng.run([tengine.Request(prompt=[3, 4])])


class _FakeBackend:
    """Deterministic scheduler backend: a prompt of length L admits in
    ceil(L / 4) chunks; slot b emits 100 + its request's index, and a
    request finishes after ``max_new_tokens`` tokens."""

    def __init__(self, batch_size):
        self.batch_size = batch_size
        self.chunk_log: list[int] = []

    def sched_start(self):
        return {"left": [0] * self.batch_size, "tok": [0] * self.batch_size}

    def sched_admit(self, state, slot, request):
        state["left"][slot] = request.max_new_tokens
        state["tok"][slot] = 100 + request.prompt[0]
        return state

    def sched_admit_start(self, state, slot, request):
        return state, {"slot": slot, "request": request,
                       "chunks": -(-len(request.prompt) // 4)}

    def sched_admit_step(self, state, pending):
        self.chunk_log.append(pending["slot"])
        pending["chunks"] -= 1
        if pending["chunks"]:
            return state, pending
        return self.sched_admit(state, pending["slot"], pending["request"]), None

    def sched_step(self, state):
        tokens = list(state["tok"])
        for b in range(self.batch_size):
            state["left"][b] = max(state["left"][b] - 1, 0)
        return state, tokens, [n > 0 for n in state["left"]]


def _fake_requests(lengths, new_tokens):
    return [tengine.Request(prompt=[i] * n, max_new_tokens=t)
            for i, (n, t) in enumerate(zip(lengths, new_tokens))]


@pytest.mark.parametrize("budget", [None, 1, 2])
def test_scheduler_admits_fifo_and_serves_every_request(budget):
    backend = _FakeBackend(2)
    reqs = _fake_requests([3, 9, 1, 5, 12], [2, 1, 3, 0, 2])
    sched = ContinuousScheduler(backend, admission_budget=budget)
    for r in reqs:
        sched.submit(r)
    sched.run(max_steps=100)
    live = [r for r in reqs if r.max_new_tokens > 0]
    assert [r.rid for r in sched.admission_order] == [r.rid for r in live]
    assert all(r.done for r in reqs)
    for i, r in enumerate(reqs):
        assert r.out == [100 + i] * r.max_new_tokens
    assert sched.stats.emitted_tokens == sum(r.max_new_tokens for r in reqs)
    assert sched.stats.prefill_chunks == sum(-(-len(r.prompt) // 4) for r in live)


def test_scheduler_budget_caps_prefill_chunks_per_step():
    backend = _FakeBackend(2)
    sched = ContinuousScheduler(backend, admission_budget=1)
    for r in _fake_requests([4, 16], [8, 2]):
        sched.submit(r)
    per_step = []
    while sched.pending:
        n0 = len(backend.chunk_log)
        sched.step()
        per_step.append(len(backend.chunk_log) - n0)
    assert max(per_step) == 1
    # the short prompt went live after its one chunk in the first step and
    # decoded while the long one was still being admitted, a chunk a step
    assert per_step[:4] == [1, 1, 1, 1]
    assert sched.stats.admission_steps == 0
    assert sched.stats.decode_steps == len(per_step)


def test_scheduler_rejects_a_zero_budget_and_a_finished_request():
    with pytest.raises(ValueError, match="admission_budget"):
        ContinuousScheduler(_FakeBackend(1), admission_budget=0)
    done = tengine.Request(prompt=[1], max_new_tokens=1)
    done.done = True
    with pytest.raises(ValueError, match="completed"):
        ContinuousScheduler(_FakeBackend(1)).submit(done)


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:\.|\s|$|,)",
                     re.MULTILINE)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert offenders == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving.engine, repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
