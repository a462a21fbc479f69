"""The port's serving engine against the JAX package's, and the port's
independence from JAX.

The port's ``DecodeEngine`` under its ``ContinuousScheduler`` serves the
same requests as the JAX engine on the same packed parameters under its CPU
default (``ref``), both with canonical greedy selection (argmax over
bf16-rounded logits), at a reduced bitnet-b1.58-2b (4 layers, d_model 128):
under the prior (``auto`` on an empty autotune cache), autotuned
(``autotune_shapes`` first, then ``auto`` on the measurements) and pinned to
each hand kernel (``fixed:<kernel>``), whose kernels run their plain
PyTorch versions on the CPU; with bf16 activations and with int8
activations (``act_dtype="int8"``, the W1.58A8 path, where ``w2a8`` joins).

Tolerance: per-step logits, teacher-forced on the JAX stream, agree to
max abs diff 2^-4 (the trits are exact on both sides; XLA keeps f32 between
fused elementwise ops where the port rounds each op to bf16, which moves
logits of magnitude < 4 by a few bf16 ulps).  The token streams must then
agree step for step, except at a step where the JAX logits' top-2 margin is
below that tolerance: there the two may pick differently, and the streams
are compared no further.  With int8 activations an activation that the two
trunks round one bf16 ulp apart can quantize to neighbouring int8 codes, a
step of absmax/127 in that input, so the logits move further: max abs diff
2^-3 (0.070 measured at this config).  Among the port's own kernels every
int8 product is an exact integer sum, so their logits are bitwise equal to
the port's ``fixed:ref``.
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
from _torch_threads import one_torch_thread  # noqa: F401

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
TOL_INT8 = 2.0 ** -3
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


def _jax_serve(js, jcfg):
    """The JAX engine's streams and teacher-forced logits on ``js``."""
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


@pytest.fixture(scope="module")
def jax_params():
    jcfg = j_smoke(ARCH)
    return jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(2)), jcfg)


@pytest.fixture(scope="module")
def jax_served(jax_params):
    return _jax_serve(jax_params, j_smoke(ARCH))


@pytest.fixture(scope="module")
def jax_served_int8(jax_params):
    return _jax_serve(jax_params, j_smoke(ARCH).with_(act_dtype="int8"))


def _port_engine(js, tcfg, policy, batch_size=2, prefill_chunk=CHUNK):
    """The port's engine on the JAX tree; ``policy="autotuned"`` measures
    every eligible kernel at the engine's shapes first, then serves under
    ``auto``."""
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    eng = tengine.DecodeEngine(
        ts, tcfg, batch_size=batch_size, max_len=MAX_LEN,
        prefill_chunk=prefill_chunk,
        matmul_policy="auto" if policy == "autotuned" else policy,
        device="cpu", sampler=tengine.SamplerConfig(canonical_greedy=True))
    if policy == "autotuned":
        eng.autotune_shapes(reps=1)
        assert tdispatch.get_autotune_cache().entries
    return eng


def _assert_streams_match(eng, jax_served_result, tol=TOL):
    js, jstreams, jforced = jax_served_result
    reqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in _prompts()]
    sched = ContinuousScheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert all(r.done and len(r.out) == NEW_TOKENS for r in reqs)
    for prompt, r, js_out, jl in zip(_prompts(), reqs, jstreams, jforced):
        tl = _port_forced(eng.params, eng.cfg, prompt, js_out)
        assert np.abs(tl - jl).max() <= tol
        margin = _top2_margin(jl)
        for t, (a, b) in enumerate(zip(r.out, js_out)):
            if a != b:
                assert margin[t] < tol, (t, a, b, margin[t])
                break


@pytest.mark.parametrize("policy", [
    "auto", "fixed:lut_gather", "fixed:tl2", "fixed:lut_onehot",
    "fixed:dequant_packed", "fixed:signflip", "autotuned"])
def test_port_engine_matches_jax_engine(jax_served, policy):
    eng = _port_engine(jax_served[0], t_smoke(ARCH), policy)
    _assert_streams_match(eng, jax_served)


@pytest.mark.parametrize("policy", ["auto", "fixed:w2a8", "fixed:tl2",
                                    "autotuned"])
def test_port_int8_engine_matches_jax_int8_engine(jax_served_int8, policy):
    """W1.58A8 serving against the JAX engine (``TOL_INT8``), and every
    kernel's logits bitwise equal to the port's ``fixed:ref``."""
    tcfg = t_smoke(ARCH).with_(act_dtype="int8")
    eng = _port_engine(jax_served_int8[0], tcfg, policy)
    _assert_streams_match(eng, jax_served_int8, TOL_INT8)
    ref = _port_engine(jax_served_int8[0], tcfg, "fixed:ref")
    prompt, stream = _prompts()[0], jax_served_int8[1][0]
    assert np.array_equal(_port_forced(eng.params, eng.cfg, prompt, stream),
                          _port_forced(ref.params, ref.cfg, prompt, stream))


@pytest.mark.parametrize("batch_size,chunk", [(3, CHUNK), (1, 5)])
def test_engine_shape_universe_matches_jax(jax_params, batch_size, chunk):
    jeng = jengine.DecodeEngine(jax_params, j_smoke(ARCH),
                                batch_size=batch_size, max_len=MAX_LEN,
                                prefill_chunk=chunk)
    teng = _port_engine(jax_params, t_smoke(ARCH), "auto",
                        batch_size=batch_size, prefill_chunk=chunk)
    assert teng.matmul_shape_universe() == jeng.matmul_shape_universe()


@pytest.mark.parametrize("act_dtype", ["none", "int8"])
def test_autotune_shapes_times_every_eligible_kernel_at_every_shape(
        jax_params, act_dtype):
    eng = _port_engine(jax_params, t_smoke(ARCH).with_(act_dtype=act_dtype),
                       "auto")
    results = eng.autotune_shapes(reps=1)
    assert sorted(results) == eng.matmul_shape_universe()
    act = "int8" if act_dtype == "int8" else "bfloat16"
    cache = tdispatch.AutotuneCache.load()
    for (m, k, n), us in results.items():
        want = {s.name for s in tdispatch.eligible_kernels(m, k, n, act)}
        assert set(us) == want and ("w2a8" in us) == (act == "int8")
        assert cache.best(m, k, n, act, "cpu") == min(us, key=us.get)


def test_engine_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device exists")
    tcfg = t_smoke(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.DecodeEngine({}, tcfg, batch_size=1, max_len=16)


@pytest.mark.parametrize("kwarg", [{"mesh": object()},
                                   {"mesh": object(),
                                    "draft": ({}, t_smoke(ARCH))}])
def test_engine_rejects_features_not_ported(kwarg):
    with pytest.raises(NotImplementedError, match="not ported"):
        tengine.DecodeEngine({}, t_smoke(ARCH), batch_size=1, max_len=16,
                             device="cpu", **kwarg)


def test_generational_run_is_not_ported(jax_served):
    """The name is kept from when ``run()`` was refused; it is ported now
    and, as the reference's, refuses more requests than slots and points
    to ``serve()``."""
    js, _, _ = jax_served
    ts = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    eng = tengine.DecodeEngine(ts, t_smoke(ARCH), batch_size=1, max_len=16,
                               device="cpu")
    with pytest.raises(ValueError, match="serve"):
        eng.run([tengine.Request(prompt=[3, 4]) for _ in range(2)])


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


@pytest.mark.parametrize("argv", [
    ["--autotune"], ["--policy", "fixed:w2a8", "--act-dtype", "int8"]])
def test_serve_launcher_autotunes_and_pins_on_the_cpu(argv, capsys):
    """``--autotune`` measures every shape before serving; a pin routes every
    projection to its kernel.  On the CPU no hand kernel launches, and the
    launcher reports every hand kernel's count."""
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--requests", "3", "--new-tokens", "3",
                       *argv])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    out = capsys.readouterr().out
    report = out.split("kernel launches: ")[1].splitlines()[0]
    assert report == ", ".join(f"{k} 0" for k in tdispatch.launch_counts())
    autotuned = "--autotune" in argv
    assert out.count("[autotune]") == (8 if autotuned else 0)
    assert bool(tdispatch.get_autotune_cache().entries) == autotuned
