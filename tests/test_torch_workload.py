"""The port's traffic layer (``serving/workload.py``, ``serving/loadgen.py``)
against the JAX package's.

Traces: the port's ``generate_trace`` must equal the JAX package's field
for field, float timestamps exactly, for each of the four scenarios at
seeds 0, 1 and 7, full size and ``smoke()``: the salts and ``SeedSequence``
streams are the same, so the draws are.  ``percentile`` and
``latency_summary`` run the same float arithmetic as the JAX package's and
must equal them exactly, and numpy's percentile to 1e-9.

Replay: a virtual-clock ``LoadGenerator`` replay of smoke ``agentic`` and
smoke ``chat`` on the port's engine (reduced bitnet-b1.58-2b, 4 layers,
d_model 128, on the CPU) against the JAX ``LoadGenerator`` on the JAX engine,
on the same packed weights, both with canonical greedy selection.  No
request has a stop token, so the schedule, and with it every virtual
timestamp, does not depend on token values: arrival, submit, admit,
first-token and done times must be equal exactly, and the tenant tags too.
Token streams are held under ``tests/test_torch_serving.py``'s rule: the
logits, teacher-forced on the JAX stream, within 2^-4 of the JAX ones, and
the streams equal step for step except from a step whose JAX top-2 margin
is below that tolerance.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro.serving import loadgen as jloadgen
from repro.serving import workload as jworkload
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.serving import engine as tengine
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving import workload as tworkload
from test_torch_serving import _FakeBackend as _Fake  # noqa: E402

ARCH = "bitnet-b1.58-2b"
TOL = 2.0 ** -4
CHUNK = 8
SCENARIOS = ["chat", "rag", "agentic", "code"]


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def _scenarios(name, smoke):
    j, t = jworkload.get_scenario(name), tworkload.get_scenario(name)
    return (j.smoke(), t.smoke()) if smoke else (j, t)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", SCENARIOS)
def test_trace_equals_jax_field_for_field(name, seed, smoke):
    jsc, tsc = _scenarios(name, smoke)
    vocab = 512 if smoke else 128256
    want = jloadgen.generate_trace(jsc, vocab, seed)
    got = tloadgen.generate_trace(tsc, vocab, seed)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
    # the scenarios' geometry agrees too (the engine's max_len follows it)
    assert (tsc.max_prompt_len(), tsc.max_new_tokens(), tsc.offered_qps(),
            tsc.slo_ttft_budget()) == (jsc.max_prompt_len(),
                                       jsc.max_new_tokens(), jsc.offered_qps(),
                                       jsc.slo_ttft_budget())


@pytest.mark.parametrize("name", SCENARIOS)
def test_shared_prefixes_and_tenant_streams_equal_jax(name):
    sc = tworkload.get_scenario(name)
    for ti, ten in enumerate(sc.tenants):
        for g in range(ten.prefix_groups):
            assert tworkload.shared_prefix_tokens(
                3, name, ti, g, 40, 512) == jworkload.shared_prefix_tokens(
                3, name, ti, g, 40, 512)
        a = tworkload.tenant_rng(5, name, ti, 1).integers(0, 1 << 30, 8)
        b = jworkload.tenant_rng(5, name, ti, 1).integers(0, 1 << 30, 8)
        assert np.array_equal(a, b)


def test_workload_specs_reject_what_jax_rejects():
    for bad in (dict(kind="nope"), dict(kind="choice"),
                dict(kind="uniform", a=5, b=2)):
        with pytest.raises(ValueError):
            tworkload.Dist(**bad)
    with pytest.raises(ValueError):
        tworkload.ArrivalProcess("poisson", rate=0.0)
    with pytest.raises(KeyError, match="available"):
        tworkload.get_scenario("nope")
    with pytest.raises(ValueError):
        tloadgen.generate_trace(tworkload.get_scenario("chat"), 3)


# ---------------------------------------------------------------------------
# statistics helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (17, 2), (200, 3)])
def test_percentile_and_summary_equal_jax_and_numpy(n, seed):
    vals = np.random.default_rng(seed).normal(0.0, 10.0, size=n).tolist()
    for p in (0, 1, 25, 50, 75, 95, 99, 99.9, 100):
        got = tloadgen.percentile(vals, p)
        assert got == jloadgen.percentile(vals, p)
        assert got == pytest.approx(float(np.percentile(vals, p)), abs=1e-9)
    assert tloadgen.latency_summary(vals) == jloadgen.latency_summary(vals)
    assert tloadgen.latency_summary(vals, 3) == \
        jloadgen.latency_summary(vals, 3)


def test_percentile_edges():
    assert tloadgen.percentile([], 99) == 0.0
    assert tloadgen.percentile([3.0], 50) == 3.0
    with pytest.raises(ValueError):
        tloadgen.percentile([1.0], 101)
    assert tloadgen.latency_summary([]) == jloadgen.latency_summary([])


# ---------------------------------------------------------------------------
# replay on a fake backend
# ---------------------------------------------------------------------------


def _smoke_trace(name, seed=0, n=None):
    trace = tloadgen.generate_trace(tworkload.get_scenario(name).smoke(),
                                    512, seed)
    return trace if n is None else trace[:n]


def test_virtual_clock_admission_invariant():
    """No request is submitted or admitted before it arrives, every record
    completes, and the tenant tags and token counts add up."""
    trace = _smoke_trace("chat")
    res = tloadgen.LoadGenerator(_Fake(4), trace, clock="virtual").run()
    assert len(res.records) == len(trace) and res.clock == "virtual"
    for r, ev in zip(res.records, trace):
        assert r.tenant == ev.tenant and r.t_arrival == ev.t
        assert r.t_submit >= r.t_arrival - 1e-12
        assert r.t_admit is not None and r.t_admit >= r.t_arrival - 1e-12
        assert r.t_first_token is not None and r.t_first_token > r.t_admit
        assert r.t_done is not None and r.t_done >= r.t_first_token
        assert r.n_out == ev.new_tokens and r.queue_wait_s >= 0
    assert res.emitted_tokens == sum(ev.new_tokens for ev in trace)
    assert set(res.by_tenant()) == {ev.tenant for ev in trace}
    assert res.achieved_qps > 0 and res.offered_qps > 0


def test_higher_step_cost_degrades_tail_ttft():
    trace = _smoke_trace("chat")

    def p99(cost):
        res = tloadgen.LoadGenerator(_Fake(4), trace, clock="virtual",
                                     decode_step_cost_s=cost).run()
        return tloadgen.percentile([r.ttft_s for r in res.records], 99)

    assert p99(0.05) > p99(0.005)


def test_wall_clock_replay_completes_in_real_time():
    """Four smoke-chat arrivals on the wall clock: the replay waits for the
    arrivals and records every request on the perf_counter clock."""
    trace = _smoke_trace("chat", n=4)
    t0 = time.perf_counter()
    res = tloadgen.LoadGenerator(_Fake(4), trace, clock="wall").run()
    assert time.perf_counter() - t0 >= trace[-1].t
    assert res.clock == "wall" and len(res.records) == 4
    for r in res.records:
        assert r.t_submit >= r.t_arrival
        assert r.t_done >= r.t_first_token >= r.t_admit >= r.t_submit


def test_loadgen_rejects_bad_clocks_costs_and_traces():
    trace = _smoke_trace("chat")
    with pytest.raises(ValueError, match="clock"):
        tloadgen.LoadGenerator(_Fake(4), trace, clock="nope")
    for kw in (dict(decode_step_cost_s=0.0), dict(prefill_chunk_cost_s=-1.0)):
        with pytest.raises(ValueError, match="cost"):
            tloadgen.LoadGenerator(_Fake(4), trace, **kw)
    with pytest.raises(ValueError, match="empty"):
        tloadgen.LoadGenerator(_Fake(4), []).run()


# ---------------------------------------------------------------------------
# replay on the engines: the port's against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    jcfg = j_smoke(ARCH)
    return jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(2)), jcfg)


def _max_len(scenario) -> int:
    need = scenario.max_prompt_len() + scenario.max_new_tokens() + 1
    return -(-need // 16) * 16


def _chunks(prompt):
    for start, valid in tdecode.prefill_chunks_of(len(prompt), CHUNK):
        toks = np.ones((1, CHUNK), np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        pos = np.full((1, CHUNK), -1, np.int32)
        pos[0, :valid] = np.arange(start, start + valid)
        yield toks, pos, valid - 1


def _jax_forced(js, jcfg, max_len, prompt, stream) -> np.ndarray:
    """JAX logits before each emitted token of ``stream`` (chunked prefill,
    then one decode step per token but the last)."""
    cache = jdecode.init_cache(jcfg, 1, max_len)
    for toks, pos, take in _chunks(prompt):
        cache, logits = _J_CHUNK(js, jcfg, cache, jnp.asarray(toks),
                                 jnp.asarray(pos), jnp.asarray(take, jnp.int32))
    out = [np.asarray(logits[0])]
    for i, tok in enumerate(stream[:-1]):
        logits, cache = _J_STEP(js, jcfg, cache, jnp.asarray([tok], jnp.int32),
                                jnp.asarray([len(prompt) + i], jnp.int32))
        out.append(np.asarray(logits[0]))
    return np.stack(out)


_J_CHUNK = jax.jit(jdecode.prefill_chunk, static_argnums=1)
_J_STEP = jax.jit(jdecode.decode_step, static_argnums=1)


def _port_forced(eng, prompt, stream) -> np.ndarray:
    cache = tdecode.init_cache(eng.cfg, 1, eng.max_len, device="cpu")
    for toks, pos, take in _chunks(prompt):
        cache, logits = tdecode.prefill_chunk(eng.params, eng.cfg, cache,
                                              torch.from_numpy(toks).long(),
                                              torch.from_numpy(pos), take)
    out = [logits[0].numpy()]
    for i, tok in enumerate(stream[:-1]):
        logits, cache = tdecode.decode_step(
            eng.params, eng.cfg, cache, torch.tensor([tok]),
            torch.tensor([len(prompt) + i], dtype=torch.int32))
        out.append(logits[0].numpy())
    return np.stack(out)


def _top2_margin(logits: np.ndarray) -> np.ndarray:
    r = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    top = np.sort(r, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


def _replay(gen):
    """``(timestamps and tags per record, token stream per request)`` of a
    load generator's run, both in trace order."""
    res = gen.run()
    recs = [(r.tenant, r.prompt_len, r.new_tokens_requested, r.t_arrival,
             r.t_submit, r.t_admit, r.t_first_token, r.t_done, r.n_out)
            for r in res.records]
    streams = [r.out for r in sorted(gen.sched.completed, key=lambda r: r.rid)]
    return res, recs, streams


@pytest.mark.parametrize("name", ["agentic", "chat"])
def test_virtual_replay_on_port_engine_matches_jax(jax_params, name):
    jsc, tsc = _scenarios(name, True)
    max_len = _max_len(tsc)
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jtrace = jloadgen.generate_trace(jsc, jcfg.vocab_size, 0)
    ttrace = tloadgen.generate_trace(tsc, tcfg.vocab_size, 0)
    jeng = jengine.DecodeEngine(
        jax_params, jcfg, batch_size=4, max_len=max_len, prefill_chunk=CHUNK,
        sampler=jengine.SamplerConfig(canonical_greedy=True))
    _, jrecs, jstreams = _replay(jloadgen.LoadGenerator(jeng, jtrace))
    ts = from_numpy_tree(jax.tree.map(np.asarray, jax_params), "cpu")
    teng = tengine.DecodeEngine(
        ts, tcfg, batch_size=4, max_len=max_len, prefill_chunk=CHUNK,
        device="cpu", sampler=tengine.SamplerConfig(canonical_greedy=True))
    res, trecs, tstreams = _replay(tloadgen.LoadGenerator(teng, ttrace))
    assert res.stats.prefill_chunks > 0 and res.stats.affinity_reorders == 0
    assert trecs == jrecs
    assert len(tstreams) == len(jstreams) == len(ttrace)
    for ev, got, want in zip(ttrace, tstreams, jstreams):
        assert len(got) == len(want) == ev.new_tokens
        jl = _jax_forced(jax_params, jcfg, max_len, list(ev.prompt), want)
        tl = _port_forced(teng, list(ev.prompt), want)
        assert np.abs(tl - jl).max() <= TOL
        margin = _top2_margin(jl)
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                assert margin[t] < TOL, (t, a, b, margin[t])
                break
    # a second replay on the same engine is identical, stream for stream
    _, again, again_streams = _replay(tloadgen.LoadGenerator(teng, ttrace))
    assert again == trecs and again_streams == tstreams
