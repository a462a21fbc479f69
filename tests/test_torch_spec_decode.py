"""The port's speculative decoding (``decode.verify_step``,
``snapshot_kv_window``/``rollback_kv_window``, the engine's spec round and
the scheduler's accounting and dynamic ``spec_k``), mirroring
``tests/test_spec_decode.py`` and held against the JAX package.

The models are the reduced dense bitnet-b1.58-2b of the JAX package's own
speculative tests (3 layers, d_model 64, vocab 256), its weights carried
across by ``repro_torch.convert``, on the CPU under ``fixed:ref``.

  * Verify is bitwise equal to sequential decode at batch 2 (logits and
    the KV it writes), under ``fixed:ref`` and ``auto``.  The scatter-first
    form attends and reduces per position as decode does, so what is left
    is the projections' row count: M = 2 at decode, 8 at verify, which
    this CPU's f32 matmul sums in the same order.  At batch 1 it does not
    (M = 1 takes another path), so there only the token streams are held
    byte-identical (canonical greedy absorbs the last-bit noise).  The
    port's verify logits agree with the JAX ``verify_step`` to 2^-4, the
    port's serving tolerance (``tests/test_torch_serving.py``).
  * A dead row (start -1) writes nothing.
  * A rollback after a partial acceptance leaves the cache of the accepted
    tokens alone: bitwise the sequential decode of the accepted prefix on a
    dense ring; on a wrapped 8-slot ring the kept slots hold the verify's
    writes and every other slot its pre-verify bytes.
  * Spec streams are byte-identical to the port's non-spec canonical-greedy
    streams: a mismatched one-layer draft with a stop token and refills
    (dense and window 8), the twin draft (acceptance 1.0), a prefix store,
    and dynamic ``spec_k``.  Against the JAX engine's non-spec and spec
    streams they are held by ``tests/test_torch_serving.py``'s rule: equal
    token for token, except that at a step where the JAX logits' top-2
    bf16 margin is under 2^-4 the two may pick differently, and the
    streams are compared no further (the pinned requests meet one such
    step, a margin of 2^-6).
  * The window caps acceptance; the scheduler's accounting (per request,
    dynamic windows) equals the JAX scheduler's on the same fake backend;
    the constructor refuses what the reference refuses, with its exception
    types; the shape universe with a draft equals the JAX engine's (on a
    dense config the port's ``serving_matmul_problems`` rule drops
    nothing).
  * Launches per spec round are constant: each round with live slots
    dispatches the same ternary matmuls (the draft's K decode steps at M =
    B, one verify at M = B · K), whatever the prompt lengths.
"""

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
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.serving.engine import DecodeEngine, Request, SamplerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from test_serving_scheduler import FakeSpecBackend  # noqa: E402
from test_torch_serving import _jax_forced, _top2_margin  # noqa: E402

ARCH = "bitnet-b1.58-2b"
TINY = dict(n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=128, vocab_size=256, loss_chunk=32)
TOL = 2.0 ** -4
MAX_LEN = 48
CHUNK = 8
K = 4


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _tcfg(window=0, policy="fixed:ref"):
    return t_smoke(ARCH).with_(**TINY, window=window, matmul_policy=policy)


def _jcfg(window=0):
    return j_smoke(ARCH).with_(**TINY, window=window,
                               matmul_policy="fixed:ref")


def _jax_tree(seed, n_layers=3):
    cfg = _jcfg().with_(n_layers=n_layers)
    return jdecode.quantize_for_serving(
        jmodel.init_params(cfg, jax.random.PRNGKey(seed)), cfg)


def _port(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def trees():
    """``{"target": (jax, port), "draft": (jax, port)}``: the target and a
    real mismatched draft (one layer, other weights, same vocabulary)."""
    out = {}
    for name, seed, layers in (("target", 0, 3), ("draft", 7, 1)):
        j = _jax_tree(seed, layers)
        out[name] = (j, _port(j))
    return out


def _draft(trees, window=0):
    return trees["draft"][1], _tcfg(window).with_(n_layers=1,
                                                  name="qwen3-0.6b")


def _engine(trees, *, window=0, draft=None, spec_k=K, B=2,
            prefix_cache=False, policy="fixed:ref"):
    return DecodeEngine(trees["target"][1], _tcfg(window, policy),
                        batch_size=B, max_len=MAX_LEN, prefill_chunk=CHUNK,
                        device="cpu", prefix_cache=prefix_cache,
                        sampler=SamplerConfig(canonical_greedy=True),
                        draft=draft, spec_k=spec_k)


# ---------------------------------------------------------------------------
# verify, snapshot and rollback
# ---------------------------------------------------------------------------


def _ragged_cache(p, cfg, plens, seed):
    """A batch cache with rows prefilled to different lengths in one
    chunk (the state the scheduler verifies against)."""
    rng = np.random.default_rng(seed)
    B, C = len(plens), max(plens)
    cache = tdecode.init_cache(cfg, B, MAX_LEN, device="cpu")
    toks = torch.from_numpy(rng.integers(2, 250, (B, C)))
    pos = torch.full((B, C), -1, dtype=torch.int32)
    for b, n in enumerate(plens):
        pos[b, :n] = torch.arange(n)
    cache, _ = tdecode.prefill_chunk(p, cfg, cache, toks, pos)
    return cache


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _bound(trees, cfg):
    return tdecode.bind_serving_weights(trees["target"][1], cfg)


def _to_jax_cache(cache):
    out = to_numpy_tree(cache)
    return {k: jnp.asarray(v.view(jnp.bfloat16) if k != "pos" else v)
            for k, v in out.items()}


def _equal_caches(a, b, msg=""):
    for leaf in ("k", "v", "pos"):
        assert torch.equal(a[leaf], b[leaf]), f"{leaf} {msg}"


@pytest.mark.parametrize("policy", ["fixed:ref", "auto"])
def test_verify_bitwise_equals_sequential_decode(trees, policy):
    cfg = _tcfg(policy=policy)
    p = _bound(trees, cfg)
    rng = np.random.default_rng(1)
    cache = _ragged_cache(p, cfg, [5, 9], seed=0)
    cands = torch.from_numpy(rng.integers(2, 250, (2, K)))
    start = torch.tensor([5, 9], dtype=torch.int32)
    seq, seq_logits = _clone(cache), []
    for j in range(K):
        logits, seq = tdecode.decode_step(p, cfg, seq, cands[:, j], start + j)
        seq_logits.append(logits)
    vlogits, vcache = tdecode.verify_step(p, cfg, _clone(cache), cands, start)
    assert torch.equal(vlogits, torch.stack(seq_logits, 1))
    _equal_caches(vcache, seq)
    jlogits, _ = jdecode.verify_step(
        trees["target"][0], _jcfg(), _to_jax_cache(cache),
        jnp.asarray(cands.numpy(), jnp.int32), jnp.asarray(start.numpy()))
    assert np.abs(np.asarray(jlogits) - vlogits.numpy()).max() <= TOL


def test_verify_dead_row_writes_nothing(trees):
    cfg = _tcfg()
    p = _bound(trees, cfg)
    cache = _ragged_cache(p, cfg, [5, 9], seed=2)
    cands = torch.from_numpy(np.random.default_rng(3).integers(2, 200, (2, K)))
    _, vcache = tdecode.verify_step(p, cfg, _clone(cache), cands,
                                    torch.tensor([5, -1], dtype=torch.int32))
    for leaf in ("k", "v", "pos"):
        assert torch.equal(vcache[leaf][:, 1], cache[leaf][:, 1])
        assert not torch.equal(vcache[leaf][:, 0], cache[leaf][:, 0])


@pytest.mark.parametrize("keep", [(0, K), (K, 0), (1, 3), (2, 2)])
def test_rollback_equals_sequential_prefix_dense(trees, keep):
    """Also the undo slab's ownership: ``keep = 0`` restores the row's
    pre-verify bytes, which a slab aliasing the cache would have lost to
    the verify's own writes."""
    cfg = _tcfg()
    p = _bound(trees, cfg)
    cache = _ragged_cache(p, cfg, [4, 11], seed=4)
    cands = torch.from_numpy(np.random.default_rng(5).integers(2, 200, (2, K)))
    start = torch.tensor([4, 11], dtype=torch.int32)
    undo = tdecode.snapshot_kv_window(cfg, cache, start, K)
    _, vcache = tdecode.verify_step(p, cfg, _clone(cache), cands, start)
    rolled = tdecode.rollback_kv_window(cfg, vcache, undo,
                                        torch.tensor(keep))
    seq = _clone(cache)
    for j in range(max(keep)):
        live = torch.tensor([j < k for k in keep])
        _, seq = tdecode.decode_step(p, cfg, seq,
                                     torch.where(live, cands[:, j], 0),
                                     torch.where(live, start + j, -1))
    _equal_caches(rolled, seq, f"keep={keep}")


@pytest.mark.parametrize("S", [5, 12], ids=["pre-wrap", "wrapped"])
def test_rollback_restores_the_wrapped_ring(trees, S):
    """Window 8: a verify at S..S+3 wraps the ring at S = 5 and evicts
    in-window keys at S = 12; after ``rollback(keep)`` the kept slots hold
    the verify's writes and every other slot its pre-verify KV and
    position, -1 and evicted positions included."""
    cfg = _tcfg(window=8)
    p = _bound(trees, cfg)
    rng = np.random.default_rng(S)
    cache = tdecode.init_cache(cfg, 2, MAX_LEN, device="cpu")
    for s0 in range(0, S, 8):
        n = min(8, S - s0)
        pos = torch.full((2, 8), -1, dtype=torch.int32)
        pos[:, :n] = torch.arange(s0, s0 + n)
        cache, _ = tdecode.prefill_chunk(
            p, cfg, cache, torch.from_numpy(rng.integers(1, 250, (2, 8))), pos)
    cands = torch.from_numpy(rng.integers(1, 250, (2, K)))
    start = torch.full((2,), S, dtype=torch.int32)
    undo = tdecode.snapshot_kv_window(cfg, cache, start, K)
    _, post = tdecode.verify_step(p, cfg, _clone(cache), cands, start)
    for keep in range(K + 1):
        rolled = tdecode.rollback_kv_window(cfg, _clone(post), undo,
                                            torch.full((2,), keep))
        for b in range(2):
            kept = set(undo["slot"][b, :keep].tolist())
            for s in range(8):
                want = post if s in kept else cache
                for leaf in ("k", "v", "pos"):
                    assert torch.equal(rolled[leaf][:, b, s],
                                       want[leaf][:, b, s]), (keep, b, s)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


def _pinned_requests(cls=Request):
    rng = np.random.default_rng(3)
    specs = [(5, 12), (11, 7), (3, 20), (9, 9), (17, 5)]
    return [cls(prompt=[int(t) for t in rng.integers(2, 250, plen)],
                max_new_tokens=budget, stop_token=5 if i == 2 else None)
            for i, (plen, budget) in enumerate(specs)]


def _waves(cls=Request):
    shared = [int(t) for t in np.random.default_rng(9).integers(2, 250, 17)]
    return [cls(prompt=shared + [30 + i], max_new_tokens=6)
            for i in range(2)] + \
        [cls(prompt=shared + [40 + i], max_new_tokens=6) for i in range(2)]


def _twin_requests(cls=Request):
    return [cls(prompt=[7 + i, 13 + i, 5], max_new_tokens=12)
            for i in range(2)]


def _serve(engine, reqs, **sched_kw):
    sched = ContinuousScheduler(engine, **sched_kw)
    for r in reqs:
        sched.submit(r)
    sched.run(max_steps=500)
    return [list(r.out) for r in reqs], sched.stats


@pytest.fixture(scope="module")
def jax_streams(trees):
    """The JAX engine's non-spec canonical-greedy streams, one compiled
    engine per window, and its spec engine's on the pinned requests:
    ``{(window, requests): streams}``."""
    out = {}
    for window in (0, 8):
        eng = jengine.DecodeEngine(
            trees["target"][0], _jcfg(window), batch_size=2,
            max_len=MAX_LEN, prefill_chunk=CHUNK,
            sampler=jengine.SamplerConfig(canonical_greedy=True))
        for name, make in (("pinned", _pinned_requests), ("waves", _waves),
                           ("twin", _twin_requests)):
            if window and name != "pinned":
                continue
            reqs = make(jengine.Request)
            eng.serve(reqs)
            out[(window, name)] = [list(r.out) for r in reqs]
    eng = jengine.DecodeEngine(
        trees["target"][0], _jcfg(), batch_size=2, max_len=MAX_LEN,
        prefill_chunk=CHUNK, spec_k=K,
        draft=(trees["draft"][0], _jcfg().with_(n_layers=1)))
    reqs = _pinned_requests(jengine.Request)
    eng.serve(reqs)
    out[(0, "pinned_spec")] = [list(r.out) for r in reqs]
    return out


def _held_to_jax(trees, streams, jstreams, requests, window=0):
    """``streams`` equal ``jstreams`` token for token up to the first step
    where the JAX logits' top-2 margin is under ``TOL``."""
    forced = None
    for r, got, want in zip(requests, streams, jstreams):
        t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if t is None:
            assert len(got) == len(want)
            continue
        forced = forced or _jax_forced(_jcfg(window))
        margin = _top2_margin(forced(trees["target"][0], r.prompt, want))
        assert margin[t] < TOL, (r.prompt, t, got[t], want[t], margin[t])


@pytest.mark.parametrize("window", [0, 8], ids=["dense", "windowed"])
def test_spec_streams_equal_non_spec_and_jax(trees, jax_streams, window):
    """A mismatched draft (most proposals rejected, so the rollback runs
    every round), a stop token, refills (5 requests, 2 slots)."""
    base, _ = _serve(_engine(trees, window=window), _pinned_requests())
    spec, stats = _serve(_engine(trees, window=window,
                                 draft=_draft(trees, window)),
                         _pinned_requests())
    assert spec == base
    for name in ("pinned", "pinned_spec")[:2 - bool(window)]:
        _held_to_jax(trees, spec, jax_streams[(window, name)],
                     _pinned_requests(), window)
    assert stats.spec_rounds > 0 and stats.emitted_tokens == \
        sum(len(o) for o in spec)
    assert 0 <= stats.accepted_drafted_tokens < stats.drafted_tokens
    assert stats.drafted_tokens % (K - 1) == 0


def test_spec_streams_at_batch_one(trees):
    base, _ = _serve(_engine(trees, B=1), _pinned_requests())
    spec, stats = _serve(_engine(trees, B=1, draft=_draft(trees)),
                         _pinned_requests())
    assert spec == base and stats.spec_rounds > 0


def test_twin_draft_accepts_everything(trees, jax_streams):
    tree, cfg = trees["target"][1], _tcfg()
    out, stats = _serve(_engine(trees, draft=(tree, cfg)), _twin_requests())
    assert stats.acceptance_rate == 1.0
    assert all(len(o) == 12 for o in out)
    assert stats.spec_rounds == 3   # 2 x 12 tokens, 4 a round
    _held_to_jax(trees, out, jax_streams[(0, "twin")], _twin_requests())
    assert out == _serve(_engine(trees), _twin_requests())[0]


def test_spec_with_prefix_store(trees, jax_streams):
    """The target splices hit blocks; the draft, which has no store,
    prefills every chunk."""
    eng = _engine(trees, draft=_draft(trees), prefix_cache=True)
    spec, stats = _serve(eng, _waves())
    assert spec == _serve(_engine(trees), _waves())[0]
    _held_to_jax(trees, spec, jax_streams[(0, "waves")], _waves())
    assert stats.spec_rounds > 0 and eng.prefix_store.stats.hit_blocks > 0


def test_dynamic_spec_k_streams_and_windows(trees, jax_streams):
    spec, stats = _serve(_engine(trees, draft=_draft(trees)),
                         _pinned_requests(), dynamic_spec_k=True)
    assert spec == _serve(_engine(trees), _pinned_requests())[0]
    _held_to_jax(trees, spec, jax_streams[(0, "pinned")], _pinned_requests())
    assert stats.spec_window_by_rid
    assert all(2 <= w <= K for w in stats.spec_window_by_rid.values())
    assert min(stats.spec_window_by_rid.values()) < K
    assert stats.drafted_tokens < stats.spec_rounds * 2 * (K - 1)


def test_window_caps_acceptance(trees):
    tree, cfg = trees["target"][1], _tcfg()

    def admitted():
        eng = _engine(trees, draft=(tree, cfg))
        state = eng.sched_start()
        for slot, r in enumerate(_twin_requests()):
            state = eng.sched_admit(state, slot, r)
        return eng, state

    eng, state = admitted()
    full = eng.sched_spec_step(state)
    assert list(full[2]) == [K, K]
    eng, state = admitted()
    assert list(eng.sched_spec_step(state, window=[2, 3])[2]) == [2, 3]
    eng, state = admitted()
    explicit = eng.sched_spec_step(state, window=[K, K])
    for a, b in zip(full[1:], explicit[1:]):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="window"):
        eng.sched_spec_step(eng.sched_start(), window=[2])


def test_launches_per_spec_round_are_constant(trees, monkeypatch):
    """Every round with a live slot dispatches the same ternary matmuls:
    per draft layer 7 projections in each of K steps at M = B, per target
    layer 7 in the verify at M = B · K."""
    calls = []
    run = tlayers.ternary_matmul

    def counted(x, w, **kw):
        calls.append(x.reshape(-1, x.shape[-1]).shape[0])
        return run(x, w, **kw)

    monkeypatch.setattr(tlayers, "ternary_matmul", counted)
    eng = _engine(trees, draft=_draft(trees), spec_k=3)
    state = eng.sched_start()
    for slot, n in enumerate((1, 6)):
        state = eng.sched_admit(state, slot, Request(
            prompt=list(range(2, 2 + n)), max_new_tokens=9))
    per_round = []
    while bool(state["live"].any()):
        calls.clear()
        state = eng.sched_spec_step(state)[0]
        per_round.append(sorted(calls))
    want = sorted([2] * 7 * 3 * 1 + [2 * 3] * 7 * 3)
    assert len(per_round) >= 3 and all(c == want for c in per_round)


# ---------------------------------------------------------------------------
# scheduler accounting against the JAX scheduler
# ---------------------------------------------------------------------------


def _fake_run(scheduler_cls, request_cls, dynamic):
    backend = FakeSpecBackend(2, spec_k=5,
                              accept=lambda rnd, b: 1 + (3 * rnd + b) % 5)
    reqs = []
    for i, (n, stop) in enumerate([(12, None), (7, 104), (15, None),
                                   (4, None), (9, 3)]):
        r = request_cls(prompt=[1], max_new_tokens=n, stop_token=stop)
        r._script = list(range(100 * i, 100 * i + 20))
        reqs.append(r)
    sched = scheduler_cls(backend, dynamic_spec_k=dynamic)
    for r in reqs:
        sched.submit(r)
    sched.run(max_steps=200)
    st = sched.stats
    idx = {r.rid: i for i, r in enumerate(reqs)}
    return ([r.out for r in reqs], st.spec_rounds, st.drafted_tokens,
            st.accepted_drafted_tokens, st.decode_steps, st.emitted_tokens,
            {idx[k]: v for k, v in st.accepted_by_rid.items()},
            {idx[k]: v for k, v in st.spec_window_by_rid.items()},
            {idx[k]: v for k, v in backend.windows_seen.items()})


@pytest.mark.parametrize("dynamic", [False, True])
def test_acceptance_accounting_equals_jax_scheduler(dynamic):
    from repro.serving.engine import Request as JRequest

    got = _fake_run(ContinuousScheduler, Request, dynamic)
    assert got == _fake_run(JScheduler, JRequest, dynamic)
    assert bool(got[7]) == dynamic


# ---------------------------------------------------------------------------
# constructor and shape universe
# ---------------------------------------------------------------------------


def test_constructor_refuses_what_the_reference_refuses(trees):
    tree, cfg = trees["target"][1], _tcfg()

    def make(draft, **kw):
        DecodeEngine(tree, kw.pop("cfg", cfg), batch_size=2, max_len=48,
                     device="cpu", draft=draft, **kw)

    with pytest.raises(ValueError, match="tokenizer mismatch"):
        make((tree, cfg.with_(vocab_size=128)))
    with pytest.raises(ValueError, match="temperature"):
        make((tree, cfg), sampler=SamplerConfig(temperature=0.7))
    with pytest.raises(ValueError, match="spec_k"):
        make((tree, cfg), spec_k=1)
    with pytest.raises(ValueError, match="ring length"):
        make((tree, cfg.with_(window=8)), cfg=cfg.with_(window=8), spec_k=9)
    with pytest.raises(ValueError, match="does not support"):
        make(({}, cfg.with_(block_pattern="mamba2")))
    with pytest.raises(ValueError, match="does not support"):
        make((tree, cfg), cfg=cfg.with_(block_pattern="mamba2"))
    with pytest.raises(NotImplementedError, match="not ported"):
        make((tree, cfg), mesh=object())


@pytest.mark.parametrize("batch_size,chunk,spec_k", [(2, CHUNK, 4),
                                                     (3, 5, 3)])
def test_shape_universe_with_a_draft_equals_jax(trees, batch_size, chunk,
                                                spec_k):
    """The draft is narrower (d_ff 96), so its problems show apart."""
    jdcfg = _jcfg().with_(n_layers=1, d_ff=96)
    jdraft = jdecode.quantize_for_serving(
        jmodel.init_params(jdcfg, jax.random.PRNGKey(1)), jdcfg)
    jeng = jengine.DecodeEngine(
        trees["target"][0], _jcfg(), batch_size=batch_size, max_len=MAX_LEN,
        prefill_chunk=chunk, spec_k=spec_k, draft=(jdraft, jdcfg))
    teng = DecodeEngine(
        trees["target"][1], _tcfg(), batch_size=batch_size, max_len=MAX_LEN,
        prefill_chunk=chunk, device="cpu", spec_k=spec_k,
        draft=(_port(jdraft), _tcfg().with_(n_layers=1, d_ff=96)))
    universe = teng.matmul_shape_universe()
    assert universe == jeng.matmul_shape_universe()
    assert (batch_size * spec_k, 64, 64) in universe
    assert (batch_size, 64, 96) in universe and (chunk, 96, 64) in universe


def test_autotune_times_the_draft_and_verify_shapes(trees):
    eng = _engine(trees, draft=_draft(trees), policy="auto")
    results = eng.autotune_shapes(reps=1)
    assert sorted(results) == eng.matmul_shape_universe()
    assert (2 * K, 64, 64) in results


def test_serve_launcher_serves_with_a_draft(capsys):
    """``--draft`` with ``--dynamic-spec-k``: every request finishes and the
    speculative line is printed."""
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--requests", "3", "--new-tokens", "4",
                       "--draft", ARCH, "--spec-k", "3", "--dynamic-spec-k"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    text = capsys.readouterr().out
    assert "[serve] draft bitnet-b1.58-2b: spec_k=3" in text
    assert "[serve] speculative: " in text


def test_load_generator_replays_a_scenario_speculatively(trees):
    """The smoke ``code`` scenario on the virtual clock through a spec
    engine under dynamic ``spec_k`` (passed through the load generator):
    each request's stream equals its replay on the non-spec engine (the
    rows of a dense step are independent, so batching changes no stream)."""
    from repro_torch.serving.loadgen import LoadGenerator, generate_trace
    from repro_torch.serving.workload import get_scenario

    trace = generate_trace(get_scenario("code").smoke(), 256, seed=0)

    def replay(**kw):
        eng = DecodeEngine(trees["target"][1], _tcfg(), batch_size=2,
                           max_len=80, prefill_chunk=CHUNK, device="cpu",
                           sampler=SamplerConfig(canonical_greedy=True), **kw)
        gen = LoadGenerator(eng, trace, dynamic_spec_k=bool(kw))
        res = gen.run()
        done = sorted(gen.sched.completed, key=lambda r: r.rid)
        return [r.out for r in done], res.stats

    base, _ = replay()
    spec, stats = replay(draft=_draft(trees), spec_k=3)
    assert spec == base and len(spec) == len(trace)
    assert stats.spec_rounds > 0 and stats.spec_window_by_rid
