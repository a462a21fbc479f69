"""The port's prefix cache (``serving/prefix_cache.py``, the engine's store,
``decode.extract_kv_blocks``/``splice_kv_blocks``) and the scheduler's
cache-affinity admission, mirroring ``tests/test_prefix_cache.py`` and held
against the JAX package.

  * Chain hashes equal the JAX package's, byte for byte (same blake2b
    chain, same namespace string).
  * Extract and splice are bitwise equal to the JAX functions on the same
    cache contents, at window 0 and 8, a ring wrap included (exact: they
    move bytes).
  * A cold or warm store gives token streams byte-identical to the port's
    engine without a store (exact: a splice writes the very bytes the
    engine would recompute on the same inputs), dense and MoE.  On the MoE
    the expert capacity couples the rows of a decode step, so the case is
    served by ``engine.serve`` (each admission finishes within the step it
    starts) and the admission order is checked to be the same, so the
    decode batches are too.
  * The published hash set, and the hit, miss, published and reused
    counts, equal the JAX engine's store on the same requests.

The engines run a tiny bitnet-b1.58-2b (2 layers, d_model 64), as the JAX
package's own prefix-cache tests do, and the reduced phi3.5-moe-42b-a6.6b,
on the CPU with ``fixed:ref``.
"""

import random

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
from repro.serving.prefix_cache import chain_block_hashes as j_chain
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro.serving.scheduler import Request as JRequest
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import decode as tdecode
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.prefix_cache import (PrefixBlockStore,
                                              PrefixStoreStats,
                                              chain_block_hashes)
from repro_torch.serving.scheduler import (AFFINITY_WINDOW,
                                          MAX_AFFINITY_SKIPS,
                                          ContinuousScheduler, SchedulerStats)
from test_prefix_cache import AffinityFake  # noqa: E402

ARCH = "bitnet-b1.58-2b"
MOE = "phi3.5-moe-42b-a6.6b"
TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=128, vocab_size=256, loss_chunk=32)


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


@pytest.fixture(scope="module")
def tiny_jax():
    """The tiny bitnet's JAX serving tree (window 0; the window changes no
    weight)."""
    jcfg = j_smoke(ARCH).with_(**TINY)
    return jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(0)), jcfg)


@pytest.fixture(scope="module")
def tiny(tiny_jax):
    """The same tree as torch tensors."""
    return from_numpy_tree(jax.tree.map(np.asarray, tiny_jax), "cpu")


@pytest.fixture(scope="module")
def moe_served():
    cfg = t_smoke(MOE)
    return tdecode.init_serving_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu")


def _engine(tree, *, arch=ARCH, B=2, max_len=48, window=0, prefill_chunk=4,
            prefix_cache=False, prefix_cache_mb=64.0):
    """A port engine on the torch ``tree`` at the tiny bitnet, or at the
    reduced phi3.5-moe with ``arch=MOE``."""
    cfg = (t_smoke(ARCH).with_(**TINY) if arch == ARCH else t_smoke(MOE))
    return DecodeEngine(tree, cfg.with_(window=window), batch_size=B,
                        max_len=max_len, matmul_policy="fixed:ref",
                        prefill_chunk=prefill_chunk, device="cpu",
                        prefix_cache=prefix_cache,
                        prefix_cache_mb=prefix_cache_mb)


def _jax_engine(tree, *, B=2, max_len=48, window=0, prefill_chunk=4,
                prefix_cache=False):
    return jengine.DecodeEngine(
        tree, j_smoke(ARCH).with_(**TINY, window=window), batch_size=B,
        max_len=max_len, matmul_policy="fixed:ref",
        prefill_chunk=prefill_chunk, prefix_cache=prefix_cache)


# ---------------------------------------------------------------------------
# chained hashes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("block", [1, 4, 32])
@pytest.mark.parametrize("namespace", [b"", b"bitnet-b1.58-2b:30:5:128:2560"])
def test_chain_hashes_equal_jax(seed, block, namespace):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128256, size=int(rng.integers(0, 200))).tolist()
    for n_blocks in (None, 2):
        got = chain_block_hashes(toks, block, n_blocks, namespace)
        assert got == j_chain(toks, block, n_blocks, namespace)
    assert PrefixBlockStore(block, namespace=namespace).block_hashes(toks) \
        == j_chain(toks, block, namespace=namespace)


def test_chain_hashes_basic_properties():
    toks = list(range(10))
    hs = chain_block_hashes(toks, 4)
    assert len(hs) == 2  # the trailing partial block is never hashed
    assert chain_block_hashes(toks, 4, n_blocks=1) == hs[:1]
    # chaining: the same block content at another depth hashes differently
    assert chain_block_hashes(toks[4:8] + toks[4:8], 4)[0] != hs[1]
    assert chain_block_hashes(toks, 4, namespace=b"other") != hs
    assert chain_block_hashes(toks, 5)[0] not in hs


@pytest.mark.parametrize("seed", range(6))
def test_chain_hash_equal_iff_token_prefix_equal(seed):
    rng = random.Random(seed)
    block = rng.randint(1, 8)
    a = [rng.randint(0, 255) for _ in range(rng.randint(8, 40))]
    b = list(a)
    i = rng.randrange(len(a))
    b[i] = (b[i] + rng.randint(1, 255)) % 256  # a fork at position i
    ha, hb = chain_block_hashes(a, block), chain_block_hashes(b, block)
    for j in range(min(len(ha), len(hb))):
        n = (j + 1) * block
        assert (ha[j] == hb[j]) == (a[:n] == b[:n])
    # appending past the hashed blocks changes none of their hashes
    n = (len(a) // block) * block
    assert chain_block_hashes(a[:n] + [7], block)[:len(ha)] == ha


# ---------------------------------------------------------------------------
# store: LRU under a byte budget, peek-vs-count lookups
# ---------------------------------------------------------------------------


def _slab(fill, n=64):
    x = torch.full((n,), float(fill))  # 256 bytes
    return {"k": x, "v": x.clone()}


def test_store_lru_eviction_under_byte_budget():
    store = PrefixBlockStore(4, max_bytes=3 * 512)
    h = [bytes([i]) * 16 for i in range(4)]
    assert all(store.put(h[i], _slab(i)) for i in range(3))
    assert store.nbytes == 3 * 512 and len(store) == 3
    store.get(h[0])  # bump: h[1] is now the least recent
    assert store.put(h[3], _slab(3))
    assert h[1] not in store and h[0] in store and len(store) == 3
    assert store.stats.evicted_blocks == 1
    # a duplicate put is refused, counted once, and bumps recency
    assert not store.put(h[0], _slab(0))
    assert store.nbytes == 3 * 512
    # a slab larger than the whole budget is refused outright
    assert not store.put(bytes(16), _slab(9, n=3 * 512))
    assert store.stats.published_blocks == 4
    # the budget counts bf16 slabs at two bytes an element
    small = PrefixBlockStore(4, max_bytes=1 << 10)
    assert small.put(h[0], {"k": torch.zeros(128, dtype=torch.bfloat16),
                            "v": torch.zeros(128, dtype=torch.bfloat16)})
    assert small.nbytes == 512


def test_store_match_is_prefix_only_and_peek_is_silent():
    store = PrefixBlockStore(4, max_bytes=1 << 20)
    h = [bytes([i]) * 16 for i in range(3)]
    store.put(h[0], _slab(0))
    store.put(h[1], _slab(1))
    assert store.match(h, peek=True) == 2
    assert store.stats.lookups == 0  # peeks never count
    assert store.match(h) == 2
    assert (store.stats.hit_blocks, store.stats.miss_blocks) == (2, 1)
    # a chained lookup stops at the first absence: an interior "hit" is dead
    store.clear()
    store.put(h[1], _slab(1))
    assert store.match(h) == 0
    assert store.stats.hit_rate == pytest.approx(2 / 6)
    assert PrefixStoreStats().hit_rate == 0.0
    with pytest.raises(ValueError):
        PrefixBlockStore(0)
    with pytest.raises(ValueError):
        PrefixBlockStore(4, max_bytes=0)


def test_queue_wait_summary_empty_is_zeros():
    assert SchedulerStats().queue_wait_summary() == \
        {"mean": 0.0, "p50": 0.0, "max": 0.0}


# ---------------------------------------------------------------------------
# extract/splice against the JAX functions
# ---------------------------------------------------------------------------


def _random_cache(cfg, max_len, seed):
    """The same cache contents for both packages: random bf16 k/v and a
    position row, as numpy (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    CL = tdecode.cache_len(cfg, max_len)
    shape = (cfg.n_layers, 1, CL, cfg.n_kv_heads, cfg.head_dim)
    kv = {n: rng.normal(size=shape).astype(jnp.bfloat16) for n in ("k", "v")}
    pos = np.tile(np.arange(CL, dtype=np.int32) + 3, (cfg.n_layers, 1, 1))
    return {**kv, "pos": pos}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("window,start,length", [
    (0, 0, 4), (0, 8, 4), (0, 20, 8),
    (8, 0, 4), (8, 4, 4), (8, 8, 4), (8, 6, 4), (8, 13, 8)])
def test_extract_and_splice_bitwise_equal_jax(window, start, length):
    """At window 8 the ring holds 8 slots: starts 8 and 13 and the block
    at 6 wrap onto slot 0."""
    max_len = 32
    tcfg = t_smoke(ARCH).with_(**TINY, window=window)
    jcfg = j_smoke(ARCH).with_(**TINY, window=window)
    src = _random_cache(tcfg, max_len, seed=start + 31 * window)
    jblk = jdecode.extract_kv_blocks(jcfg, jax.tree.map(jnp.asarray, src),
                                     start, length)
    tsrc = from_numpy_tree(src, "cpu")
    tblk = tdecode.extract_kv_blocks(tcfg, tsrc, start, length)
    for name in ("k", "v"):
        assert tblk[name].shape == (2, length, 2, 32)
        assert np.array_equal(to_numpy_tree(tblk)[name].view(np.uint16),
                              np.asarray(jblk[name]).view(np.uint16))
        # the slab owns its storage: no view into the admission cache
        assert tblk[name].untyped_storage().data_ptr() != \
            tsrc[name].untyped_storage().data_ptr()
        assert tblk[name].untyped_storage().nbytes() == \
            tblk[name].numel() * tblk[name].element_size()
    # splice the block into another cache: the same bytes and positions
    dst = _random_cache(tcfg, max_len, seed=99)
    want = jdecode.splice_kv_blocks(jcfg, jax.tree.map(jnp.asarray, dst),
                                    jblk, start)
    tdst = from_numpy_tree(dst, "cpu")
    got = tdecode.splice_kv_blocks(tcfg, tdst, tblk, start)
    assert got is tdst  # in place
    got, want = to_numpy_tree(got), _np(want)
    for name in ("k", "v"):
        assert np.array_equal(got[name].view(np.uint16),
                              want[name].view(np.uint16))
    assert np.array_equal(got["pos"], want["pos"])


def test_extract_splice_roundtrip_on_a_prefilled_cache(tiny):
    """A block extracted from one admission cache and spliced into a fresh
    one lands bit-identical at the same slots, positions stamped; every
    other slot stays fresh."""
    eng = _engine(tiny, B=1)
    cfg = eng.cfg
    toks = torch.tensor([[3, 4, 5, 6, 7, 8, 9, 10]])
    cache, _ = tdecode.prefill(eng.params, cfg, {"tokens": toks},
                               s_max=eng.max_len)
    blk = tdecode.extract_kv_blocks(cfg, cache, 4, 4)
    fresh = tdecode.init_cache(cfg, 1, eng.max_len, device="cpu")
    out = tdecode.splice_kv_blocks(cfg, fresh, blk, 4)
    for name in ("k", "v"):
        assert torch.equal(out[name][:, 0, 4:8], cache[name][:, 0, 4:8])
        assert not out[name][:, 0, :4].any() and not out[name][:, 0, 8:].any()
    assert out["pos"][0, 0, 4:8].tolist() == [4, 5, 6, 7]
    assert (out["pos"][:, 0, :4] == -1).all()


# ---------------------------------------------------------------------------
# engine: cold and warm stores against no store, and against JAX
# ---------------------------------------------------------------------------

_SHARED = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12]


def _oracle_specs():
    # heavy shared-prefix overlap, one cold request and one short prompt
    return [(_SHARED + [20], 4), (_SHARED + [21, 22], 4),
            (_SHARED[:8] + [23], 3), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 4),
            ([2, 2], 3)]


def _serve_logged(eng, specs):
    """``engine.serve`` the specs; returns the requests and the prompts in
    admission order."""
    order = []
    start = eng.sched_admit_start

    def logged(state, slot, request):
        order.append(tuple(request.prompt))
        return start(state, slot, request)

    eng.sched_admit_start = logged
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
    eng.serve(reqs, max_steps=400)
    return reqs, order


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("arch", [ARCH, MOE])
def test_cold_store_streams_match_no_store(tiny, moe_served, arch,
                                           window):
    """A store that publishes and reuses blocks mid-serve (later requests
    hit blocks earlier ones just produced) gives streams byte-identical to
    the engine without a store."""
    tree = tiny if arch == ARCH else moe_served
    base = _engine(tree, arch=arch, window=window)
    cached = _engine(tree, arch=arch, window=window, prefix_cache=True)
    want, order_want = _serve_logged(base, _oracle_specs())
    got, order_got = _serve_logged(cached, _oracle_specs())
    assert order_got == order_want
    for w, g in zip(want, got):
        assert w.done and g.done and g.out == w.out, (g.out, w.out)
    st = cached.prefix_store.stats
    assert st.published_blocks > 0
    assert st.reused_tokens > 0, "shared prefixes never hit mid-serve"


def test_warm_store_prefills_fewer_chunks_with_the_same_streams(tiny):
    eng = _engine(tiny, prefix_cache=True)

    def pass_once():
        reqs = [Request(prompt=p, max_new_tokens=n)
                for p, n in _oracle_specs()]
        sched = ContinuousScheduler(eng)
        for r in reqs:
            sched.submit(r)
        sched.run(max_steps=400)
        return reqs, sched.stats

    first, st1 = pass_once()
    hits_before = eng.prefix_store.stats.hit_blocks
    second, st2 = pass_once()
    for a, b in zip(first, second):
        assert b.out == a.out, "warm-store stream diverged from the cold pass"
    assert eng.prefix_store.stats.hit_blocks > hits_before
    assert st2.prefill_chunks < st1.prefill_chunks, (st1, st2)


@pytest.mark.parametrize("window", [0, 8])
def test_store_publishes_and_counts_as_jax_does(tiny_jax, tiny, window):
    """The same requests through the JAX engine's store and the port's:
    the same published hash set (the namespace string is the JAX
    package's), the same lookups, and, with no stop token, the same
    schedule."""
    jeng = _jax_engine(tiny_jax, window=window, prefix_cache=True)
    jreqs = [jengine.Request(prompt=p, max_new_tokens=n)
             for p, n in _oracle_specs()]
    jeng.serve(jreqs, max_steps=400)
    teng = _engine(tiny, window=window, prefix_cache=True)
    treqs = [Request(prompt=p, max_new_tokens=n) for p, n in _oracle_specs()]
    teng.serve(treqs, max_steps=400)
    js, ts = jeng.prefix_store, teng.prefix_store
    assert ts.namespace == js.namespace
    assert set(ts._blocks) == set(js._blocks)
    assert list(ts._blocks) == list(js._blocks)  # the same LRU order
    for field in ("hit_blocks", "miss_blocks", "published_blocks",
                  "evicted_blocks", "reused_tokens"):
        assert getattr(ts.stats, field) == getattr(js.stats, field), field
    assert ts.nbytes == js.nbytes
    for r in treqs + jreqs:
        assert r.done
    probe = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]
    assert teng.prefix_match_len(Request(prompt=probe)) == \
        jeng.prefix_match_len(jengine.Request(prompt=probe))


def test_published_hashes_invariant_to_batch_and_order(tiny):
    specs = _oracle_specs()

    def published(B, order):
        eng = _engine(tiny, B=B, prefix_cache=True)
        eng.serve([Request(prompt=specs[i][0], max_new_tokens=specs[i][1])
                   for i in order], max_steps=400)
        return set(eng.prefix_store._blocks)

    base = published(1, [0, 1, 2, 3, 4])
    assert published(2, [4, 3, 2, 1, 0]) == base
    assert published(3, [2, 0, 4, 1, 3]) == base


def test_windowed_reuse_depth_capped_at_ring(tiny):
    """window 8, chunk 4: at most 2 blocks per prompt are published or
    consulted, whatever the prompt's length, and the capped reuse replays
    byte-identically."""
    eng = _engine(tiny, B=1, window=8, prefix_cache=True)
    assert eng._CL == 8
    prompt = list(range(2, 18))  # 16 tokens: 4 full blocks uncapped
    eng.serve([Request(prompt=prompt, max_new_tokens=2)], max_steps=200)
    assert len(eng.prefix_store) <= 2
    again = Request(prompt=prompt, max_new_tokens=2)
    assert eng.prefix_match_len(again) == 8  # 2 blocks, not 12 tokens
    base = _engine(tiny, B=1, window=8)
    want = Request(prompt=prompt, max_new_tokens=2)
    base.serve([want], max_steps=200)
    eng.serve([again], max_steps=200)
    assert again.out == want.out
    assert base.prefix_store is None and base.prefix_match_len(want) == 0


def test_engine_rejects_mismatched_store(tiny):
    eng = _engine(tiny, B=1, prefix_cache=True)
    with pytest.raises(ValueError, match="block size"):
        _engine(tiny, B=1, prefix_cache=PrefixBlockStore(8))
    with pytest.raises(ValueError, match="namespace"):
        _engine(tiny, B=1,
                prefix_cache=PrefixBlockStore(4, namespace=b"other"))
    # a geometry-identical sibling may share the store; an EMPTY store is
    # falsy (len 0), so this also pins the identity check
    sib = _engine(tiny, B=1, prefix_cache=eng.prefix_store)
    assert sib.prefix_store is eng.prefix_store
    assert len(eng.prefix_store) == 0


# ---------------------------------------------------------------------------
# cache-affinity admission: the port's scheduler and the JAX package's,
# driven on identical copies of the JAX tests' scripted fake backend (it
# reads only ``max_new_tokens`` and ``_match`` of a request), each with a
# clock that only the fake advances
# ---------------------------------------------------------------------------


class _ClockedFake(AffinityFake):
    """``AffinityFake`` whose admissions and steps advance a shared clock
    (by binary fractions, so both schedulers' waits compare exactly)."""

    def __init__(self, batch_size=1):
        super().__init__(batch_size)
        self.now = 0.0

    def sched_admit(self, state, slot, request):
        self.now += 0.25
        return super().sched_admit(state, slot, request)

    def sched_step(self, state):
        self.now += 1.0
        return super().sched_step(state)


class _NoProbe:
    """The same fake without ``prefix_match_len``: a backend that cannot
    score prefix matches (as an engine without a store scores every
    request 0)."""

    def __init__(self, batch_size=1):
        self._fake = _ClockedFake(batch_size)
        self.batch_size = batch_size
        self.sched_start = self._fake.sched_start
        self.sched_admit = self._fake.sched_admit
        self.sched_step = self._fake.sched_step

    @property
    def now(self):
        return self._fake.now


def _run(specs, batch_size=1, probe=True, per_step=None):
    """Serve ``specs`` (``(match, max_new_tokens)`` pairs) on the port's
    scheduler and on the JAX package's, ``per_step`` submitted before each
    step (None: all at once), and hold the two against each other: the
    admission order, ``affinity_reorders`` and every request's queue wait
    must be equal.  Returns the port's admission order (spec indices) and
    stats."""
    got = []
    for sched_cls, req_cls in ((ContinuousScheduler, Request),
                               (JScheduler, JRequest)):
        backend = (_ClockedFake if probe else _NoProbe)(batch_size)
        sched = sched_cls(backend, clock=lambda b=backend: b.now)
        reqs = []
        for match, new in specs:
            r = req_cls(prompt=[1], max_new_tokens=new)
            r._match = match
            reqs.append(r)
        todo = list(reqs)
        for _ in range(1000):
            take = len(todo) if per_step is None else per_step
            for r in todo[:take]:
                sched.submit(r)
            del todo[:take]
            if not todo and not sched.pending:
                break
            if sched.pending:
                sched.step()
        assert not todo and not sched.pending
        idx = {r.rid: i for i, r in enumerate(reqs)}
        got.append(([idx[r.rid] for r in sched.admission_order],
                    sched.stats.affinity_reorders,
                    list(sched.stats.queue_wait_s),
                    {idx[rid]: w
                     for rid, w in sched.stats.queue_wait_by_rid.items()},
                    sched.stats))
    assert got[0][:4] == got[1][:4]
    return got[0][0], got[0][4]


def test_affinity_admits_deepest_match_first():
    admitted, stats = _run([(0, 1), (8, 1), (16, 1)])
    assert admitted == [2, 1, 0]
    assert stats.affinity_reorders == 2
    assert len(stats.queue_wait_s) == 3 and min(stats.queue_wait_s) >= 0
    assert len(stats.queue_wait_by_rid) == 3


def test_affinity_ties_degrade_to_fifo():
    admitted, stats = _run([(4, 1)] * 4)
    assert admitted == [0, 1, 2, 3] and stats.affinity_reorders == 0


def test_affinity_starvation_bound_forces_jumped_head():
    """A cold head behind hot requests is jumped MAX_AFFINITY_SKIPS (4)
    times, then admitted."""
    assert MAX_AFFINITY_SKIPS == 4
    admitted, stats = _run([(0, 1)] + [(8, 1)] * 6)
    assert admitted[:5] == [1, 2, 3, 4, 0]
    assert sorted(admitted) == list(range(7))
    assert stats.affinity_reorders == 4


def test_affinity_window_bounds_lookahead():
    """The deepest match sits just past the AFFINITY_WINDOW (8): the
    oldest is admitted first, then the match, now inside the window."""
    assert AFFINITY_WINDOW == 8
    admitted, _ = _run([(0, 1)] * 8 + [(16, 1)])
    assert admitted[:2] == [0, 8]


def test_cache_affinity_off_is_pure_fifo():
    """A backend with no ``prefix_match_len`` is admitted FIFO."""
    admitted, stats = _run([(0, 1), (16, 1), (8, 1)], probe=False)
    assert admitted == [0, 1, 2] and stats.affinity_reorders == 0


def test_queue_wait_excludes_zero_budget_requests():
    admitted, stats = _run([(0, 1), (0, 0), (0, 1)])
    assert admitted == [0, 2]
    assert len(stats.queue_wait_s) == 2  # zero-budget: never admitted
    assert len(stats.queue_wait_by_rid) == 2
    s = stats.queue_wait_summary()
    assert 0 <= s["mean"] <= s["max"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("batch_size,per_step", [(1, None), (2, 2), (3, 1)])
def test_affinity_matches_reference_on_random_queues(seed, batch_size,
                                                     per_step):
    """Seeded queues of 24 requests (matches 0-16, budgets 0-3, some
    arriving mid-run): admission order, reorders and every wait equal the
    JAX scheduler's."""
    rng = np.random.default_rng(seed)
    specs = list(zip(rng.choice([0, 4, 8, 16], 24).tolist(),
                     rng.integers(0, 4, 24).tolist()))
    admitted, stats = _run(specs, batch_size, per_step=per_step)
    assert sorted(admitted) == [i for i, (_, n) in enumerate(specs) if n]


def _req(match=0, new=1):
    r = Request(prompt=[1], max_new_tokens=new)
    r._match = match
    return r


def test_queue_wait_reads_the_injected_clock():
    now = [10.0]
    reqs = [_req(), _req()]
    backend = AffinityFake()
    sched = ContinuousScheduler(backend, clock=lambda: now[0])
    for r in reqs:
        sched.submit(r)
    now[0] = 12.5
    sched.step()  # admits the first
    now[0] = 14.0
    sched.run(max_steps=10)
    assert sched.stats.queue_wait_s == [2.5, 4.0]


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_replays_a_scenario_with_the_prefix_cache(capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu --scenario
    chat --prefix-cache``: one line per tenant, the prefix-cache line, and
    the kernel-launch report."""
    from repro_torch.launch import serve

    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--scenario", "chat", "--prefix-cache"])
    out = capsys.readouterr().out
    tenants = {r.tenant for r in res.records}
    assert tenants == {"interactive", "batch"}
    assert all(r.t_done is not None for r in res.records)
    for name in tenants:
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"[serve]   {name}: "))
        assert "ttft p50/p95/p99" in line and "slo attainment" in line
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[serve] prefix cache: "))
    assert "block hits" in line and "published" in line
    assert "kernel launches: lut_onehot 0" in out
