"""Sharded serving in the port against the JAX package: the sharding rules
(``parallel/sharding.py``), the mesh (``launch/mesh.py``), ``ShardInfo``,
the exact collectives and ``DecodeEngine(mesh=...)`` run as 2 and 4
``gloo`` ranks on the CPU (``launch.mesh.run_ranks``: spawned processes,
a ``file://`` rendezvous, so no port is opened).

Tolerances, and why:
  * specs, per-device bytes, local problems: exact (the same rules).
  * the gathers and the disjoint sum: bitwise (integer sums of bytes that
    are nonzero on one rank only).
  * the sharded engine at 1x2, 2x1 and 2x2 (2 layers, d_model 64, 4 q
    heads, 1 kv head, replicated as bitnet's, or 2, sharded): its
    admission logits bitwise equal to the port's single-device engine's,
    and its canonical-greedy streams equal to that engine's.  Bitwise
    holds here on the CPU: a rank's projections compute whole output
    columns over the same K in the same order, its attention reads whole
    GQA groups, and the gathers move bytes (on the card the f32 hand
    kernels plan their K split from the column count and sum otherwise at
    half the columns; chip_smoke holds the logits to 2^-4 there).  Against
    the JAX single-device engine the streams are equal, or part only where
    the JAX logits' top-2 margin is under 2^-4 (``test_torch_serving.py``'s
    rule).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import _sharded_ranks
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.kernels import dispatch as jdispatch
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro.parallel import sharding as jsh
from repro.serving import engine as jengine
from repro_torch.configs import registry as treg
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as topt
from repro_torch.parallel import sharding as tsh
from repro_torch.serving import engine as tengine
from test_torch_serving import _jax_forced, _top2_margin

# the reference dry run forces 512 host devices through XLA_FLAGS when it
# is imported; its _sharded_bytes is read here, and the flag put back
# before JAX starts a backend
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

ARCH = "bitnet-b1.58-2b"
MESHES = ["1x2", "2x1", "2x2", "1x8", "2x4", "16x16", "2x16x16"]
TOL = 2.0 ** -4
MAX_LEN, CHUNK, NEW_TOKENS, BATCH = 48, 8, 6, 2


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _meshes(spec):
    axes, shape = tmesh.parse_mesh_spec(spec)
    return AbstractMesh(shape, axes), tmesh.Mesh(axes, shape)


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_specs(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


def _depth(cfg):
    kw = {"n_layers": 2}
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    return cfg.with_(**kw)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """Both packages' parameter and serving trees and serving cache at full
    width (2 layers: depth is a stacked, unsharded axis), shapes only."""
    tcfg = _depth(treg.get_config(arch))
    jcfg = _depth(jreg.get_config(arch))
    jparams = jax.eval_shape(functools.partial(jmodel.init_params, jcfg),
                             jax.random.PRNGKey(0))
    jpacked = jax.eval_shape(
        functools.partial(jdecode.quantize_for_serving, cfg=jcfg), jparams)
    jcache = jax.eval_shape(lambda: jdecode.init_cache(jcfg, 4, 64))
    with dryrun.fake_mode():
        tparams = tmodel.init_params(tcfg, torch.Generator(), "cpu")
        tpacked = tdecode.quantize_for_serving(tparams, tcfg)
    tcache = tdecode.init_cache(tcfg, 4, 64, device="meta")
    return tcfg, (jparams, jpacked, jcache), (tparams, tpacked, tcache)


# ---------------------------------------------------------------------------
# (a) the rules, tree for tree, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_specs_equal_the_reference_on_every_arch_and_mesh(arch):
    cfg, (jparams, jpacked, jcache), (tparams, tpacked, tcache) = \
        _trees(arch)
    heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads}
    B, V = 4, cfg.padded_vocab
    jstate = {"cache": jcache,
              "logits": jax.ShapeDtypeStruct((B, V), jnp.float32),
              **{k: jax.ShapeDtypeStruct((B,), jnp.int32)
                 for k in ("live", "index", "remaining", "stop")},
              "dcache": jcache}
    tstate = {"cache": tcache, "logits": torch.empty((B, V), device="meta"),
              **{k: torch.empty((B,), dtype=torch.int32, device="meta")
                 for k in ("live", "index", "remaining", "stop")},
              "dcache": tcache}
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    jslab = {k: jax.ShapeDtypeStruct((L, 8, Hkv, hd), jnp.bfloat16)
             for k in ("k", "v")}
    tslab = {k: torch.empty((L, 8, Hkv, hd), device="meta")
             for k in ("k", "v")}
    jbatch = {"tokens": jax.ShapeDtypeStruct((B, 16), jnp.int32),
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    tbatch = {"tokens": torch.empty((B, 16), device="meta"),
              "step": torch.empty((), device="meta")}
    for spec in MESHES:
        jm, tm = _meshes(spec)
        assert tsh.batch_axes(tm) == jsh.batch_axes(jm)
        for h in (None, heads):
            for jt, tt in ((jparams, tparams), (jpacked, tpacked)):
                assert _port_specs(tsh.param_specs(tt, tm, heads=h)) == \
                    _jax_specs(jsh.param_specs(jt, jm, heads=h)), (spec, h)
        for kv in (None, Hkv):
            assert _port_specs(tsh.cache_specs(tcache, tm, kv_heads=kv)) == \
                _jax_specs(jsh.cache_specs(jcache, jm, kv_heads=kv))
            assert _port_specs(tsh.engine_state_specs(
                tstate, tm, kv_heads=kv)) == _jax_specs(
                    jsh.engine_state_specs(jstate, jm, kv_heads=kv))
            assert _port_specs(tsh.block_slab_specs(
                tslab, tm, kv_heads=kv)) == _jax_specs(
                    jsh.block_slab_specs(jslab, jm, kv_heads=kv))
        assert _port_specs(tsh.batch_specs(tbatch, tm)) == \
            _jax_specs(jsh.batch_specs(jbatch, jm))


def test_bitnet_layout_is_column_parallel_with_global_scales():
    """bitnet at model=2: the packed rows of wq, wi, wg and both wo split,
    wk/wv whole (5 kv heads), the embedding and head on their last dim,
    every scale whole; at data=2, model=1 nothing split."""
    cfg, _, (_, packed, _) = _trees(ARCH)
    _, tm = _meshes("1x2")
    specs = tsh.param_specs(packed, tm, heads={"wq": cfg.n_heads,
                                               "wk": cfg.n_kv_heads})
    blk = specs["blocks"]
    for path in (("attn", "wq"), ("attn", "wo"), ("ffn", "wi"),
                 ("ffn", "wg"), ("ffn", "wo")):
        leaf = blk[path[0]][path[1]]
        assert leaf["packed"] == (None, "model", None), path
        assert leaf["scale"] == (None,), path
    assert blk["attn"]["wk"]["packed"] == (None, None, None)
    assert specs["embed"]["w"] == (None, "model")
    assert specs["lm_head"]["w"] == (None, "model")
    assert tsh.shard_count(blk["attn"]["wk"]["packed"], tm) == 1
    _, tm = _meshes("2x1")
    assert all(tsh.shard_count(s, tm) == 1 for s in _port_specs(
        tsh.param_specs(packed, tm)).values())


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "train_4k"),
                                        ("qwen3-0.6b", "decode_32k"),
                                        ("phi3.5-moe-42b-a6.6b", "train_4k")])
def test_dry_run_per_device_bytes_equal_the_reference(arch, shape, mesh):
    """``launch/dryrun.py --mesh``: each tree's per-device bytes equal the
    reference's ``_sharded_bytes`` on the same trees and mesh."""
    rec = dryrun.mesh_cell(arch, shape, mesh, "cpu")
    jm, _ = _meshes(mesh)
    jcfg, jshape, jspecs = jreg.input_specs(arch, shape)
    params = jax.eval_shape(functools.partial(jmodel.init_params, jcfg),
                            jax.random.PRNGKey(0))
    pspecs = jsh.param_specs(params, jm)
    assert rec["param_bytes_per_device"] == jdryrun._sharded_bytes(
        params, pspecs, jm)
    if jshape.kind == "train":
        opt = jopt.make_optimizer(jcfg.optimizer)
        state = jax.eval_shape(opt.init, params)
        assert rec["state_bytes_per_device"] == jdryrun._sharded_bytes(
            state, opt.state_specs(pspecs, params), jm)
        return
    packed = jax.eval_shape(functools.partial(jdecode.quantize_for_serving,
                                              cfg=jcfg), params)
    assert rec["packed_bytes_per_device"] == jdryrun._sharded_bytes(
        packed, jsh.param_specs(packed, jm), jm)
    assert rec["cache_bytes_per_device"] == jdryrun._sharded_bytes(
        jspecs["cache"], jsh.cache_specs(jspecs["cache"], jm), jm)
    assert rec["mesh"] == mesh and rec["chips"] == jm.size


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_state_specs_equal_the_reference(name):
    cfg, (jparams, _, _), (tparams, _, _) = _trees("qwen3-0.6b")
    jm, tm = _meshes("2x4")
    jopt_ = jopt.make_optimizer(name)
    want = _jax_specs(jopt_.state_specs(jsh.param_specs(jparams, jm),
                                        jparams))
    got = _port_specs(topt.make_optimizer(name).state_specs(
        tsh.param_specs(tparams, tm), tparams))
    assert got == want


def test_local_shard_cuts_each_rank_its_piece():
    whole = torch.arange(2 * 8 * 4).reshape(2, 8, 4)
    pieces = {}
    for rank in range(4):
        m = tmesh.Mesh(("data", "model"), (2, 2), tmesh._coords(rank, (2, 2)))
        pieces[rank] = tsh.local_shard(whole, (None, ("data", "model"), None),
                                       m)
        assert tsh.local_shape(whole.shape, (None, ("data", "model"), None),
                               m) == tuple(pieces[rank].shape)
    assert torch.equal(torch.cat([pieces[r] for r in range(4)], 1), whole)
    m = tmesh.Mesh(("data", "model"), (2, 2), (1, 0))
    assert tsh.local_shard(whole, (None, None, None), m) is whole


# ---------------------------------------------------------------------------
# (b) ShardInfo and the autotune keys, the reference's cases
# ---------------------------------------------------------------------------


def test_shard_info_equals_the_reference_on_its_cases():
    cases = [((4, 2, 2, 0, 0), "wi", (8, 128, 256)),
             ((4, 2, 2, 0, 0), "wo", (8, 256, 128)),
             ((4, 2, 2, 0, 0), None, (8, 128, 256)),
             ((4, 2, 2, 0, 0), "wi", (8, 128, 102)),
             ((4, 2, 2, 0, 0), "wi", (3, 128, 256)),
             ((4, 1, 1, 4, 1), "wq", (2, 128, 128)),
             ((4, 1, 1, 4, 1), "wk", (2, 128, 32)),
             ((4, 1, 1, 4, 1), "wv", (2, 128, 32)),
             ((4, 1, 1, 0, 0), "wk", (2, 128, 32)),
             ((4, 1, 1, 0, 0), "wz", (2, 128, 256)),
             ((4, 2, 1, 0, 0), "wz", (2, 128, 256)),
             ((2, 1, 1, 0, 0), "up", (2, 128, 256)),
             ((4, 1, 1, 0, 0), "ffn_up", (2, 128, 256)),
             ((2, 1, 1, 0, 0), "wx", (2, 128, 256)),
             ((1, 1, 1, 0, 0), "wx", (2, 128, 256))]
    for geo, role, mkn in cases:
        j = jdispatch.ShardInfo(*geo)
        t = tdispatch.ShardInfo(*geo)
        assert t.local_dense(role, *mkn) == j.local_dense(role, *mkn)
    # the reference's literal expectations
    info = tdispatch.ShardInfo(model=4, data=2, batch=2)
    assert info.local_dense("wi", 8, 128, 256) == (4, 128, 64)
    assert info.local_dense("wo", 8, 256, 128) == (4, 256, 32)
    assert info.local_dense(None, 8, 128, 256) == (4, 128, 256)
    assert info.local_dense("wi", 8, 128, 102) == (4, 128, 102)
    assert info.local_dense("wi", 3, 128, 256) == (3, 128, 64)
    gated = tdispatch.ShardInfo(model=4, n_heads=4, n_kv_heads=1)
    assert gated.local_dense("wq", 2, 128, 128) == (2, 128, 32)
    assert gated.local_dense("wk", 2, 128, 32) == (2, 128, 32)
    assert tdispatch.ShardInfo(model=4).local_dense("wk", 2, 128, 32) == \
        (2, 128, 8)
    assert tdispatch.ShardInfo(model=4).local_dense("wz", 2, 128, 256) == \
        (2, 128, 64)
    assert tdispatch.ShardInfo(model=4, data=2).local_dense(
        "wz", 2, 128, 256) == (2, 128, 256)
    ep = tdispatch.ShardInfo(model=2, data=2, batch=2)
    for role, prob in (("wi", (8, 4, 128, 256)), ("wo", (8, 4, 256, 128)),
                       ("wi", (7, 4, 128, 256))):
        assert ep.local_grouped(role, *prob) == jdispatch.ShardInfo(
            model=2, data=2, batch=2).local_grouped(role, *prob)
    assert ep.local_grouped("wi", 8, 4, 128, 256) == (4, 4, 128, 128)
    assert ep.local_grouped("wo", 8, 4, 256, 128) == (4, 4, 128, 128)
    assert ep.local_grouped("wi", 7, 4, 128, 256) == (7, 4, 128, 128)


def test_shard_scope_restores_on_exit():
    assert tdispatch.current_shard_info() is None
    with tdispatch.shard_scope(tdispatch.ShardInfo(model=2)):
        assert tdispatch.current_shard_info() == tdispatch.ShardInfo(model=2)
        with tdispatch.shard_scope(None):
            assert tdispatch.current_shard_info() is None
        assert tdispatch.current_shard_info() == tdispatch.ShardInfo(model=2)
    assert tdispatch.current_shard_info() is None


def test_autotune_key_uses_local_problem(tmp_path):
    cache = tdispatch.AutotuneCache(path=str(tmp_path / "a.json"))
    cache.record(4, 128, 64, "float32", "cpu", "dequant_packed", 1.0)
    cache.record(4, 128, 64, "float32", "cpu", "ref", 9.0)
    with tdispatch.shard_scope(tdispatch.ShardInfo(model=4, data=2, batch=2)):
        spec = tdispatch.select_kernel(8, 128, 256, "float32", policy="auto",
                                       device="cpu", cache=cache, role="wi")
    assert spec.name == "dequant_packed"
    spec = tdispatch.select_kernel(8, 128, 256, "float32", policy="auto",
                                   device="cpu", cache=cache, role="wi")
    assert spec.name == "ref"
    cache.save()
    import json

    doc = json.loads((tmp_path / "a.json").read_text())
    assert doc["schema_version"] == 2
    assert "M4:K128:N64:mu3:float32:cpu" in doc["entries"]


def test_grouped_autotune_key_uses_local_problem(tmp_path):
    cache = tdispatch.AutotuneCache(path=str(tmp_path / "a.json"))
    cache.record(4, 128, 128, "float32", "cpu", "grouped_dequant", 1.0, e=4)
    cache.record(4, 128, 128, "float32", "cpu", "grouped_ref", 9.0, e=4)
    with tdispatch.shard_scope(tdispatch.ShardInfo(model=2, data=2, batch=2)):
        spec = tdispatch.select_kernel(4, 256, 128, "float32", policy="auto",
                                       device="cpu", cache=cache, e=8,
                                       role="wo")
    assert spec.name == "grouped_dequant"
    assert "E4:M4:K128:N128:mu3:float32:cpu" in cache.entries


# ---------------------------------------------------------------------------
# the mesh and the collectives
# ---------------------------------------------------------------------------


def test_mesh_specs_and_production_meshes():
    assert tmesh.parse_mesh_spec("2x4") == (("data", "model"), (2, 4))
    assert tmesh.parse_mesh_spec("2x16x16") == (("pod", "data", "model"),
                                                (2, 16, 16))
    for bad in ("2by2", "2", "0x2", "1x2x3x4"):
        with pytest.raises(ValueError, match="mesh"):
            tmesh.parse_mesh_spec(bad)
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).size == \
        tmesh.CHIPS_MULTI_POD
    assert tmesh.make_mesh_for(8, 2).shape == {"data": 4, "model": 2}
    # row-major rank coordinates, as jax.make_mesh lays devices out
    assert [tmesh._coords(r, (2, 2)) for r in range(4)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(RuntimeError, match="initialized"):
        tmesh.make_serving_mesh("1x2")
    with pytest.raises(ValueError, match="backend"):
        tmesh.run_ranks(_sharded_ranks.gathers, "1x2", backend="mpi")


def test_gathers_are_bitwise_on_a_2x2_gloo_mesh():
    for r in _sharded("2x2")["gathers"]:
        assert np.array_equal(r["last"], r["want_last"])       # -0.0 kept
        assert np.array_equal(r["batch"], r["want_batch"])
        assert np.array_equal(r["disjoint"], r["want_disjoint"])
        assert r["stats"]["calls"] == 3


def test_a_rank_without_a_card_fails_the_run():
    """No fallback: the ranks run on cuda unless told otherwise, and a
    rank that cannot stops every rank and raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.run_ranks(_sharded_ranks.gathers, "1x2", backend="gloo",
                        args=(3,), timeout=120)


# ---------------------------------------------------------------------------
# (c) the sharded engine against the port's and the JAX engine's
# ---------------------------------------------------------------------------


def _configs(kv):
    over = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=kv,
                head_dim=16, d_ff=128)
    return (jreg.get_smoke_config(ARCH).with_(**over),
            treg.get_smoke_config(ARCH).with_(**over))


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(2, 512, size=n).tolist() for n in (3, 11, 17, 6)]


@functools.lru_cache(maxsize=None)
def _references(kv):
    """The converted tree, the JAX engine and its streams, and the port's
    single-device streams (``serve()`` and ``run()``), admission logits and
    shape universe."""
    jcfg, tcfg = _configs(kv)
    js = jdecode.quantize_for_serving(
        jmodel.init_params(jcfg, jax.random.PRNGKey(5)), jcfg)
    jeng = jengine.DecodeEngine(
        js, jcfg, batch_size=BATCH, max_len=MAX_LEN, prefill_chunk=CHUNK,
        sampler=jengine.SamplerConfig(canonical_greedy=True))
    jreqs = [jengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
             for p in _prompts()]
    jeng.serve(jreqs)
    jstreams = [r.out for r in jreqs]
    tree = from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
    teng = tengine.DecodeEngine(
        tree, tcfg, batch_size=BATCH, max_len=MAX_LEN, prefill_chunk=CHUNK,
        device="cpu", sampler=tengine.SamplerConfig(canonical_greedy=True))
    treqs = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
             for p in _prompts()]
    teng.serve(treqs)
    gen = [tengine.Request(prompt=p, max_new_tokens=NEW_TOKENS)
           for p in _prompts()[:BATCH]]
    teng.run(gen)
    state = teng.sched_admit(teng.sched_start(), 0,
                             tengine.Request(prompt=_prompts()[0]))
    return (tcfg, tree, (js, jcfg, jstreams), [r.out for r in treqs],
            [r.out for r in gen], state["logits"][0].numpy(),
            teng.matmul_shape_universe())


def _local_universe(universe, mesh, cfg):
    """The single-device universe's problems as a rank of ``mesh`` runs
    them (decode rows split over data where they divide)."""
    _, shape = tmesh.parse_mesh_spec(mesh)
    data, model = shape
    out = set()
    for m, k, n in universe:
        rows = m // data if m == BATCH and BATCH % data == 0 else m
        cols = n
        if n != cfg.kv_dim or cfg.n_kv_heads % model == 0:
            cols = n // model
        out.add((rows, k, cols))
    return sorted(out)


KV_HEADS = (1, 2)


@functools.lru_cache(maxsize=None)
def _sharded(mesh):
    """Both configs' sharded engines on one spawn of the mesh's ranks:
    ``{kv: [rank results]}``."""
    models = [_references(kv)[:2] for kv in KV_HEADS]
    out = tmesh.run_ranks(
        _sharded_ranks.serve_on_mesh, mesh, backend="gloo", device="cpu",
        args=([(tree, cfg) for cfg, tree in models], _prompts(), NEW_TOKENS,
              BATCH, MAX_LEN, CHUNK), timeout=240)
    return {"gathers": [rank["gathers"] for rank in out],
            **{kv: [rank["models"][i] for rank in out]
               for i, kv in enumerate(KV_HEADS)}}


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
@pytest.mark.parametrize("kv", KV_HEADS)
def test_sharded_engine_equals_single_device(kv, mesh):
    tcfg, tree, (js, jcfg, jstreams), streams, run_streams, logits, \
        universe = _references(kv)
    _, (data, model) = tmesh.parse_mesh_spec(mesh)
    for rank in _sharded(mesh)[kv]:
        assert rank["streams"] == streams
        assert rank["run_streams"] == run_streams
        assert np.array_equal(rank["logits"], logits)
        assert rank["universe"] == _local_universe(universe, mesh, tcfg)
        kv_local = kv // model if kv % model == 0 else kv
        assert rank["cache_shape"][1:4:2] == (BATCH // data, kv_local)
        assert rank["stats"]["calls"] > 0
    for prompt, s, jout in zip(_prompts(), streams, jstreams):
        t = next((t for t, (a, b) in enumerate(zip(s, jout)) if a != b),
                 None)
        if t is not None:   # the JAX logits' margin where the streams part
            margin = _top2_margin(_jax_forced(jcfg)(js, prompt, jout))[t]
            assert margin < TOL, (t, s[t], jout[t], margin)


@pytest.mark.parametrize("kwarg,what", [
    ({"cfg": "phi3.5-moe-42b-a6.6b"}, "MoE"),
    ({"cfg": "zamba2-2.7b"}, "zamba2"),
    ({"cfg": "whisper-large-v3"}, "whisper"),
    ({"cfg": "internvl2-2b"}, "internvl2")])
def test_engine_refuses_what_no_slice_shards_yet(kwarg, what):
    cfg = treg.get_smoke_config(kwarg["cfg"])
    with pytest.raises(NotImplementedError, match="later slice"):
        tengine.DecodeEngine({}, cfg, batch_size=2, max_len=16, device="cpu",
                             mesh=tmesh.make_mesh_for(2, 2))


def test_serve_launcher_with_a_mesh_on_the_cpu(capfd):
    """``launch.serve --mesh 1x2 --dist-backend gloo --device cpu``: rank
    0's streams equal the single-device launcher's."""
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--requests", "3", "--new-tokens", "4"]
    single = [r.out for r in serve.main(argv)]
    sharded = [r.out for r in serve.main(
        argv + ["--mesh", "1x2", "--dist-backend", "gloo"])]
    assert sharded == single
    assert "mesh 1x2 (gloo), 2 ranks" in capfd.readouterr().out
