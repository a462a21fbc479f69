"""The port's ternary-matmul kernels and dispatch against the JAX package.

On the CPU the plain PyTorch versions are held against the Pallas kernels
(interpret mode) on ragged shapes; the CUDA kernels themselves are held
against the plain versions by ``tests/test_torch_cuda.py``, which runs only
where there is a card (``python3 chip_smoke.py`` does the same at the
model's shapes).  ``w2a8`` is held against the int64 numpy product instead
of its Pallas kernel, which does not compile in interpret mode for some
padded shapes on this JAX version.

Tolerance for float inputs: both sides accumulate in f32 in different
orders, so results agree to a few f32 ulps of the row's absolute sum
(atol = 1e-5 · max_b Σ_k |x[b, k]|).  int8 inputs make every partial sum an
integer below 2^24, so those results are exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import encoding as jenc
from repro.core import quantization as jquant
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels.dequant_matmul import packed_matmul as j_packed_matmul
from repro.kernels.lut_matmul import lut_matmul as j_lut_matmul
from repro.kernels.signflip_matmul import signflip_matmul as j_signflip_matmul
from repro.kernels.tl2_matmul import pack_tl2 as j_pack_tl2
from repro.kernels.tl2_matmul import tl2_matmul as j_tl2_matmul
from repro_torch.core import encoding as tenc
from repro_torch.kernels import dequant_matmul as tdeq
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import lut_matmul as tlut
from repro_torch.kernels import ops as tops
from repro_torch.kernels import signflip_matmul as tsf
from repro_torch.kernels import tl2_matmul as ttl2
from repro_torch.kernels import w2a8_matmul as tw2a8


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _atol(x):
    return 1e-5 * float(np.abs(np.asarray(x, np.float64)).sum(-1).max()) + 1e-6


def _case(seed, B, O, K, int8=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-127, 128, size=(B, K)).astype(np.int8) if int8
         else rng.normal(size=(B, K)).astype(np.float32))
    w = rng.integers(-1, 2, size=(O, K)).astype(np.int8)
    return x, w


# ragged B, O and K (K not a multiple of mu=3 or of 10)
RAGGED = [(3, 37, 50), (9, 130, 301)]


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_lut_matches_pallas_gather(B, O, K):
    x, w = _case(0, B, O, K)
    keys = np.array(jenc.encode_weight_matrix(jnp.asarray(w), 3))
    xp = np.pad(x, ((0, 0), (0, keys.shape[1] * 3 - K)))
    want = np.asarray(j_lut_matmul(jnp.asarray(xp), jnp.asarray(keys), 3,
                                   fetch="gather", interpret=True))
    got = tlut.lut_matmul(torch.from_numpy(xp), torch.from_numpy(keys), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(x))
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ w.T.astype(np.float64),
                               rtol=0, atol=_atol(x))


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_tl2_matches_pallas(B, O, K):
    x, w = _case(1, B, O, K)
    words = np.asarray(j_pack_tl2(jnp.asarray(w)))
    want = np.asarray(j_tl2_matmul(jnp.asarray(x), jnp.asarray(words), K,
                                   interpret=True))
    tw = torch.from_numpy(words.view(np.int16))
    got = ttl2.tl2_matmul(torch.from_numpy(x), tw, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(x))


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_int8_activations_exact(B, O, K):
    x, w = _case(2, B, O, K, int8=True)
    want = x.astype(np.int64) @ w.T.astype(np.int64)
    tw = ttl2.pack_tl2(torch.from_numpy(w))
    got = ttl2.tl2_matmul(torch.from_numpy(x), tw, K)
    assert np.array_equal(got.numpy().astype(np.int64), want)
    keys = tenc.encode_weight_matrix(torch.from_numpy(w), 3)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, keys.shape[1] * 3 - K))
    got = tlut.lut_matmul(xp, keys, 3)
    assert np.array_equal(got.numpy().astype(np.int64), want)


BITNET_KN = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560)]


@pytest.mark.parametrize("act", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 32, 256])
def test_prior_on_cuda_matches_jax_prior_on_tpu(m, act):
    for k, n in BITNET_KN:
        want = jdispatch.select_kernel(m, k, n, act, policy="prior",
                                       backend="tpu").name
        got = tdispatch.select_kernel(m, k, n, act, policy="prior",
                                      device="cuda").name
        assert got == want, (m, k, n, act)
    # off the card the hand kernels lose to the plain entries (ref, or
    # tl2_ref at large M), as the reference's prior off its accelerator
    off = tdispatch.select_kernel(m, 2560, 2560, act, policy="prior",
                                  device="cpu")
    assert not off.hand
    assert off.name == jdispatch.select_kernel(m, 2560, 2560, act,
                                               policy="prior",
                                               backend="cpu").name


def test_fixed_unported_kernel_raises_keyerror_listing_kernels():
    """Every TPU kernel is ported, so the only unknown pin is a bogus name:
    it raises listing all twelve kernels, dense and grouped; a grouped
    kernel pinned on a dense problem is refused as unsupported."""
    listed = ("dequant_packed.*grouped_dequant.*grouped_ref.*grouped_tl2.*"
              "grouped_w2a8.*lut_gather.*lut_onehot.*ref.*signflip.*tl2.*"
              "tl2_ref.*w2a8")
    with pytest.raises(KeyError, match=listed):
        tdispatch.select_kernel(4, 64, 64, "bfloat16", policy="fixed:bogus")
    with pytest.raises(ValueError, match="does not support"):
        tdispatch.select_kernel(4, 64, 64, "bfloat16",
                                policy="fixed:grouped_dequant")


def test_autotune_cache_roundtrip_steers_auto(tmp_path):
    cache = tdispatch.AutotuneCache(path=str(tmp_path / "c.json"))
    cache.record(4, 64, 32, "bfloat16", "cpu", "tl2", 1.0)
    cache.record(4, 64, 32, "bfloat16", "cpu", "ref", 2.0)
    cache.save()
    loaded = tdispatch.AutotuneCache.load(cache.path)
    assert loaded.entries == cache.entries
    assert tdispatch.select_kernel(4, 64, 32, "bfloat16", device="cpu",
                                   cache=loaded).name == "tl2"
    assert tdispatch.select_kernel(4, 64, 32, "bfloat16", device="cpu",
                                   policy="prior", cache=loaded).name == "ref"


def test_autotune_cache_reads_schema_2_only(tmp_path):
    path = tmp_path / "old.json"
    path.write_text('{"schema_version": 1, "entries": '
                    '{"M4:K64:N32:mu3:bfloat16:cpu": {"tl2": 1.0}}}')
    assert tdispatch.AutotuneCache.load(str(path)).entries == {}


def test_selection_is_memoized_until_the_process_cache_changes(tmp_path):
    first = tdispatch.select_kernel(4, 64, 32, "bfloat16", device="cpu")
    assert first.name == "ref"
    assert tdispatch.select_kernel(4, 64, 32, "bfloat16", device="cpu") is first
    tdispatch.get_autotune_cache().record(4, 64, 32, "bfloat16", "cpu", "tl2", 1.0)
    assert tdispatch.select_kernel(4, 64, 32, "bfloat16", device="cpu").name == "tl2"
    tdispatch.reset_autotune_cache()
    assert tdispatch.select_kernel(4, 64, 32, "bfloat16", device="cpu").name == "ref"


def test_ternary_weight_derives_encodings_once():
    _, w = _case(3, 1, 24, 47)
    packed = tenc.pack_base3(torch.from_numpy(w))
    tw = tdispatch.TernaryWeight.from_packed(packed, 1.0, 47)
    assert tw.keys() is tw.keys() and tw.tl2() is tw.tl2()
    assert np.array_equal(tenc.decode_groups(tw.keys(), 3).reshape(24, -1)[:, :47],
                          w)
    assert np.array_equal(ttl2.unpack_tl2(tw.tl2(), 47).numpy(), w)


@pytest.mark.parametrize("policy", [
    "fixed:ref", "fixed:lut_gather", "fixed:tl2", "fixed:lut_onehot",
    "fixed:dequant_packed", "fixed:signflip", "fixed:tl2_ref"])
def test_ternary_matmul_scales_and_casts(policy):
    x, w = _case(4, 5, 20, 33)
    tw = tdispatch.TernaryWeight.from_ternary(torch.from_numpy(w), 0.5)
    y = tdispatch.ternary_matmul(torch.from_numpy(x).to(torch.bfloat16), tw,
                                 policy=policy)
    assert y.dtype == torch.bfloat16 and y.shape == (5, 20)
    want = (np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
            @ w.T.astype(np.float32)) * 0.5
    np.testing.assert_allclose(y.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU must reach the kernel or raise; the meta device
    stands in for a device whose kernel cannot run here."""
    x = torch.empty((2, 30), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ttl2.tl2_matmul(x, torch.empty((4, 3), dtype=torch.int16, device="meta"), 30)
    with pytest.raises(ValueError, match="CUDA"):
        tlut.lut_matmul(x, torch.empty((4, 10), dtype=torch.uint8, device="meta"), 3)


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """The kernels are built from source on first use; without nvcc the
    build raises, and nothing hands the work to the plain version."""
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("tl2_matmul")
    assert not (tmp_path / "build").exists()


def _served_packed(w: np.ndarray) -> np.ndarray:
    """Base-3 bytes with the serving artifact's 128-byte row padding (byte
    0, five -1 trits each, past the logical K)."""
    packed = np.asarray(jenc.pack_base3(jnp.asarray(w)))
    return np.pad(packed, ((0, 0), (0, (-packed.shape[1]) % 128)))


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_lut_onehot_matches_pallas_onehot(B, O, K):
    x, w = _case(20, B, O, K)
    keys = np.array(jenc.encode_weight_matrix(jnp.asarray(w), 3))
    xp = np.pad(x, ((0, 0), (0, keys.shape[1] * 3 - K)))
    want = np.asarray(j_lut_matmul(jnp.asarray(xp), jnp.asarray(keys), 3,
                                   fetch="onehot", interpret=True))
    got = tlut.lut_onehot_matmul(torch.from_numpy(xp), torch.from_numpy(keys), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(x))
    # the two fetches give the same sums: every other one-hot product is 0
    gathered = tlut.lut_matmul(torch.from_numpy(xp), torch.from_numpy(keys), 3)
    np.testing.assert_allclose(got.numpy(), gathered.numpy(), rtol=0,
                               atol=_atol(x))


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_packed_matches_pallas(B, O, K):
    x, w = _case(21, B, O, K)
    packed = _served_packed(w)
    want = np.asarray(j_packed_matmul(jnp.asarray(x), jnp.asarray(packed), K,
                                      interpret=True))
    got = tdeq.packed_matmul(torch.from_numpy(x), torch.from_numpy(packed), K)
    assert got.dtype == torch.float32 and got.shape == (B, O)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(x))
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ w.T,
                               rtol=0, atol=_atol(x))


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_signflip_matches_pallas(B, O, K):
    x, w = _case(22, B, O, K)
    want = np.asarray(j_signflip_matmul(jnp.asarray(x), jnp.asarray(w),
                                        interpret=True))
    got = tsf.signflip_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (B, O)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(x))


# (rows, cols, dtype, row stride of the view): the signflip kernel copies 16
# bytes at a time, so it is handed rows that each start 16-byte aligned
@pytest.mark.parametrize("rows,cols,dtype,stride", [
    (640, 6912, torch.int8, 7040),      # served trits: rows padded to 128 B
    (640, 50, torch.int8, 55), (3, 50, torch.int8, 50),
    (4, 2560, torch.bfloat16, 2560), (4, 301, torch.float32, 301),
    (1, 301, torch.float32, 301)])
def test_signflip_rows_read_in_place_only_where_aligned(rows, cols, dtype,
                                                         stride):
    t = torch.arange(rows * stride).reshape(rows, stride).to(dtype)[:, :cols]
    got, ld = tsf._rows(t)
    assert torch.equal(got, t) and got.stride(1) == 1
    assert ld * t.element_size() % 16 == 0 and got.data_ptr() % 16 == 0
    assert rows == 1 or got.stride(0) == ld
    aligned = rows == 1 or stride * t.element_size() % 16 == 0
    assert (got.data_ptr() == t.data_ptr()) == aligned


def test_autotune_times_the_weight_laid_out_as_served(monkeypatch):
    """Autotune's base-3 rows are padded to 128 bytes as the serving
    artifact's are, so the trits' rows start every 640 bytes."""
    strides = []
    spec = tdispatch.REGISTRY["signflip"]

    def run(x2, w, mu):
        strides.append(w.trits().stride(0))
        return spec.run(x2, w, mu)

    monkeypatch.setitem(tdispatch.REGISTRY, "signflip",
                        dataclasses.replace(spec, run=run))
    cache = tdispatch.AutotuneCache(path="unused.json")
    us = tdispatch.autotune(2, 20, 9, "float32", kernels=["signflip"], reps=1,
                            device="cpu", cache=cache, save=False)
    assert set(us) == {"signflip"} and strides and set(strides) == {640}


@pytest.mark.parametrize("B,O,K", RAGGED + [(4, 64, 2560), (2, 16, 6912)])
def test_plain_w2a8_exact_against_int64_product(B, O, K):
    x, w = _case(23, B, O, K, int8=True)
    got = tw2a8.w2a8_matmul(torch.from_numpy(x),
                            torch.from_numpy(_served_packed(w)), K)
    assert got.dtype == torch.int32 and got.shape == (B, O)
    assert np.array_equal(got.numpy().astype(np.int64),
                          x.astype(np.int64) @ w.T.astype(np.int64))


def test_w2a8_refuses_float_activations():
    x, w = _case(24, 2, 8, 30)
    packed = torch.from_numpy(_served_packed(w))
    with pytest.raises(ValueError, match="int8"):
        tw2a8.w2a8_matmul(torch.from_numpy(x), packed, 30)
    with pytest.raises(ValueError, match="does not support act_dtype=bfloat16"):
        tdispatch.select_kernel(2, 30, 8, "bfloat16", policy="fixed:w2a8")


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_w2a8_linear_matches_jax_quantize_and_int64_product(B, O, K):
    x, w = _case(25, B, O, K)
    x[0] = 0.0                                   # an all-zero token row
    packed = _served_packed(w)
    w_scale = np.float32(0.37)
    xq, xs = jquant.quantize_activations_int8(jnp.asarray(x))
    prod = np.asarray(xq).astype(np.int64) @ w.T.astype(np.int64)
    want = (prod.astype(np.float32) * np.asarray(xs)) * w_scale
    got = tw2a8.w2a8_linear(torch.from_numpy(x), torch.from_numpy(packed),
                            w_scale, K)
    assert got.dtype == torch.float32 and got.shape == (B, O)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_ops_linears_and_encoders_match_jax(B, O, K):
    """bf16 master weights, as the models hold them: the absmean scale is
    then the same bf16 value on both sides, and so are keys and bytes."""
    rng = np.random.default_rng(26)
    master = rng.normal(size=(O, K)).astype(np.float32)
    jmaster = jnp.asarray(master, jnp.bfloat16)
    tmaster = torch.from_numpy(master).to(torch.bfloat16)
    x = rng.normal(size=(2, B, K)).astype(np.float32)
    jkeys, jscale = jops.encode_for_lut(jmaster, 3)
    tkeys, tscale = tops.encode_for_lut(tmaster, 3)
    assert np.array_equal(tkeys.numpy(), np.asarray(jkeys))
    assert float(tscale) == float(jscale)
    jpacked, _ = jops.encode_packed(jmaster)
    tpacked, _ = tops.encode_packed(tmaster)
    assert np.array_equal(tpacked.numpy(), np.asarray(jpacked))
    w_t = np.asarray(jquant.ternarize(jmaster)[0])
    xp = np.pad(x, ((0, 0), (0, 0), (0, jkeys.shape[1] * 3 - K)))
    atol = _atol(x.reshape(-1, K)) * float(jscale)
    pairs = [
        (jops.ternary_linear_lut(jnp.asarray(xp), jkeys, jscale, 3),
         tops.ternary_linear_lut(torch.from_numpy(xp), tkeys, tscale, 3)),
        (jops.ternary_linear_lut(jnp.asarray(xp), jkeys, jscale, 3,
                                 fetch="gather"),
         tops.ternary_linear_lut(torch.from_numpy(xp), tkeys, tscale, 3,
                                 fetch="gather")),
        (jops.ternary_linear_signflip(jnp.asarray(x), jnp.asarray(w_t), jscale),
         tops.ternary_linear_signflip(torch.from_numpy(x),
                                      torch.from_numpy(w_t), tscale)),
        (jops.ternary_linear_packed(jnp.asarray(x), jpacked, jscale, K),
         tops.ternary_linear_packed(torch.from_numpy(x), tpacked, tscale, K)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32 and got.shape == (2, B, O)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)


def test_registry_is_the_jax_dense_registry():
    """The dense registry, and since the MoE slice the grouped one behind
    it: the same names in the same order, dtypes, hand kernels where the
    reference has Pallas kernels, and grouped counterparts."""
    dense = [s.name for s in jdispatch.REGISTRY.values() if not s.grouped]
    assert [s.name for s in tdispatch.REGISTRY.values() if not s.grouped] \
        == dense
    assert list(tdispatch.REGISTRY) == list(jdispatch.REGISTRY)
    for name, spec in tdispatch.REGISTRY.items():
        j = jdispatch.REGISTRY[name]
        assert spec.act_dtypes == j.act_dtypes, name
        assert spec.hand == j.pallas, name
        assert (spec.grouped, spec.grouped_variant) == \
            (j.grouped, j.grouped_variant), name


def test_ternary_weight_packs_trits_once():
    _, w = _case(27, 1, 24, 47)
    tw = tdispatch.TernaryWeight.from_ternary(torch.from_numpy(w))
    assert tw.packed() is tw.packed()
    assert np.array_equal(tw.packed().numpy(),
                          np.asarray(jenc.pack_base3(jnp.asarray(w))))
    packed = tenc.pack_base3(torch.from_numpy(w))
    assert tdispatch.TernaryWeight.from_packed(packed, 1.0, 47).packed() is packed


@pytest.mark.parametrize("act", ["float32", "int8"])
def test_autotune_measures_every_eligible_kernel_and_auto_uses_it(act, tmp_path):
    timings = tdispatch.autotune(2, 20, 9, act, reps=1, device="cpu")
    want = {s.name for s in tdispatch.eligible_kernels(2, 20, 9, act)}
    assert set(timings) == want and ("w2a8" in want) == (act == "int8")
    assert all(t > 0 for t in timings.values())
    path = tmp_path / "at.json"
    assert path.exists()
    best = min(timings, key=timings.get)
    assert tdispatch.select_kernel(2, 20, 9, act, device="cpu").name == best
    # the entry survives a cold reload, keyed on the CPU backend
    tdispatch.reset_autotune_cache()
    assert tdispatch.select_kernel(2, 20, 9, act, device="cpu").name == best
    # a time taken on the CPU never steers dispatch on the card
    assert tdispatch.select_kernel(2, 20, 9, act, device="cuda") is \
        tdispatch.select_kernel(2, 20, 9, act, device="cuda", policy="prior")


def test_autotune_propagates_a_kernel_failure(monkeypatch):
    def boom(x2, w, mu):
        raise RuntimeError("kernel launch failed")

    spec = tdispatch.REGISTRY["dequant_packed"]
    monkeypatch.setitem(tdispatch.REGISTRY, "dequant_packed",
                        dataclasses.replace(spec, run=boom))
    cache = tdispatch.AutotuneCache(path="unused.json")
    with pytest.raises(RuntimeError, match="launch failed"):
        tdispatch.autotune(2, 20, 9, "float32", reps=1, device="cpu",
                           cache=cache, save=False)


def test_autotune_refuses_to_record_for_another_backend():
    with pytest.raises(ValueError, match="cannot record"):
        tdispatch.autotune(2, 20, 9, "float32", reps=1, device="cpu",
                           backend="cuda", save=False)
