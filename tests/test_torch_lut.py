"""The LUT kernels' inputs as served, on the CPU: keys read at a padded row
stride, x of the weight's logical width (the last group short), and the
dispatch path that hands both to the wrappers without a pad or a copy.

The plain versions are held against the Pallas kernel (interpret mode) on
unpadded x, and against themselves on x zero-padded to G·mu.  The CUDA
kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py`` on the card.

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
from repro.kernels.lut_matmul import lut_matmul as j_lut_matmul
from repro_torch.core import encoding as tenc
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import lut_matmul as tlut


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


# ragged B, O and K: K = G·3 − 1, G·3 − 2 and G·3 (G = 17, 101, 16)
RAGGED = [(3, 37, 50), (9, 130, 301), (2, 20, 48)]
PLAIN = {"gather": tlut.lut_matmul_torch, "onehot": tlut.lut_onehot_matmul_torch}


@pytest.mark.parametrize("mu", [2, 3, 5])
@pytest.mark.parametrize("K", [47, 48, 301])
def test_served_keys_are_a_padded_view_that_decodes_to_the_trits(K, mu):
    _, w = _case(30, 1, 24, K)
    tw = tdispatch.TernaryWeight.from_packed(
        tenc.pack_base3(torch.from_numpy(w)), 1.0, K, mu=mu)
    keys = tw.keys(mu)
    G = -(-K // mu)
    assert keys.shape == (24, G) and keys is tw.keys(mu)
    assert keys.stride(1) == 1
    assert keys.stride(0) * keys.element_size() % tenc.KEY_ROW_BYTES == 0
    assert keys.stride(0) - G < tenc.KEY_ROW_BYTES // keys.element_size()
    # the same keys as the unpadded encoding, and they decode to the trits
    want = tenc.encode_weight_matrix(torch.from_numpy(w), mu)
    assert torch.equal(keys, want)
    back = tenc.decode_groups(keys, mu).reshape(24, -1)[:, :K]
    assert np.array_equal(back.numpy(), w)
    # the padding past G holds the zero key T, which decodes to zero trits
    rows = torch.as_strided(keys, (24, keys.stride(0)), (keys.stride(0), 1))
    pad = rows[:, G:]
    assert (pad == tenc.table_size(mu)).all()
    assert not tenc.decode_groups(pad, mu).any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("fetch", ["gather", "onehot"])
@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_lut_on_unpadded_x_matches_padded_and_pallas(B, O, K, fetch,
                                                           int8):
    x, w = _case(31, B, O, K, int8)
    keys = np.array(jenc.encode_weight_matrix(jnp.asarray(w), 3))
    G = keys.shape[1]
    xp = np.pad(x, ((0, 0), (0, G * 3 - K)))
    plain = PLAIN[fetch]
    got = plain(torch.from_numpy(x), torch.from_numpy(keys), 3)
    assert got.shape == (B, O) and got.dtype == torch.float32
    assert torch.equal(got, plain(torch.from_numpy(xp), torch.from_numpy(keys), 3))
    # the served keys (a padded-stride view) give the same result
    served = tenc.pad_rows(torch.from_numpy(keys), tenc.KEY_ROW_BYTES,
                           tenc.table_size(3))[:, :G]
    assert torch.equal(got, plain(torch.from_numpy(x), served, 3))
    want64 = x.astype(np.float64) @ w.T.astype(np.float64)
    if int8:
        assert np.array_equal(got.numpy().astype(np.int64),
                              x.astype(np.int64) @ w.T.astype(np.int64))
    else:
        want = np.asarray(j_lut_matmul(jnp.asarray(xp), jnp.asarray(keys), 3,
                                       fetch=fetch, interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(x))
        np.testing.assert_allclose(got.numpy(), want64, rtol=0, atol=_atol(x))
    # the wrappers take the plain version for CPU tensors, unpadded x too
    wrapper = tlut.lut_matmul if fetch == "gather" else tlut.lut_onehot_matmul
    assert torch.equal(wrapper(torch.from_numpy(x), served, 3), got)


@pytest.mark.parametrize("fetch", ["gather", "onehot"])
@pytest.mark.parametrize("K", [46, 51, 44])
def test_lut_refuses_x_that_does_not_fill_the_groups(fetch, K):
    """G = 16 groups of 3 take K in (45, 48]; any other width raises."""
    x, w = _case(32, 2, 8, 48)
    keys = tenc.encode_weight_matrix(torch.from_numpy(w), 3)
    xk = torch.zeros((2, K))
    if 45 < K <= 48:
        PLAIN[fetch](xk, keys, 3)
    else:
        with pytest.raises(ValueError, match="does not fill"):
            PLAIN[fetch](xk, keys, 3)


@pytest.mark.parametrize("name", ["lut_gather", "lut_onehot"])
@pytest.mark.parametrize("K", [49, 50, 48])
def test_dispatch_hands_the_kernel_x_unpadded_and_served_keys(name, K,
                                                              monkeypatch):
    """The LUT path passes x at its logical width and the weight's kept
    keys view, and the result matches ``ref``."""
    x, w = _case(33, 5, 20, K)
    tw = tdispatch.TernaryWeight.from_ternary(torch.from_numpy(w))
    spec = tdispatch.get_kernel(name)
    seen = []

    def kernel(x2, keys, mu):
        seen.append((x2, keys))
        return spec.kernel(x2, keys, mu)

    run = tdispatch._run_lut(kernel)
    monkeypatch.setitem(tdispatch.REGISTRY, name,
                        dataclasses.replace(spec, run=run))
    xt = torch.from_numpy(x)
    y = tdispatch.ternary_matmul(xt, tw, policy=f"fixed:{name}")
    (x2, keys), = seen
    assert x2.shape == (5, K) and x2.data_ptr() == xt.data_ptr()
    assert keys is tw.keys(3)
    ref = tdispatch.ternary_matmul(xt, tw, policy="fixed:ref")
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=0, atol=_atol(x))


def test_autotune_times_the_lut_kernels_on_served_keys(monkeypatch, tmp_path):
    """Autotune derives the keys through ``TernaryWeight``, as serving
    does: each LUT run sees x at the logical K and the padded-stride keys
    view."""
    seen = {}
    for name in ("lut_gather", "lut_onehot"):
        spec = tdispatch.get_kernel(name)

        def run(x2, w, mu, spec=spec):
            seen.setdefault(spec.name, []).append(
                (x2.shape[-1], w.keys(mu).shape, w.keys(mu).stride(0)))
            return spec.run(x2, w, mu)

        monkeypatch.setitem(tdispatch.REGISTRY, name,
                            dataclasses.replace(spec, run=run))
    cache = tdispatch.AutotuneCache(path=str(tmp_path / "at.json"))
    us = tdispatch.autotune(2, 50, 24, "float32", reps=1, device="cpu",
                            kernels=["lut_gather", "lut_onehot"], cache=cache,
                            save=False)
    assert set(us) == {"lut_gather", "lut_onehot"}
    for name in us:
        assert seen[name] and all(s == (50, (24, 17), 32) for s in seen[name])
