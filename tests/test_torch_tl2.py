"""The tl2 kernel fed as served, on the CPU: the division-free split and the
K order the CUDA kernel (``csrc/tl2_matmul.cu`` on ``csrc/ternary_mma.cuh``)
decodes TL2 words with, modelled in numpy; the served words (a view of rows
padded to 16 bytes) against the JAX package's packing; the plain version on
that view against the Pallas kernel (interpret mode) and ``tl2_matmul_ref``
for every activation dtype the kernel reads as it is; what dispatch hands
the wrapper; and the build's hash over the shared header.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).

Tolerance for float inputs: both sides accumulate in f32 in different
orders (atol = 1e-5 · max_b Σ_k |x[b, k]| + 1e-6); int8 x gives integer
sums below 2^24, held exactly.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.kernels import tl2_matmul as jtl2
from repro_torch.core import encoding as tenc
from repro_torch.kernels import _build
from repro_torch.kernels import dequant_matmul as tdeq
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import tl2_matmul as ttl2

RAGGED = [(3, 37, 50), (9, 130, 301), (2, 16, 641), (1, 24, 6912)]


def _case(seed, B, O, K, int8=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-127, 128, size=(B, K)).astype(np.int8) if int8
         else rng.normal(size=(B, K)).astype(np.float32))
    w = rng.integers(-1, 2, size=(O, K)).astype(np.int8)
    return x, w


def _atol(x):
    return 1e-5 * float(np.abs(np.asarray(x, np.float64)).sum(-1).max()) + 1e-6


def _served_words(w: np.ndarray) -> torch.Tensor:
    """The TL2 words as a served weight holds them: derived from the
    serving artifact's base-3 rows (padded to 128 bytes)."""
    packed = tenc.pad_rows(tenc.pack_base3(torch.from_numpy(w)),
                           tenc.PACKED_ROW_BYTES)
    return tdispatch.TernaryWeight.from_packed(packed, 1.0,
                                               w.shape[1]).tl2()


# --- the decode of csrc/tl2_matmul.cu, modelled in numpy ---------------------

def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode, selector nibbles 0-7), elementwise: byte
    j of the result is byte sel[j] of the 8-byte pool (b:a)."""
    pool = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    sel = np.asarray(sel, np.uint64)
    out = np.zeros(np.broadcast(pool, sel).shape, np.uint64)
    for j in range(4):
        idx = (sel >> np.uint64(4 * j)) & np.uint64(7)
        out |= ((pool >> (np.uint64(8) * idx)) & np.uint64(0xFF)) \
            << np.uint64(8 * j)
    return out


def _digits(p):
    """digits(): the five base-3 digits of the values in p's 16-bit lanes."""
    d = []
    for _ in range(4):
        q = ((p * 171) >> 9) & 0x007F007F
        d.append(p - 3 * q)
        p = q
    return d + [p]


def _planes(w):
    """TL2::planes: hi = the two words' v // 243 in 16-bit lanes (one
    umulhi each and a prmt), lo = w - 243 hi; their digits."""
    c = np.uint64(69043 << 8)
    q0 = ((w & 0xFFFF).astype(np.uint64) * c) >> np.uint64(32)
    q1 = ((w >> 16).astype(np.uint64) * c) >> np.uint64(32)
    hi = _prmt(q0, q1, 0x5410).astype(np.int64)
    lo = w - 243 * hi
    return [_digits(lo), _digits(hi)]


def _reg(planes, L):
    d = ttl2.trit_digit(L % 10)
    return planes[d // 5][d % 5]


def _gather(L, L2):
    return ((L // 10) * 2) | ((4 + (L2 // 10) * 2) << 4)


def _bf16_pair(planes, L):
    s = _prmt(_reg(planes, L), _reg(planes, L + 1), _gather(L, L + 1))
    return _prmt(0x00800080, 0x003F00BF,
                 (s * np.uint64(0x11) + np.uint64(0x4040)) & np.uint64(0xFFFFFFFF))


def _s8_quad(planes, L):
    lo = _prmt(_reg(planes, L), _reg(planes, L + 1), _gather(L, L + 1))
    hi = _prmt(_reg(planes, L + 2), _reg(planes, L + 3), _gather(L + 2, L + 3))
    return ((_prmt(lo, hi, 0x5410) + np.uint64(0x7F7F7F7F))
            & np.uint64(0xFFFFFFFF)) ^ np.uint64(0x80808080)


def test_split_is_exact_for_every_word_value():
    """v / 243 = (v * 69043) >> 24 for every word value, which the kernel
    takes as the high word of the 32-bit product v * (69043 << 8)."""
    v = np.arange(9 ** 5, dtype=np.int64)
    hi = (v * 69043) >> 24
    assert np.array_equal(hi, v // 243) and hi.max() < 243
    assert np.array_equal((v * (69043 << 8)) >> 32, v // 243)
    assert 69043 << 8 < 1 << 32 and ((v - 243 * hi) < 243).all()


def test_split_and_swap_recipe_gives_unpack_tl2_trits_for_every_word():
    """Every word value 0..59048 in both 16-bit halves of a lane's 32-bit
    word: the bf16 pairs and s8 quads the kernel builds are the trits
    unpack_tl2 gives, in the word's trit order (trit k = digit k ^ 1)."""
    v = np.arange(9 ** 5, dtype=np.int64)
    lanes = np.stack([v, (v * 7919 + 13) % 9 ** 5], axis=1)    # [V, 2]
    w = lanes[:, 0] | (lanes[:, 1] << 16)
    held = torch.from_numpy(lanes.astype(np.uint16).view(np.int16))
    trits = ttl2.unpack_tl2(held, 20).numpy().astype(np.int64)  # [V, 20]
    planes = _planes(w)
    bf16 = np.array([0xBF80, 0, 0x3F80], np.uint64)
    for L in range(0, 20, 2):
        want = bf16[trits[:, L] + 1] | (bf16[trits[:, L + 1] + 1] << np.uint64(16))
        assert np.array_equal(_bf16_pair(planes, L), want), L
    for L in range(0, 20, 4):
        want = sum((trits[:, L + j] & 0xFF).astype(np.uint64) << np.uint64(8 * j)
                   for j in range(4))
        assert np.array_equal(_s8_quad(planes, L), want), L


def test_zero_word_is_ten_zero_trits():
    word = torch.tensor([ttl2.ZERO_WORD], dtype=torch.int16)
    assert ttl2.ZERO_WORD == 29524
    assert not ttl2.unpack_tl2(word, 10).any()
    assert np.array_equal(ttl2.unpack_tl2_digits(word).numpy(), [4] * 5)


@pytest.mark.parametrize("mma,n_mma,width", [("bf16", 10, 16), ("s8", 5, 32)])
def test_fragment_digits_take_the_order_b_takes(mma, n_mma, width):
    """A's (word, digit) per k slot is a permutation of the warp's 160
    trits, the same trit slot for slot as the x column B reads
    (``dequant_matmul.fragment_trits``), and each lane reads only its own
    words (2t, 2t+1 at byte 4t; 8+2t, 9+2t at byte 16+4t)."""
    fd = ttl2.fragment_digits(mma)
    assert fd.shape == (n_mma, width, 2)
    word, digit = fd[..., 0], fd[..., 1]
    assert word.min() >= 0 and word.max() < 16 and digit.max() < 10
    trit = 10 * word + ttl2.trit_digit(digit)
    assert sorted(trit.ravel().tolist()) == list(range(160))
    assert np.array_equal(trit, tdeq.fragment_trits(mma))
    for t in range(4):
        slots = ([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9] if mma == "bf16"
                 else [4 * t + j for j in range(4)]
                 + [4 * t + 16 + j for j in range(4)])
        assert set(word[:, slots].ravel().tolist()) <= \
            {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t}


def test_fragment_digits_unknown_mma_raises():
    with pytest.raises(ValueError, match="bf16"):
        ttl2.fragment_digits("fp8")


# --- the served words --------------------------------------------------------

@pytest.mark.parametrize("K", [50, 301, 2560, 6912])
def test_served_words_are_a_padded_view_of_the_reference_words(K):
    """TernaryWeight.tl2() is one kept view [N, ceil(K/10)] of rows padded
    to 16 bytes with the zero-trit word; its values are the JAX package's
    repack of the base-3 rows, bit for bit."""
    _, w = _case(70, 3, 5, K)
    packed = tenc.pad_rows(tenc.pack_base3(torch.from_numpy(w)),
                           tenc.PACKED_ROW_BYTES)
    tw = tdispatch.TernaryWeight.from_packed(packed, 1.0, K)
    words = tw.tl2()
    assert words is tw.tl2() and words.dtype == torch.int16
    W = -(-K // 10)
    assert words.shape == (5, W) and words.stride(1) == 1
    assert words.stride(0) * 2 % ttl2.ROW_BYTES == 0
    assert words.stride(0) == -(-W // 8) * 8
    assert words.is_contiguous() == (W % 8 == 0)
    jpacked = np.asarray(jenc.pack_base3(jnp.asarray(w)))
    jwords = np.asarray(jtl2.repack_base3_to_tl2(jnp.asarray(jpacked), K))
    assert words.contiguous().numpy().tobytes() == jwords.tobytes()
    rows = words.as_strided((5, words.stride(0)), (words.stride(0), 1))
    assert (rows[:, W:] == ttl2.ZERO_WORD).all()
    # the same from trits
    tt = tdispatch.TernaryWeight.from_ternary(torch.from_numpy(w)).tl2()
    assert torch.equal(tt, words) and tt.stride() == words.stride()


@pytest.mark.parametrize("B,O,K", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_on_served_words_matches_jax(dtype, B, O, K):
    """x of the logical width K, as it comes, against the served view:
    the JAX Pallas kernel (interpret) and tl2_matmul_ref agree within the
    f32 tolerance, and exactly for int8 x (also with the int64 product)."""
    x, w = _case(71, B, O, K, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    words = _served_words(w)
    got = ttl2.tl2_matmul(xt, words, K)
    assert got.dtype == torch.float32 and got.shape == (B, O)
    jx = jnp.asarray(xt.to(torch.float32).numpy() if dtype != "int8" else x)
    jw = jnp.asarray(words.contiguous().numpy().view(np.uint16))
    pallas = np.asarray(jtl2.tl2_matmul(jx, jw, K, interpret=True))
    ref = np.asarray(jtl2.tl2_matmul_ref(jx, jw, K))
    if dtype == "int8":
        want = x.astype(np.int64) @ w.T.astype(np.int64)
        assert np.array_equal(got.numpy().astype(np.int64), want)
        assert np.array_equal(got.numpy(), pallas)
        assert np.array_equal(got.numpy(), ref)
    else:
        tol = _atol(xt.to(torch.float32).numpy())
        np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


def test_plain_refuses_x_wider_than_the_words():
    x, w = _case(72, 2, 4, 47)
    words = ttl2.pack_tl2(torch.from_numpy(w))
    with pytest.raises(ValueError, match="cover"):
        ttl2.tl2_matmul(torch.zeros((2, 51)), words, 47)
    # up to W*10 columns are taken (zero past K)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 3))
    assert torch.equal(ttl2.tl2_matmul(xp, words, 47),
                       ttl2.tl2_matmul(torch.from_numpy(x), words, 47))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_run_tl2_hands_x_and_served_words_to_the_wrapper(dtype, monkeypatch):
    """dispatch passes x as it comes (no cast, no pad) and the served view
    as it lies."""
    seen = []

    def recording(x, words, n):
        seen.append((x.dtype, x.shape[1], words.data_ptr(), words.stride()))
        return ttl2.tl2_matmul_torch(x, words, n)

    monkeypatch.setattr(tdispatch, "tl2_matmul", recording)
    x, w = _case(73, 2, 24, 301, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = tdispatch.TernaryWeight.from_ternary(torch.from_numpy(w))
    tdispatch.ternary_matmul(xt, tw, policy="fixed:tl2")
    words = tw.tl2()
    assert seen == [(xt.dtype, 301, words.data_ptr(), words.stride())]
    assert words.stride(0) == 32 and words.shape[1] == 31


# --- the build ---------------------------------------------------------------

def test_build_hash_covers_the_included_header(tmp_path, monkeypatch):
    """An edited shared header rebuilds every source that includes it (the
    library's hash changes); an edit to a file no source includes does
    not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ["tl2_matmul", "packed_matmul"]
    for name in names:
        assert [p.name for p in _build.sources(csrc / f"{name}.cu")] == \
            [f"{name}.cu", "ternary_mma.cuh"]
    before = {n: _build._target(n)[1] for n in names + ["lut_matmul"]}
    (csrc / "unrelated.cuh").write_text("// not included\n")
    assert {n: _build._target(n)[1] for n in before} == before
    header = csrc / "ternary_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n)[1] for n in before}
    assert all(after[n] != before[n] for n in names)
    assert after["lut_matmul"] == before["lut_matmul"]
