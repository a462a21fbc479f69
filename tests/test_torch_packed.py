"""The base-3 packed kernels (``dequant_packed``, ``w2a8``) fed as served,
on the CPU: the plain versions against the Pallas kernel (interpret mode)
and the int64 product for every activation dtype the CUDA kernel reads as
it is, rows padded or not, what dispatch hands the wrapper, and the K order
and decode the CUDA kernel (``csrc/packed_matmul.cu``) feeds the tensor
cores, modelled in numpy.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

Tolerance for float inputs: both sides accumulate in f32 in different
orders (atol = 1e-5 · max_b Σ_k |x[b, k]| + 1e-6); int8 x gives integer
sums, held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import encoding as jenc
from repro.kernels.dequant_matmul import packed_matmul as j_packed_matmul
from repro_torch.core import encoding as tenc
from repro_torch.kernels import dequant_matmul as tdeq
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import w2a8_matmul as tw2a8

RAGGED = [(3, 37, 50), (9, 130, 301), (2, 16, 641)]


def _case(seed, B, O, K, int8=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-127, 128, size=(B, K)).astype(np.int8) if int8
         else rng.normal(size=(B, K)).astype(np.float32))
    w = rng.integers(-1, 2, size=(O, K)).astype(np.int8)
    return x, w


def _atol(x):
    return 1e-5 * float(np.abs(np.asarray(x, np.float64)).sum(-1).max()) + 1e-6


def _served(w: np.ndarray) -> torch.Tensor:
    """Base-3 rows padded to 128 bytes, as the serving artifact holds them."""
    return tenc.pad_rows(tenc.pack_base3(torch.from_numpy(w)),
                         tenc.PACKED_ROW_BYTES)


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_packed_on_bf16_x_matches_pallas(B, O, K):
    """bf16 x, as served: the Pallas kernel decodes to x's dtype and sums
    in f32, the plain version widens x to f32; the same products."""
    x, w = _case(60, B, O, K)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    packed = _served(w)
    want = np.asarray(j_packed_matmul(jnp.asarray(xb.float().numpy(),
                                                  jnp.bfloat16),
                                      jnp.asarray(packed.numpy()), K,
                                      interpret=True))
    got = tdeq.packed_matmul(xb, packed, K)
    assert got.dtype == torch.float32 and got.shape == (B, O)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_atol(xb.float().numpy()))


@pytest.mark.parametrize("B,O,K", RAGGED)
def test_plain_packed_exact_on_int8_x(B, O, K):
    x, w = _case(61, B, O, K, int8=True)
    got = tdeq.packed_matmul(torch.from_numpy(x), _served(w), K)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().astype(np.int64),
                          x.astype(np.int64) @ w.T.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "float16"])
def test_plain_packed_returns_f32_for_every_x_dtype(dtype):
    x, w = _case(62, 3, 20, 47, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tdeq.packed_matmul(xt, _served(w), 47)
    want = xt.double().numpy() @ w.T.astype(np.float64)
    assert got.dtype == torch.float32 and got.shape == (3, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_atol(xt.double().numpy()))


@pytest.mark.parametrize("K", [50, 301, 641])
@pytest.mark.parametrize("kernel", ["dequant", "w2a8"])
def test_packed_wrappers_take_unpadded_and_served_rows(kernel, K):
    """Unpadded rows, the served 128-byte padded rows and x zero-padded to
    5 · NB columns give the same result."""
    fn = tdeq.packed_matmul if kernel == "dequant" else tw2a8.w2a8_matmul
    x, w = _case(63, 4, 24, K, int8=kernel == "w2a8")
    xt = torch.from_numpy(x)
    unpadded = tenc.pack_base3(torch.from_numpy(w))
    served = _served(w)
    assert served.shape[1] % 128 == 0 and served.shape[1] > unpadded.shape[1]
    got = fn(xt, unpadded, K)
    xp = torch.nn.functional.pad(xt, (0, 5 * unpadded.shape[1] - K))
    assert torch.equal(got, fn(xt, served, K))
    assert torch.equal(got, fn(xp, served, K))
    want = x.astype(np.float64) @ w.T.astype(np.float64)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=_atol(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_run_dequant_hands_x_to_the_wrapper_uncast(dtype, monkeypatch):
    """dispatch passes x as it comes (the kernel reads f32, bf16 and int8
    as they are) and the served rows as they lie."""
    seen = []

    def recording(x, packed, n):
        seen.append((x.dtype, packed.data_ptr()))
        return tdeq.packed_matmul_torch(x, packed, n)

    monkeypatch.setattr(tdispatch, "packed_matmul", recording)
    x, w = _case(64, 2, 24, 301, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = tdispatch.TernaryWeight.from_packed(_served(w), 1.0, 301)
    tdispatch.ternary_matmul(xt, tw, policy="fixed:dequant_packed")
    assert seen == [(xt.dtype, tw.packed().data_ptr())]


@pytest.mark.parametrize("mma,n_mma,width,lane_slots", [
    ("bf16", 10, 16, lambda t: [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]),
    ("s8", 5, 32, lambda t: [4 * t + j for j in range(4)]
     + [4 * t + 16 + j for j in range(4)])])
def test_fragment_order_reads_each_lane_its_own_words(mma, n_mma, width,
                                                      lane_slots):
    """The K order is a permutation of a warp's 160 trits; lane t of a quad
    takes its A values from its own words (bytes 4t and 16 + 4t of the
    32-byte chunk) and its B values as runs of 4 consecutive x values (one
    8-byte or two 4-byte shared loads)."""
    order = tdeq.fragment_trits(mma)
    assert order.shape == (n_mma, width)
    assert sorted(order.ravel().tolist()) == list(range(5 * tdeq.WARP_BYTES))
    for i in range(n_mma):
        for t in range(4):
            trits = order[i, lane_slots(t)]
            own = {4 * t + j for j in range(4)} | {16 + 4 * t + j for j in range(4)}
            assert set((trits // 5).tolist()) <= own
            for run in trits.reshape(-1, 4):
                assert run.tolist() == list(range(run[0], run[0] + 4))
                # a run lies in one word, so one load reads it
                assert run[0] // 20 == run[3] // 20


def test_fragment_order_unknown_mma_raises():
    with pytest.raises(ValueError, match="bf16"):
        tdeq.fragment_trits("fp8")


# --- the decode recipe of csrc/packed_matmul.cu, modelled in numpy ---------

def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode, selector nibbles 0-7): byte j of the
    result is byte sel[j] of the 8-byte pool (b:a)."""
    pool = (np.uint64(b) << np.uint64(32)) | np.uint64(a)
    out = 0
    for j in range(4):
        idx = (int(sel) >> (4 * j)) & 7
        out |= ((int(pool) >> (8 * idx)) & 0xFF) << (8 * j)
    return out


def _digit_planes(word: int):
    """Word(w): d[b & 1][i] = digit i of byte b, in byte 2 (b >> 1)."""
    planes = []
    for p in (word & 0x00FF00FF, (word >> 8) & 0x00FF00FF):
        d = []
        for _ in range(4):
            q = ((p * 171) >> 9) & 0x007F007F
            d.append(p - 3 * q)
            p = q
        d.append(p)
        planes.append(d)
    return planes


def _reg(planes, L):
    return planes[(L // 5) & 1][L % 5]


def _gather(L, L2):
    return ((L // 10) * 2) | ((4 + (L2 // 10) * 2) << 4)


def _bf16_pair(planes, L):
    s = _prmt(_reg(planes, L), _reg(planes, L + 1), _gather(L, L + 1))
    return _prmt(0x00800080, 0x003F00BF, (s * 0x11 + 0x4040) & 0xFFFFFFFF)


def _s8_quad(planes, L):
    lo = _prmt(_reg(planes, L), _reg(planes, L + 1), _gather(L, L + 1))
    hi = _prmt(_reg(planes, L + 2), _reg(planes, L + 3), _gather(L + 2, L + 3))
    return ((_prmt(lo, hi, 0x5410) + 0x7F7F7F7F) & 0xFFFFFFFF) ^ 0x80808080


def test_division_by_three_in_16_bit_lanes_is_exact_for_every_byte():
    v = np.arange(256, dtype=np.int64)
    assert np.array_equal((v * 171) >> 9, v // 3)
    assert 242 * 171 < 1 << 16
    # two lanes at once: no carry or borrow crosses them
    lo, hi = np.meshgrid(np.arange(243), np.arange(243))
    p = lo.ravel() | (hi.ravel() << 16)
    q = ((p * 171) >> 9) & 0x007F007F
    d = p - 3 * q
    assert np.array_equal(q & 0xFFFF, lo.ravel() // 3)
    assert np.array_equal(q >> 16, hi.ravel() // 3)
    assert np.array_equal(d & 0xFFFF, lo.ravel() % 3)
    assert np.array_equal(d >> 16, hi.ravel() % 3)


def test_decode_recipe_gives_each_lane_word_its_trits():
    """For words of four base-3 bytes (every byte value in every position,
    and the zero padding byte), the bf16 pairs and s8 quads the kernel
    builds are the trits unpack_base3 gives, in the word's trit order."""
    bf16 = {-1: 0xBF80, 0: 0, 1: 0x3F80}
    rng = np.random.default_rng(65)
    words = [np.array([v, (v + 81) % 243, (v + 162) % 243, 242 - v])
             for v in range(243)] + [np.zeros(4, np.int64)] \
        + [rng.integers(0, 243, 4) for _ in range(200)]
    for b in words:
        word = int(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24))
        trits = tenc.unpack_base3(torch.tensor(b, dtype=torch.uint8),
                                  20).tolist()
        planes = _digit_planes(word)
        for L in range(0, 20, 2):
            pair = _bf16_pair(planes, L)
            assert pair == bf16[trits[L]] | (bf16[trits[L + 1]] << 16), (b, L)
        for L in range(0, 20, 4):
            quad = _s8_quad(planes, L)
            want = sum((trits[L + j] & 0xFF) << (8 * j) for j in range(4))
            assert quad == want, (b, L)


def test_served_packing_is_the_reference_packing():
    """The rows the kernel reads are the reference's base-3 bytes, the
    padding past ceil(K/5) zero."""
    _, w = _case(66, 3, 5, 301)
    served = _served(w)
    ref = np.asarray(jenc.pack_base3(jnp.asarray(w)))
    assert np.array_equal(served.numpy()[:, :ref.shape[1]], ref)
    assert not served.numpy()[:, ref.shape[1]:].any()


def test_sass_loop_counter_counts_the_longest_backward_loop():
    """The SASS reader behind the decode's instruction count: the loop is
    the span of the longest backward branch; predicated opcodes count."""
    from repro_torch.launch.sass_count import loop_counts

    sass = """
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   IMAD R4, R2, 0xab, RZ ;
        /*0030*/               @P1 PRMT R5, R4, 0x5410, R2 ;
        /*0040*/                   HMMA.16816.F32.BF16 R8, R4, R6, R8 ;
        /*0050*/               @!P0 BRA 0x30 ;
        /*0060*/               @!P0 BRA 0x10 ;
        /*0070*/                   EXIT ;
"""
    got = loop_counts(sass)
    assert got["loop_ops"] == {"LDS": 1, "IMAD": 1, "PRMT": 1, "HMMA": 1,
                               "BRA": 2}
    assert got["loop_instructions"] == 6 and got["loop_integer"] == 2
    assert got["loop_mma"] == 1
