"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: lut_gather, lut_onehot, tl2, dequant_packed, w2a8, signflip, and
the grouped (MoE expert stack) grouped_dequant and grouped_w2a8.

These tests need a CUDA card and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` on first use); elsewhere they skip.  The
module imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerance for float inputs: kernel and plain version both accumulate in f32,
in different orders, so they agree to a few f32 ulps of the row's absolute
sum (atol = 1e-5 · max_b Σ_k |x[b, k]|).  int8 inputs make every partial
sum an integer below 2^24, so those results are exact; ``w2a8`` sums in
int32 and must equal the int64 product.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import encoding as tenc
from repro_torch.kernels import dequant_matmul as tdeq
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import grouped_matmul as tgm
from repro_torch.kernels import lut_matmul as tlut
from repro_torch.kernels import signflip_matmul as tsf
from repro_torch.kernels import tl2_matmul as ttl2
from repro_torch.kernels import w2a8_matmul as tw2a8

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, B, O, K, int8=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-127, 128, size=(B, K)).astype(np.int8) if int8
         else rng.normal(size=(B, K)).astype(np.float32))
    w = rng.integers(-1, 2, size=(O, K)).astype(np.int8)
    return x, w


def _atol(x: torch.Tensor) -> float:
    return 1e-5 * float(x.double().abs().sum(-1).max()) + 1e-6


# ragged B, O and K (K not a multiple of mu=3 or of 10), every row-tile
# height the kernels are built for (1, 2, 4, 8), and bitnet shapes
SHAPES = [(1, 130, 301), (2, 37, 50), (3, 37, 50), (9, 130, 301),
          (4, 640, 2560), (32, 2560, 6912)]


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_lut_gather_kernel_matches_plain(cuda, B, O, K):
    x, w = _case(5, B, O, K)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    keys = tenc.encode_weight_matrix(wt, 3)
    xp = torch.nn.functional.pad(xt, (0, keys.shape[1] * 3 - K))
    n0 = tlut.lut_matmul.launches
    got = tlut.lut_matmul(xp, keys, 3)
    assert tlut.lut_matmul.launches == n0 + 1
    want = tlut.lut_matmul_torch(xp, keys, 3)
    torch.cuda.synchronize()
    assert got.shape == (B, O) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("mu", [2, 4])
def test_lut_gather_kernel_refuses_other_group_sizes(cuda, mu):
    x, w = _case(8, 5, 200, 97)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    keys = tenc.encode_weight_matrix(wt, mu)
    xp = torch.nn.functional.pad(xt, (0, keys.shape[1] * mu - 97))
    n0 = tlut.lut_matmul.launches
    with pytest.raises(ValueError, match="mu=3"):
        tlut.lut_matmul(xp, keys, mu)
    assert tlut.lut_matmul.launches == n0


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_tl2_kernel_matches_plain(cuda, B, O, K):
    x, w = _case(6, B, O, K)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    words = ttl2.pack_tl2(wt)
    n0 = ttl2.tl2_matmul.launches
    got = ttl2.tl2_matmul(xt.to(torch.bfloat16), words, K)
    assert ttl2.tl2_matmul.launches == n0 + 1
    want = ttl2.tl2_matmul_torch(xt.to(torch.bfloat16), words, K)
    torch.cuda.synchronize()
    assert got.shape == (B, O) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", SHAPES[:5])
def test_int8_activations_exact_on_card(cuda, B, O, K):
    x, w = _case(7, B, O, K, int8=True)
    want = torch.from_numpy(x.astype(np.int64) @ w.T.astype(np.int64))
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    got = ttl2.tl2_matmul(xt, ttl2.pack_tl2(wt), K)
    assert torch.equal(got.cpu().to(torch.int64), want)
    keys = tenc.encode_weight_matrix(wt, 3)
    xp = torch.nn.functional.pad(xt, (0, keys.shape[1] * 3 - K))
    got = tlut.lut_matmul(xp, keys, 3)
    assert torch.equal(got.cpu().to(torch.int64), want)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 30), device=cuda)
    with pytest.raises(ValueError):
        ttl2.tl2_matmul(x, torch.zeros((4, 3), dtype=torch.int32, device=cuda), 30)
    with pytest.raises(ValueError):
        tlut.lut_matmul(x, torch.zeros((4, 10), dtype=torch.uint8), 3)


def _served_packed(wt: torch.Tensor) -> torch.Tensor:
    """Base-3 bytes with the serving artifact's 128-byte row padding (byte
    0, five -1 trits each, past the logical K)."""
    packed = tenc.pack_base3(wt)
    return torch.nn.functional.pad(packed, (0, (-packed.shape[1]) % 128))


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_lut_onehot_kernel_matches_plain(cuda, B, O, K):
    x, w = _case(9, B, O, K)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    keys = tenc.encode_weight_matrix(wt, 3)
    xp = torch.nn.functional.pad(xt.to(torch.bfloat16), (0, keys.shape[1] * 3 - K))
    n0, g0 = tlut.lut_onehot_matmul.launches, tlut.lut_matmul.launches
    got = tlut.lut_onehot_matmul(xp, keys, 3)
    assert tlut.lut_onehot_matmul.launches == n0 + 1
    assert tlut.lut_matmul.launches == g0
    want = tlut.lut_onehot_matmul_torch(xp, keys, 3)
    torch.cuda.synchronize()
    assert got.shape == (B, O) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("mu", [2, 4])
def test_lut_onehot_kernel_refuses_other_group_sizes(cuda, mu):
    x, w = _case(10, 5, 200, 97)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    keys = tenc.encode_weight_matrix(wt, mu)
    xp = torch.nn.functional.pad(xt, (0, keys.shape[1] * mu - 97))
    n0 = tlut.lut_onehot_matmul.launches
    with pytest.raises(ValueError, match="mu=3"):
        tlut.lut_onehot_matmul(xp, keys, mu)
    assert tlut.lut_onehot_matmul.launches == n0


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_dequant_kernel_matches_plain(cuda, B, O, K):
    x, w = _case(11, B, O, K)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    packed = _served_packed(wt)
    xb = xt.to(torch.bfloat16)
    n0 = tdeq.packed_matmul.launches
    got = tdeq.packed_matmul(xb, packed, K)
    assert tdeq.packed_matmul.launches == n0 + 1
    want = tdeq.packed_matmul_torch(xb, packed, K)
    torch.cuda.synchronize()
    assert got.shape == (B, O) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_w2a8_kernel_exact(cuda, B, O, K):
    x, w = _case(12, B, O, K, int8=True)
    want = torch.from_numpy(x.astype(np.int64) @ w.T.astype(np.int64))
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    packed = _served_packed(wt)
    n0 = tw2a8.w2a8_matmul.launches
    got = tw2a8.w2a8_matmul(xt, packed, K)
    assert tw2a8.w2a8_matmul.launches == n0 + 1
    assert got.shape == (B, O) and got.dtype == torch.int32
    assert torch.equal(got.cpu().to(torch.int64), want)
    assert torch.equal(got, tw2a8.w2a8_matmul_torch(xt, packed, K))


def test_w2a8_kernel_refuses_float_activations(cuda):
    packed = torch.zeros((4, 10), dtype=torch.uint8, device=cuda)
    n0 = tw2a8.w2a8_matmul.launches
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="int8"):
            tw2a8.w2a8_matmul(torch.zeros((2, 50), dtype=dtype, device=cuda),
                              packed, 50)
    assert tw2a8.w2a8_matmul.launches == n0


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_signflip_kernel_matches_plain(cuda, B, O, K):
    x, w = _case(13, B, O, K)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    xb = xt.to(torch.bfloat16)
    n0 = tsf.signflip_matmul.launches
    got = tsf.signflip_matmul(xb, wt)
    assert tsf.signflip_matmul.launches == n0 + 1
    want = tsf.signflip_matmul_torch(xb, wt)
    torch.cuda.synchronize()
    assert got.shape == (B, O) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= _atol(xt)


def _signflip_once(x, w):
    n0 = tsf.signflip_matmul.launches
    got = tsf.signflip_matmul(x, w)
    assert tsf.signflip_matmul.launches == n0 + 1
    torch.cuda.synchronize()
    assert got.shape == (x.shape[0], w.shape[0]) and got.dtype == torch.float32
    return got


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_signflip_kernel_matches_plain_on_f32_activations(cuda, B, O, K):
    """f32 x with bits below bf16's 8: the kernel's three-term split."""
    x, w = _case(18, B, O, K)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    assert not torch.equal(xt.to(torch.bfloat16).float(), xt)
    got = _signflip_once(xt, wt)
    want = tsf.signflip_matmul_torch(xt, wt)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", SHAPES)
def test_signflip_kernel_exact_on_int8_activations(cuda, B, O, K):
    x, w = _case(19, B, O, K, int8=True)
    want = torch.from_numpy(x.astype(np.int64) @ w.T.astype(np.int64))
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    got = _signflip_once(xt, wt)
    assert torch.equal(got.cpu().to(torch.int64), want)


# ragged M at every row tile and past it, N = 640, K not a multiple of the
# 64-trit step: a multiple of 16 (rows read in place) and not (rows copied
# by the wrapper to a 16-byte stride)
@pytest.mark.parametrize("K", [2512, 301])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_signflip_kernel_ragged(cuda, B, K, dtype):
    x, w = _case(20, B, 640, K)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    xt = xt.to(getattr(torch, dtype))
    got = _signflip_once(xt, wt)
    want = tsf.signflip_matmul_torch(xt, wt)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", [(4, 640, 2560), (4, 2560, 6912),
                                   (32, 2560, 6912), (9, 130, 301)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_signflip_kernel_is_deterministic(cuda, B, O, K, dtype):
    """Split-K partials are summed in split order, with no float atomics:
    two calls on the same inputs agree bit for bit."""
    x, w = _case(21, B, O, K)
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    wt = torch.from_numpy(w).to(cuda)
    assert torch.equal(_signflip_once(xt, wt), _signflip_once(xt, wt))


# the served trits are a view of rows padded to 128 bytes: read in place
# where the stride is a multiple of 16 bytes (with a partial last chunk
# where K is ragged), copied by the wrapper to such a stride where not
@pytest.mark.parametrize("K,pad", [(6912, 128), (2500, 12), (301, 3), (50, 5)])
def test_signflip_kernel_reads_padded_rows_in_place(cuda, K, pad):
    x, w = _case(23, 4, 640, K)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    wp = torch.zeros((640, K + pad), dtype=torch.int8, device=cuda)
    wp[:, :K] = torch.from_numpy(w).to(cuda)
    wt = wp[:, :K]
    assert not wt.is_contiguous()
    got = _signflip_once(xt, wt)
    assert torch.equal(got, _signflip_once(xt, wt.contiguous()))
    want = tsf.signflip_matmul_torch(xt, wt)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_signflip_kernel_on_nonfinite_activations(cuda, dtype):
    """+-inf and NaN in x.  The kernel multiplies x by trits decoded to +1,
    0 and -1, so it gives IEEE's x @ w^T: a zero trit against an infinite
    x gives 0 * inf = NaN, and a NaN reaches every column.  The plain
    version's select skips zero trits instead; this pins the difference."""
    x, w = _case(24, 4, 640, 2560)
    x[0, 5] = np.inf
    x[1, 17], x[1, 900] = -np.inf, np.inf
    x[2, 100] = np.nan
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    wt = torch.from_numpy(w).to(cuda)
    got = _signflip_once(xt, wt).cpu()
    xd = xt.cpu().double()
    want = (xd[:, None, :] * torch.from_numpy(w).double()[None]).sum(-1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert float((got[fin].double() - want[fin]).abs().max()) <= \
        _atol(torch.nan_to_num(xt, 0.0, 0.0, 0.0))
    # every kind occurs, and the plain select departs only on rows 0-2
    plain = tsf.signflip_matmul_torch(xt, wt).cpu()
    assert torch.isnan(got[:3]).all(-1).tolist() == [False, False, True]
    assert torch.isposinf(got[0]).any() and torch.isneginf(got[0]).any()
    assert torch.isnan(got[0]).any() and not torch.isnan(plain[0]).any()
    assert torch.isfinite(got[3]).all()
    assert float((got[3] - plain[3]).abs().max()) <= _atol(xt[3:].float())


def test_signflip_never_runs_the_plain_version_on_the_card(cuda, monkeypatch):
    def boom(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tsf, "signflip_matmul_torch", boom)
    x, w = _case(22, 4, 640, 2560)
    _signflip_once(torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda))


@pytest.mark.parametrize("act", ["bfloat16", "int8"])
def test_autotune_on_the_card_times_every_eligible_kernel(cuda, act, tmp_path):
    cache = tdispatch.AutotuneCache(path=str(tmp_path / "at.json"))
    us = tdispatch.autotune(4, 640, 2560, act, cache=cache, device=cuda)
    want = {s.name for s in tdispatch.eligible_kernels(4, 640, 2560, act)}
    assert set(us) == want and all(t > 0 for t in us.values())
    assert ("w2a8" in us) == (act == "int8")
    best = min(us, key=us.get)
    assert tdispatch.select_kernel(4, 640, 2560, act, device="cuda",
                                   cache=cache).name == best


def _grouped_case(seed, E, C, K, N, int8, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randint(-127, 128, (E, C, K), generator=g, device=device,
                       dtype=torch.int8) if int8 else
         torch.randn((E, C, K), generator=g, device=device,
                     dtype=torch.bfloat16))
    w = torch.randint(-1, 2, (E, N, K), generator=g, device=device,
                      dtype=torch.int8)
    packed = tenc.pack_base3(w)
    return x, w, torch.nn.functional.pad(packed,
                                         (0, (-packed.shape[-1]) % 128))


# (E, C, K, N): ragged small shapes at every row tile (C = 1, 2, 5, 9), then
# phi3.5-moe's expert stacks at decode (C = 1) and at the 32-token
# admission chunk (C = 5)
GROUPED = [(3, 1, 50, 37), (2, 2, 301, 130), (4, 5, 133, 260), (2, 9, 64, 7),
           (16, 1, 4096, 6400), (16, 5, 6400, 4096)]


@pytest.mark.parametrize("E,C,K,N", GROUPED)
def test_grouped_dequant_kernel_matches_plain(cuda, E, C, K, N):
    x, _, packed = _grouped_case(14, E, C, K, N, False, cuda)
    n0 = tgm.grouped_packed_matmul.launches
    got = tgm.grouped_packed_matmul(x, packed, K)
    assert tgm.grouped_packed_matmul.launches == n0 + 1
    want = tgm.grouped_packed_matmul_torch(x, packed, K)
    torch.cuda.synchronize()
    assert got.shape == (E, C, N) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= _atol(x.reshape(-1, K))


@pytest.mark.parametrize("E,C,K,N", GROUPED)
def test_grouped_w2a8_kernel_exact(cuda, E, C, K, N):
    x, w, packed = _grouped_case(15, E, C, K, N, True, cuda)
    n0 = tgm.grouped_w2a8_matmul.launches
    got = tgm.grouped_w2a8_matmul(x, packed, K)
    assert tgm.grouped_w2a8_matmul.launches == n0 + 1
    assert got.shape == (E, C, N) and got.dtype == torch.int32
    assert torch.equal(got, tgm.grouped_w2a8_matmul_torch(x, packed, K))
    if E * N * K <= 1 << 20:
        want = torch.einsum("eck,enk->ecn", x.cpu().to(torch.int64),
                            w.cpu().to(torch.int64))
        assert torch.equal(got.cpu().to(torch.int64), want)


def test_grouped_wrappers_never_run_the_plain_version_on_the_card(
        cuda, monkeypatch):
    """A CUDA tensor reaches the kernel: the plain twins are replaced by
    functions that fail, and each call still launches (and counts) once."""
    def boom(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tgm, "grouped_packed_matmul_torch", boom)
    monkeypatch.setattr(tgm, "grouped_w2a8_matmul_torch", boom)
    x, _, packed = _grouped_case(16, 4, 1, 301, 130, False, cuda)
    xq, _, _ = _grouped_case(16, 4, 1, 301, 130, True, cuda)
    d0, w0 = tgm.grouped_packed_matmul.launches, tgm.grouped_w2a8_matmul.launches
    tgm.grouped_packed_matmul(x, packed, 301)
    tgm.grouped_w2a8_matmul(xq, packed, 301)
    torch.cuda.synchronize()
    assert tgm.grouped_packed_matmul.launches == d0 + 1
    assert tgm.grouped_w2a8_matmul.launches == w0 + 1
    with pytest.raises(ValueError, match="int8"):
        tgm.grouped_w2a8_matmul(x, packed, 301)
    assert tgm.grouped_w2a8_matmul.launches == w0 + 1


def test_grouped_dispatch_on_the_card_launches_grouped_dequant(cuda):
    """The prior on the card routes an expert stack to grouped_dequant,
    whose scaled result matches grouped_ref's."""
    x, _, packed = _grouped_case(17, 8, 1, 640, 256, False, cuda)
    gw = tdispatch.GroupedTernaryWeight.from_packed(
        packed, torch.linspace(0.5, 1.0, 8, device=cuda), 640)
    n0 = tgm.grouped_packed_matmul.launches
    got = tdispatch.grouped_ternary_matmul(x, gw, policy="prior")
    assert tgm.grouped_packed_matmul.launches == n0 + 1
    want = tdispatch.grouped_ternary_matmul(x, gw, policy="fixed:ref")
    assert tgm.grouped_packed_matmul.launches == n0 + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (8, 1, 256)
    assert float((got.float() - want.float()).abs().max()) <= \
        2 ** -7 * float(want.float().abs().max())


GROUPED_FN = {"dequant": (tgm.grouped_packed_matmul,
                          tgm.grouped_packed_matmul_torch),
              "w2a8": (tgm.grouped_w2a8_matmul, tgm.grouped_w2a8_matmul_torch)}


def _grouped_once(kernel, x, packed, k):
    """One grouped kernel call; it must launch (and count) exactly once,
    and the other grouped kernel's count must not move."""
    fn, _ = GROUPED_FN[kernel]
    other = GROUPED_FN["w2a8" if kernel == "dequant" else "dequant"][0]
    n0, o0 = fn.launches, other.launches
    got = fn(x, packed, k)
    assert fn.launches == n0 + 1 and other.launches == o0
    torch.cuda.synchronize()
    assert got.shape == (x.shape[0], x.shape[1], packed.shape[1])
    assert got.dtype == (torch.float32 if kernel == "dequant" else torch.int32)
    return got


def _grouped_x(seed, E, C, K, dtype, device):
    """x [E, C, K] of ``dtype``; f32 values need all 24 bits (three bf16
    terms in the kernel)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == "int8":
        return torch.randint(-127, 128, (E, C, K), generator=g, device=device,
                             dtype=torch.int8)
    return torch.randn((E, C, K), generator=g, device=device).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("E,C,K,N", GROUPED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_grouped_dequant_kernel_on_every_x_dtype(cuda, dtype, E, C, K, N):
    """f32, bf16 and int8 x as they come: within the f32 tolerance of the
    plain version, and int8 (integer sums below 2^24) equal to it."""
    _, _, packed = _grouped_case(18, E, C, K, N, False, cuda)
    x = _grouped_x(19, E, C, K, dtype, cuda)
    got = _grouped_once("dequant", x, packed, K)
    want = tgm.grouped_packed_matmul_torch(x, packed, K)
    if dtype == "int8":
        assert torch.equal(got, want)
    assert float((got - want).abs().max()) <= _atol(x.reshape(-1, K))


@pytest.mark.parametrize("E,C,K,N", [(3, 2, 50, 37), (4, 5, 133, 260),
                                     (2, 9, 301, 130)])
@pytest.mark.parametrize("kernel,dtype", [("dequant", "float32"),
                                          ("dequant", "bfloat16"),
                                          ("dequant", "int8"),
                                          ("w2a8", "int8")])
def test_grouped_kernel_takes_x_at_any_layout(cuda, kernel, dtype, E, C, K, N):
    """x as the columns of a wider buffer (rows at a padded stride, read in
    place), with its experts out of order in memory (copied to one stride)
    and starting off 16 bytes (copied to aligned rows): the same sums, bit
    for bit, as contiguous x."""
    _, _, packed = _grouped_case(20, E, C, K, N, False, cuda)
    x = _grouped_x(21, E, C, K, dtype, cuda)
    got = _grouped_once(kernel, x, packed, K)
    wide = torch.zeros((E, C, -(-K // 16) * 16 + 16), dtype=x.dtype,
                       device=cuda)
    wide[:, :, :K] = x
    by_row = x.transpose(0, 1).contiguous().transpose(0, 1)
    flat = torch.zeros(E * C * K + 1, dtype=x.dtype, device=cuda)
    flat[1:] = x.reshape(-1)
    off = flat[1:].view(E, C, K)
    assert off.data_ptr() % 16 and not by_row.is_contiguous()
    for view in (wide[:, :, :K], by_row, off):
        assert torch.equal(got, _grouped_once(kernel, view, packed, K))
    want = GROUPED_FN[kernel][1](x, packed, K)
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= _atol(x.reshape(-1, K))


@pytest.mark.parametrize("E,C,K,N", [(4, 5, 133, 260), (16, 1, 4096, 6400),
                                     (16, 5, 6400, 4096)])
@pytest.mark.parametrize("kernel,dtype", [("dequant", "float32"),
                                          ("dequant", "bfloat16"),
                                          ("w2a8", "int8")])
def test_grouped_kernel_is_deterministic(cuda, kernel, dtype, E, C, K, N):
    """Two calls on the same inputs agree bit for bit (split-K, where the
    plan splits, sums in split order with no atomics)."""
    _, _, packed = _grouped_case(22, E, C, K, N, False, cuda)
    x = _grouped_x(23, E, C, K, dtype, cuda)
    assert torch.equal(_grouped_once(kernel, x, packed, K),
                       _grouped_once(kernel, x, packed, K))


@pytest.mark.parametrize("E,C,K,N", [(16, 1, 4096, 6400), (16, 5, 4096, 6400),
                                     (16, 1, 6400, 4096), (16, 5, 6400, 4096)])
@pytest.mark.parametrize("kernel", ["dequant", "w2a8"])
def test_grouped_grid_at_phi35_expert_stacks(cuda, kernel, E, C, K, N):
    """At phi3.5-moe's expert stacks the plan has E x N / 64 tiles of 64
    columns, one 8-row tile an expert (C <= 8), so at least 1,024 blocks:
    K is not split, and grid.z is the expert."""
    _, _, packed = _grouped_case(24, E, C, K, N, False, cuda)
    x = _grouped_x(25, E, C, K, "int8" if kernel == "w2a8" else "bfloat16",
                   cuda)
    _grouped_once(kernel, x, packed, K)
    assert GROUPED_FN[kernel][0].last_grid == (N // 64, 1, E, 128)


def test_grouped_wrapper_reads_served_inputs_in_place(cuda, monkeypatch):
    """bf16 x and the served 128-byte padded rows reach grouped_dequant
    through dispatch with no cast or copy."""
    rows = tgm.aligned_rows
    seen = []

    def recording(t):
        got, ld = rows(t)
        seen.append(got.data_ptr() == t.data_ptr() and got.dtype == t.dtype)
        return got, ld

    monkeypatch.setattr(tgm, "aligned_rows", recording)
    x, _, packed = _grouped_case(26, 4, 5, 640, 256, False, cuda)
    gw = tdispatch.GroupedTernaryWeight.from_packed(
        packed, torch.ones(4, device=cuda), 640)
    n0 = tgm.grouped_packed_matmul.launches
    got = tdispatch.grouped_ternary_matmul(x, gw,
                                           policy="fixed:grouped_dequant")
    torch.cuda.synchronize()
    assert tgm.grouped_packed_matmul.launches == n0 + 1
    assert seen == [True, True] and got.shape == (4, 5, 256)


# ---------------------------------------------------------------------------
# lut_gather and lut_onehot: x and keys as served
# ---------------------------------------------------------------------------

LUT = {"gather": (tlut.lut_matmul, tlut.lut_matmul_torch),
       "onehot": (tlut.lut_onehot_matmul, tlut.lut_onehot_matmul_torch)}


def _lut_once(fetch, x, keys):
    """One kernel call; it must launch (and count) exactly once, and the
    other fetch's count must not move."""
    fn, _ = LUT[fetch]
    other = LUT["onehot" if fetch == "gather" else "gather"][0]
    n0, o0 = fn.launches, other.launches
    got = fn(x, keys, 3)
    assert fn.launches == n0 + 1 and other.launches == o0
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], keys.shape[0])
    return got


def _served_keys(w: np.ndarray, device) -> torch.Tensor:
    """The keys as a served weight holds them: a view of rows padded to
    16 bytes."""
    wt = torch.from_numpy(w).to(device)
    return tdispatch.TernaryWeight.from_ternary(wt).keys(3)


# bitnet's four projection shapes (K = 2560: G = 854, the last group short)
# and ragged ones
LUT_SHAPES = [(4, 640, 2560), (4, 2560, 2560), (4, 6912, 2560),
              (4, 2560, 6912), (32, 2560, 2560), (32, 2560, 6912),
              (3, 37, 50), (9, 130, 301)]


@pytest.mark.parametrize("B,O,K", LUT_SHAPES)
@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_kernel_on_f32_x_bf16_cannot_hold(cuda, fetch, B, O, K):
    """f32 x whose values need all 24 bits: the tables are f32 sums (the
    one-hot feeds them as three exact bf16 terms)."""
    x, w = _case(40, B, O, K)
    xt = torch.from_numpy(x).to(cuda)
    assert not torch.equal(xt, xt.to(torch.bfloat16).float())
    got = _lut_once(fetch, xt, _served_keys(w, cuda))
    want = LUT[fetch][1](xt, _served_keys(w, cuda), 3)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", LUT_SHAPES)
@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_kernel_on_bf16_x(cuda, fetch, B, O, K):
    x, w = _case(41, B, O, K)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    keys = _served_keys(w, cuda)
    got = _lut_once(fetch, xt, keys)
    want = LUT[fetch][1](xt, keys, 3)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", LUT_SHAPES)
@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_kernel_exact_on_int8_x(cuda, fetch, B, O, K):
    x, w = _case(42, B, O, K, int8=True)
    xt = torch.from_numpy(x).to(cuda)
    got = _lut_once(fetch, xt, _served_keys(w, cuda))
    want = x.astype(np.int64) @ w.T.astype(np.int64)
    assert torch.equal(got.cpu().to(torch.int64), torch.from_numpy(want))


@pytest.mark.parametrize("K", [2560, 301])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_kernel_ragged_rows(cuda, fetch, dtype, B, K):
    x, w = _case(43, B, 640, K)
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    keys = _served_keys(w, cuda)
    got = _lut_once(fetch, xt, keys)
    want = LUT[fetch][1](xt, keys, 3)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("K", [2560, 6912, 301, 50])
@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_kernel_takes_unpadded_x_and_keys_at_any_stride(cuda, fetch, K):
    """x of the logical width (the last group short where K % 3 != 0) gives
    what x zero-padded to G*3 gives, bit for bit; so do the served keys (a
    padded-stride view), contiguous keys (rows not 16-byte aligned where G
    % 16 != 0, copied by the wrapper) and keys at an odd stride."""
    x, w = _case(44, 4, 640, K)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    served = _served_keys(w, cuda)
    G = served.shape[1]
    contiguous = tenc.encode_weight_matrix(torch.from_numpy(w).to(cuda), 3)
    odd = torch.full((640, G + 5), 13, dtype=torch.uint8, device=cuda)
    odd[:, :G] = contiguous
    got = _lut_once(fetch, xt, served)
    xp = torch.nn.functional.pad(xt, (0, G * 3 - K))
    assert torch.equal(got, _lut_once(fetch, xp, served))
    assert torch.equal(got, _lut_once(fetch, xt, contiguous))
    assert torch.equal(got, _lut_once(fetch, xt, odd[:, :G]))
    want = LUT[fetch][1](xt, served, 3)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", [(4, 640, 2560), (4, 2560, 6912),
                                   (32, 6912, 2560), (9, 130, 301)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_kernel_is_deterministic(cuda, fetch, dtype, B, O, K):
    """Split-K partials are summed in split order, with no float atomics:
    two calls on the same inputs agree bit for bit."""
    x, w = _case(45, B, O, K)
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    keys = _served_keys(w, cuda)
    assert torch.equal(_lut_once(fetch, xt, keys), _lut_once(fetch, xt, keys))


@pytest.mark.parametrize("B,O,K", LUT_SHAPES)
def test_lut_onehot_equals_lut_gather(cuda, B, O, K):
    x, w = _case(46, B, O, K)
    xt = torch.from_numpy(x).to(cuda)
    keys = _served_keys(w, cuda)
    got = _lut_once("onehot", xt, keys)
    assert float((got - _lut_once("gather", xt, keys)).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_grid_fills_the_card_at_bitnet_decode(cuda, fetch):
    """At M = 4 every bitnet projection launches at least one block per SM,
    and two where N >= 2560."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, n in [(2560, 640), (2560, 2560), (2560, 6912), (6912, 2560)]:
        x, w = _case(48, 4, n, k)
        xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
        _lut_once(fetch, xt, _served_keys(w, cuda))
        gx, gy, gz, threads = LUT[fetch][0].last_grid
        assert gx * gy * gz >= (2 if n >= 2560 else 1) * sms, (k, n, gx, gy)
        assert threads in (32, 64, 128) and 1 <= gy <= 8


@pytest.mark.parametrize("fetch", ["gather", "onehot"])
def test_lut_wrapper_reads_served_inputs_in_place(cuda, fetch, monkeypatch):
    """bf16 x and served keys reach the kernel with no cast, pad or copy,
    and a CUDA tensor never takes the plain version."""
    def boom(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tlut, "lut_matmul_torch", boom)
    monkeypatch.setattr(tlut, "lut_onehot_matmul_torch", boom)
    rows = tlut.aligned_rows
    seen = []

    def recording(t):
        got, ld = rows(t)
        seen.append(got.data_ptr() == t.data_ptr() and got.dtype == t.dtype)
        return got, ld

    monkeypatch.setattr(tlut, "aligned_rows", recording)
    x, w = _case(47, 4, 640, 2560)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    tw = tdispatch.TernaryWeight.from_ternary(torch.from_numpy(w).to(cuda))
    name = "lut_gather" if fetch == "gather" else "lut_onehot"
    fn = LUT[fetch][0]
    n0 = fn.launches
    tdispatch.ternary_matmul(xt, tw, policy=f"fixed:{name}")
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and seen == [True, True]


# ---------------------------------------------------------------------------
# dequant_packed and w2a8: base-3 bytes and x as served
# ---------------------------------------------------------------------------

PACKED = {"dequant": (tdeq.packed_matmul, tdeq.packed_matmul_torch),
          "w2a8": (tw2a8.w2a8_matmul, tw2a8.w2a8_matmul_torch)}


def _packed_once(kernel, x, packed, k):
    """One kernel call; it must launch (and count) exactly once, and the
    other packed kernel's count must not move."""
    fn, _ = PACKED[kernel]
    other = PACKED["w2a8" if kernel == "dequant" else "dequant"][0]
    n0, o0 = fn.launches, other.launches
    got = fn(x, packed, k)
    assert fn.launches == n0 + 1 and other.launches == o0
    torch.cuda.synchronize()
    assert got.shape == (x.shape[0], packed.shape[0])
    assert got.dtype == (torch.float32 if kernel == "dequant" else torch.int32)
    return got


def _packed_x(kernel, x: np.ndarray, dtype: str, device):
    xt = torch.from_numpy(x).to(device)
    return xt if kernel == "w2a8" else xt.to(getattr(torch, dtype))


# bitnet's four projection shapes at decode and prefill, and ragged ones
PACKED_SHAPES = [(4, 640, 2560), (4, 2560, 2560), (4, 6912, 2560),
                 (4, 2560, 6912), (32, 2560, 2560), (32, 6912, 2560),
                 (32, 2560, 6912), (3, 37, 50), (9, 130, 301)]


@pytest.mark.parametrize("B,O,K", PACKED_SHAPES)
def test_dequant_kernel_on_f32_x_bf16_cannot_hold(cuda, B, O, K):
    """f32 x whose values need all 24 bits: the kernel feeds each as three
    exact bf16 terms."""
    x, w = _case(50, B, O, K)
    xt = torch.from_numpy(x).to(cuda)
    assert not torch.equal(xt, xt.to(torch.bfloat16).float())
    packed = _served_packed(torch.from_numpy(w).to(cuda))
    got = _packed_once("dequant", xt, packed, K)
    want = tdeq.packed_matmul_torch(xt, packed, K)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", PACKED_SHAPES)
def test_dequant_kernel_on_bf16_x(cuda, B, O, K):
    x, w = _case(51, B, O, K)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    packed = _served_packed(torch.from_numpy(w).to(cuda))
    got = _packed_once("dequant", xt, packed, K)
    want = tdeq.packed_matmul_torch(xt, packed, K)
    assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", PACKED_SHAPES)
@pytest.mark.parametrize("kernel", ["dequant", "w2a8"])
def test_packed_kernel_exact_on_int8_x(cuda, kernel, B, O, K):
    """int8 x: w2a8 sums in int32, dequant_packed sums integers below 2^24
    in f32; both equal the int64 product, and w2a8 its plain version."""
    x, w = _case(52, B, O, K, int8=True)
    xt = torch.from_numpy(x).to(cuda)
    packed = _served_packed(torch.from_numpy(w).to(cuda))
    got = _packed_once(kernel, xt, packed, K)
    want = x.astype(np.int64) @ w.T.astype(np.int64)
    assert torch.equal(got.cpu().to(torch.int64), torch.from_numpy(want))
    if kernel == "w2a8":
        assert torch.equal(got, tw2a8.w2a8_matmul_torch(xt, packed, K))


@pytest.mark.parametrize("K", [50, 301, 2560, 4096, 6912])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 33])
@pytest.mark.parametrize("kernel", ["dequant", "w2a8"])
def test_packed_kernel_ragged_rows(cuda, kernel, B, K):
    """Every row tile (8, 16, 32 rows, and more as the grid's z) with M
    past its edge; K = 6912 is not a multiple of 5, so its last byte is
    partial."""
    x, w = _case(53, B, 640, K, int8=kernel == "w2a8")
    xt = _packed_x(kernel, x, "bfloat16", cuda)
    packed = _served_packed(torch.from_numpy(w).to(cuda))
    got = _packed_once(kernel, xt, packed, K)
    want = PACKED[kernel][1](xt, packed, K)
    if kernel == "w2a8":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("K", [2560, 6912, 301, 50])
@pytest.mark.parametrize("kernel", ["dequant", "w2a8"])
def test_packed_kernel_reads_rows_at_any_stride(cuda, kernel, K):
    """The served rows (padded to 128 bytes), unpadded rows (not 16-byte
    aligned where ceil(K/5) % 16 != 0: copied by the wrapper), rows at an
    odd stride, and x zero-padded past K all give the same sums, bit for
    bit."""
    x, w = _case(54, 4, 640, K, int8=kernel == "w2a8")
    xt = _packed_x(kernel, x, "bfloat16", cuda)
    wt = torch.from_numpy(w).to(cuda)
    unpadded = tenc.pack_base3(wt)
    NB = unpadded.shape[1]
    odd = torch.full((640, NB + 3), 7, dtype=torch.uint8, device=cuda)
    odd[:, :NB] = unpadded
    served = _served_packed(wt)
    got = _packed_once(kernel, xt, served, K)
    assert torch.equal(got, _packed_once(kernel, xt, unpadded, K))
    assert torch.equal(got, _packed_once(kernel, xt, odd[:, :NB], K))
    xp = torch.nn.functional.pad(xt, (0, 5 * NB - K))
    assert torch.equal(got, _packed_once(kernel, xp, served, K))
    want = PACKED[kernel][1](xt, served, K)
    if kernel == "w2a8":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= _atol(xt)


@pytest.mark.parametrize("B,O,K", [(4, 640, 2560), (4, 2560, 6912),
                                   (32, 6912, 2560), (9, 130, 301)])
@pytest.mark.parametrize("kernel,dtype", [("dequant", "float32"),
                                          ("dequant", "bfloat16"),
                                          ("w2a8", "int8")])
def test_packed_kernel_is_deterministic(cuda, kernel, dtype, B, O, K):
    """Split-K partials are summed in split order, with no atomics: two
    calls on the same inputs agree bit for bit."""
    x, w = _case(55, B, O, K, int8=dtype == "int8")
    xt = _packed_x(kernel, x, dtype, cuda)
    packed = _served_packed(torch.from_numpy(w).to(cuda))
    assert torch.equal(_packed_once(kernel, xt, packed, K),
                       _packed_once(kernel, xt, packed, K))


@pytest.mark.parametrize("kernel", ["dequant", "w2a8"])
def test_packed_grid_fills_the_card_at_bitnet_decode(cuda, kernel):
    """At M = 4 every bitnet projection launches at least one block per SM,
    and two where N >= 2560."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, n in [(2560, 640), (2560, 2560), (2560, 6912), (6912, 2560)]:
        x, w = _case(56, 4, n, k, int8=kernel == "w2a8")
        xt = _packed_x(kernel, x, "bfloat16", cuda)
        _packed_once(kernel, xt, _served_packed(torch.from_numpy(w).to(cuda)), k)
        gx, gy, gz, threads = PACKED[kernel][0].last_grid
        assert gx * gy * gz >= (2 if n >= 2560 else 1) * sms, (k, n, gx, gy)
        assert threads == 128 and 1 <= gy <= 8 and gz == 1


@pytest.mark.parametrize("kernel", ["dequant", "w2a8"])
def test_packed_wrapper_reads_served_inputs_in_place(cuda, kernel, monkeypatch):
    """bf16 (or int8) x and the served 128-byte padded rows reach the
    kernel through dispatch with no cast or copy, and a CUDA tensor never
    takes the plain version."""
    def boom(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tdeq, "packed_matmul_torch", boom)
    monkeypatch.setattr(tw2a8, "w2a8_matmul_torch", boom)
    rows = tdeq.aligned_rows
    seen = []

    def recording(t):
        got, ld = rows(t)
        seen.append(got.data_ptr() == t.data_ptr() and got.dtype == t.dtype)
        return got, ld

    monkeypatch.setattr(tdeq, "aligned_rows", recording)
    x, w = _case(57, 4, 640, 6912, int8=kernel == "w2a8")
    xt = _packed_x(kernel, x, "bfloat16", cuda)
    packed = _served_packed(torch.from_numpy(w).to(cuda))
    tw = tdispatch.TernaryWeight.from_packed(packed, 1.0, 6912)
    fn = PACKED[kernel][0]
    n0 = fn.launches
    name = "dequant_packed" if kernel == "dequant" else "w2a8"
    got = tdispatch.ternary_matmul(xt, tw, policy=f"fixed:{name}")
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and seen == [True, True]
    assert got.shape == (4, 640)


# ---------------------------------------------------------------------------
# tl2: TL2 words and x as served
# ---------------------------------------------------------------------------


def _tl2_once(x, words, k):
    """One kernel call; it must launch (and count) exactly once."""
    n0 = ttl2.tl2_matmul.launches
    got = ttl2.tl2_matmul(x, words, k)
    assert ttl2.tl2_matmul.launches == n0 + 1
    torch.cuda.synchronize()
    assert got.shape == (x.shape[0], words.shape[0])
    assert got.dtype == torch.float32
    return got


def _served_words(w: np.ndarray, device) -> torch.Tensor:
    """The words as a served weight holds them: a view of rows padded to
    16 bytes with the zero-trit word."""
    wt = torch.from_numpy(w).to(device)
    return tdispatch.TernaryWeight.from_ternary(wt).tl2()


def _tl2_held(got, x, w, words, k):
    """Float x within the f32 tolerance of the plain version; int8 x equal
    to the int64 product and to the plain version."""
    if x.dtype == torch.int8:
        want = x.cpu().to(torch.int64) @ torch.from_numpy(w).to(torch.int64).T
        assert torch.equal(got.cpu().to(torch.int64), want)
        assert torch.equal(got, ttl2.tl2_matmul_torch(x, words, k))
    else:
        want = ttl2.tl2_matmul_torch(x, words, k)
        assert float((got - want).abs().max()) <= _atol(x)


# bitnet's projections at batch-1 and batch-2 decode (bf16 x), at the int8
# path's decode (M = 4) and prefill (M = 32), and ragged ones
TL2_SHAPES = [(1, 2560, 2560), (1, 640, 2560), (1, 6912, 2560),
              (1, 2560, 6912), (2, 2560, 6912), (4, 6912, 2560),
              (32, 2560, 6912), (32, 6912, 2560), (3, 37, 50), (9, 130, 301)]


@pytest.mark.parametrize("B,O,K", TL2_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tl2_kernel_on_served_words(cuda, dtype, B, O, K):
    """Every x dtype as it comes against the served words; f32 x whose
    values need all 24 bits takes the three-term split."""
    x, w = _case(60, B, O, K, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    if dtype == "float32":
        assert not torch.equal(xt, xt.to(torch.bfloat16).float())
    words = _served_words(w, cuda)
    _tl2_held(_tl2_once(xt, words, K), xt, w, words, K)


@pytest.mark.parametrize("K", [97, 301, 6912])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 32, 33])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tl2_kernel_ragged(cuda, dtype, B, K):
    """Every row tile (8, 16, 32 rows, and more as the grid's z) with M
    past its edge; K not a multiple of 10, so the last word is partial."""
    x, w = _case(61, B, 640, K, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    words = _served_words(w, cuda)
    _tl2_held(_tl2_once(xt, words, K), xt, w, words, K)


@pytest.mark.parametrize("K", [97, 301, 2560, 6912])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tl2_kernel_reads_words_at_any_stride(cuda, dtype, K):
    """The served words (a view of rows padded to 16 bytes), contiguous
    unpadded words (rows not 16-byte aligned where ceil(K/10) % 8 != 0:
    copied by the wrapper), words at an odd stride, and x zero-padded to
    10 W columns all give the same sums, bit for bit."""
    x, w = _case(62, 4, 640, K, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    served = _served_words(w, cuda)
    W = served.shape[1]
    contiguous = ttl2.pack_tl2(torch.from_numpy(w).to(cuda))
    odd = torch.full((640, W + 3), 12345, dtype=torch.int16, device=cuda)
    odd[:, :W] = contiguous
    got = _tl2_once(xt, served, K)
    assert torch.equal(got, _tl2_once(xt, contiguous, K))
    assert torch.equal(got, _tl2_once(xt, odd[:, :W], K))
    xp = torch.nn.functional.pad(xt, (0, 10 * W - K))
    assert torch.equal(got, _tl2_once(xp, served, K))
    _tl2_held(got, xt, w, served, K)


@pytest.mark.parametrize("B,O,K", [(1, 640, 2560), (1, 2560, 6912),
                                   (32, 6912, 2560), (9, 130, 301)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tl2_kernel_is_deterministic(cuda, dtype, B, O, K):
    """Split-K partials are summed in split order, with no atomics: two
    calls on the same inputs agree bit for bit."""
    x, w = _case(63, B, O, K, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    words = _served_words(w, cuda)
    assert torch.equal(_tl2_once(xt, words, K), _tl2_once(xt, words, K))


@pytest.mark.parametrize("m,dtype", [(1, "bfloat16"), (2, "bfloat16"),
                                     (4, "int8")])
def test_tl2_grid_fills_the_card_at_bitnet_decode(cuda, m, dtype):
    """At decode every bitnet projection launches at least one block per
    SM, and two where N >= 2560."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, n in [(2560, 640), (2560, 2560), (2560, 6912), (6912, 2560)]:
        x, w = _case(64, m, n, k, int8=dtype == "int8")
        xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
        _tl2_once(xt, _served_words(w, cuda), k)
        gx, gy, gz, threads = ttl2.tl2_matmul.last_grid
        assert gx * gy * gz >= (2 if n >= 2560 else 1) * sms, (k, n, gx, gy)
        assert threads == 128 and 1 <= gy <= 8 and gz == 1


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tl2_wrapper_reads_served_inputs_in_place(cuda, dtype, monkeypatch):
    """x as it comes and the served words reach the kernel through dispatch
    with no cast, pad or copy, and a CUDA tensor never takes the plain
    version."""
    def boom(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ttl2, "tl2_matmul_torch", boom)
    rows = ttl2.aligned_rows
    seen = []

    def recording(t):
        got, ld = rows(t)
        seen.append(got.data_ptr() == t.data_ptr() and got.dtype == t.dtype)
        return got, ld

    monkeypatch.setattr(ttl2, "aligned_rows", recording)
    x, w = _case(65, 1, 640, 6912, int8=dtype == "int8")
    xt = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    tw = tdispatch.TernaryWeight.from_ternary(torch.from_numpy(w).to(cuda))
    assert not tw.tl2().is_contiguous()
    n0 = ttl2.tl2_matmul.launches
    got = tdispatch.ternary_matmul(xt, tw, policy="fixed:tl2")
    torch.cuda.synchronize()
    assert ttl2.tl2_matmul.launches == n0 + 1 and seen == [True, True]
    assert got.shape == (1, 640)


def test_tl2_kernel_refuses_x_wider_than_the_words(cuda):
    words = torch.zeros((4, 5), dtype=torch.int16, device=cuda)
    n0 = ttl2.tl2_matmul.launches
    with pytest.raises(ValueError, match="cover"):
        ttl2.tl2_matmul(torch.zeros((2, 51), device=cuda), words, 50)
    assert ttl2.tl2_matmul.launches == n0
