"""The grouped (MoE expert stack) kernels' operands on the CPU: what
dispatch hands the ``grouped_dequant`` wrapper, and how the wrapper lays x
and the served bytes out for the CUDA kernel (``grouped_operands``, the
same code the card runs, on CPU tensors).  The kernels themselves run only
on the card (``tests/test_torch_cuda.py``); their plain versions are held
to the JAX package in ``tests/test_torch_moe.py``.
"""

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.core import encoding as tenc
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import grouped_matmul as tgm


def _served(w: torch.Tensor) -> torch.Tensor:
    """Stacked base-3 bytes ``[E, N, NB]`` with the serving artifact's
    128-byte row padding."""
    packed = tenc.pack_base3(w)
    return torch.nn.functional.pad(packed, (0, (-packed.shape[-1]) % 128))


def _case(seed, E, C, K, N, dtype):
    g = torch.Generator().manual_seed(seed)
    if dtype == "int8":
        x = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8)
    else:
        x = torch.randn((E, C, K), generator=g).to(getattr(torch, dtype))
    w = torch.randint(-1, 2, (E, N, K), generator=g, dtype=torch.int8)
    return x, w


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_run_grouped_dequant_hands_x_to_the_wrapper_uncast(dtype, monkeypatch):
    """dispatch passes x as it comes (the kernel reads f32, bf16 and int8
    as they are) and the served bytes as they lie."""
    seen = []

    def recording(x, packed, n):
        seen.append((x.dtype, x.data_ptr(), packed.data_ptr()))
        return tgm.grouped_packed_matmul_torch(x, packed, n)

    monkeypatch.setattr(tdispatch, "grouped_packed_matmul", recording)
    x, w = _case(1, 4, 5, 301, 24, dtype)
    gw = tdispatch.GroupedTernaryWeight.from_packed(_served(w),
                                                    torch.ones(4), 301)
    y = tdispatch.grouped_ternary_matmul(x, gw, policy="fixed:grouped_dequant")
    assert seen == [(x.dtype, x.data_ptr(), gw.packed().data_ptr())]
    assert y.shape == (4, 5, 24)


def test_grouped_operands_read_served_bytes_and_bf16_x_in_place():
    """The MoE dispatch buffer (bf16, a view of a contiguous buffer) and the
    served bytes (rows padded to 128) are read where they lie: the same
    data, ``ldx = K`` and ``ldw`` = the padded row's width."""
    E, C, K, N = 4, 5, 1000, 24
    x, w = _case(2, E, C, K, N, "bfloat16")
    buf = torch.zeros((E * C + 1, K), dtype=torch.bfloat16)
    buf[:-1] = x.reshape(E * C, K)
    disp = buf[:-1].reshape(E, C, K)
    packed = _served(w)
    assert packed.shape[-1] == 256 > -(-K // 5)
    x2, ldx, p2, ldw = tgm.grouped_operands(disp, packed)
    assert x2.data_ptr() == disp.data_ptr() and ldx == K
    assert x2.shape == (E * C, K) and torch.equal(x2, x.reshape(E * C, K))
    assert p2.data_ptr() == packed.data_ptr() and ldw == 256
    assert p2.shape == (E * N, 256)
    assert torch.equal(p2, packed.reshape(E * N, 256))


@pytest.mark.parametrize("layout", ["contiguous", "experts_apart"])
def test_grouped_operands_copy_int8_x_with_odd_k_to_aligned_rows(layout):
    """int8 x with odd K (rows 301 bytes apart) and unpadded bytes (rows 61
    bytes apart) are copied to rows 16-byte aligned, with the same values;
    so is x whose experts do not lie one stride apart."""
    E, C, K, N = 3, 5, 301, 20
    x, w = _case(3, E, C, K, N, "int8")
    if layout == "experts_apart":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    packed = tenc.pack_base3(w)
    x2, ldx, p2, ldw = tgm.grouped_operands(x, packed)
    assert x2.data_ptr() != x.data_ptr() and x2.data_ptr() % 16 == 0
    assert ldx % 16 == 0 and ldx >= K and x2.stride() == (ldx, 1)
    assert torch.equal(x2, x.reshape(E * C, K))
    assert p2.data_ptr() % 16 == 0 and ldw % 16 == 0 and ldw >= 61
    assert p2.stride() == (ldw, 1)
    assert torch.equal(p2, packed.reshape(E * N, 61))
