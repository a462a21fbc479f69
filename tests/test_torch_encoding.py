"""The port's weight encodings and quantizers against the JAX package:
byte-identical packings and keys, equal trits and int8 codes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import quantization as jq
from repro.kernels import tl2_matmul as jtl2
from repro_torch.core import encoding as tenc
from repro_torch.core import quantization as tq
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import tl2_matmul as ttl2


@pytest.fixture(autouse=True)
def _port_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    tdispatch.reset_autotune_cache()
    yield
    tdispatch.reset_autotune_cache()


def _trits(seed, shape):
    return np.random.default_rng(seed).integers(-1, 2, size=shape).astype(np.int8)


# K not divisible by 3, 5 or 10
SHAPES = [(7, 37), (16, 121), (3, 1), (5, 2 * 3 * 5 * 7 + 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_base3_and_unpack_byte_identical(shape):
    w = _trits(1, shape)
    jp = np.asarray(jenc.pack_base3(jnp.asarray(w)))
    tp = tenc.pack_base3(torch.from_numpy(w)).numpy()
    assert tp.dtype == np.uint8 and tp.tobytes() == jp.tobytes()
    # with the serving layout's 128-byte row padding the decode still slices
    # the logical width off (padding byte 0 decodes to five -1 trits)
    padded = np.pad(tp, ((0, 0), (0, (-tp.shape[1]) % 128)))
    ju = np.asarray(jenc.unpack_base3(jnp.asarray(padded), shape[1]))
    tu = tenc.unpack_base3(torch.from_numpy(padded), shape[1]).numpy()
    assert np.array_equal(tu, ju) and np.array_equal(tu, w)
    tf = tenc.unpack_base3_to(torch.from_numpy(padded), shape[1], torch.float32)
    assert np.array_equal(tf.numpy(), w.astype(np.float32))


@pytest.mark.parametrize("mu", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_encode_weight_matrix_byte_identical(shape, mu):
    w = _trits(2, shape)
    jk = np.asarray(jenc.encode_weight_matrix(jnp.asarray(w), mu))
    tk = tenc.encode_weight_matrix(torch.from_numpy(w), mu)
    assert tk.numpy().tobytes() == jk.tobytes()
    assert np.array_equal(tenc.combo_matrix_np(mu), jenc.combo_matrix_np(mu))
    back = tenc.decode_groups(tk, mu).numpy().reshape(shape[0], -1)[:, :shape[1]]
    assert np.array_equal(back, w)
    assert (tenc.table_size(mu), tenc.idx_bits(mu), tenc.key_bits(mu)) == \
        (jenc.table_size(mu), jenc.idx_bits(mu), jenc.key_bits(mu))


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_tl2_and_repack_byte_identical(shape):
    w = _trits(3, shape)
    jw = np.asarray(jtl2.pack_tl2(jnp.asarray(w)))
    tw = ttl2.pack_tl2(torch.from_numpy(w))
    assert tw.dtype == torch.int16 and tw.numpy().tobytes() == jw.tobytes()
    packed = np.asarray(jenc.pack_base3(jnp.asarray(w)))
    packed = np.pad(packed, ((0, 0), (0, (-packed.shape[1]) % 128)))
    jr = np.asarray(jtl2.repack_base3_to_tl2(jnp.asarray(packed), shape[1]))
    tr = ttl2.repack_base3_to_tl2(torch.from_numpy(packed), shape[1])
    assert tr.numpy().tobytes() == jr.tobytes() == jw.tobytes()
    assert np.array_equal(ttl2.unpack_tl2(tw, shape[1]).numpy(), w)
    assert np.array_equal(ttl2.unpack_tl2_digits(tw).numpy(),
                          np.asarray(jtl2.unpack_tl2_digits(jnp.asarray(jw))))


@pytest.mark.parametrize("axis", [None, (-2, -1)])
def test_ternarize_matches(axis):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 24, 40)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(torch.bfloat16)
    jt, js = jq.ternarize(jw, axis=axis)
    tt, ts = tq.ternarize(tw, axis=axis)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))


def test_quantize_activations_int8_matches_with_edge_rows():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 33)).astype(np.float32) * 3
    x[1] = 0.0                      # zero row → EPS scale, zero codes
    x[2, 5] = np.inf                # +inf saturates
    x[3, 0] = -np.inf               # -inf saturates
    x[4, 7] = np.nan                # NaN → code 0
    x[5] = 1e-30                    # tiny row
    jx, js = jq.quantize_activations_int8(jnp.asarray(x))
    tx, ts = tq.quantize_activations_int8(torch.from_numpy(x))
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.isfinite(ts.numpy()).all()
    assert tx[1].abs().sum() == 0 and tx[2, 5] == 127 and tx[3, 0] == -127
    assert tx[4, 7] == 0
