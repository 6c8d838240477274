"""repro_torch.sparse.formats against repro.sparse.formats: the tables,
padding, densification and palette packing are identical."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import formats as jf
from repro_torch.sparse import formats as tf
from torch_parity import block_sparse, port_format

CASES = [((64, 128), (8, 128)), ((100, 70), (8, 64)), ((96, 160), (32, 32)),
         ((128, 64), (16, 16)), ((8, 960), (8, 128))]


def _assert_same_format(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(a, torch.Tensor):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
        else:
            assert tuple(a) == tuple(b) if isinstance(a, tuple) else a == b, f.name


@pytest.mark.parametrize("shape,block", CASES)
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_dense_to_bcsr_tables_identical(shape, block, density):
    w = block_sparse(np.random.default_rng(1), *shape, block, density)
    t, j = tf.dense_to_bcsr(w, block), jf.dense_to_bcsr(w, block)
    _assert_same_format(t, j)
    assert t.nbytes == j.nbytes and t.block_grid == j.block_grid
    np.testing.assert_array_equal(tf.bcsr_to_dense(t).numpy(),
                                  np.asarray(jf.bcsr_to_dense(j)))


@pytest.mark.parametrize("shape,block", CASES[:3])
def test_pad_bcsr_identical(shape, block):
    w = block_sparse(np.random.default_rng(2), *shape, block, 0.4)
    t, j = tf.dense_to_bcsr(w, block), jf.dense_to_bcsr(w, block)
    n_slots = t.data.shape[0] + 3
    jmax, jmax_t = t.gather_idx.shape[1] + 2, t.gather_t_idx.shape[1] + 1
    tp, jp = tf.pad_bcsr(t, n_slots, jmax, jmax_t), jf.pad_bcsr(j, n_slots, jmax, jmax_t)
    _assert_same_format(tp, jp)
    np.testing.assert_array_equal(tf.bcsr_to_dense(tp).numpy(),
                                  np.asarray(jf.bcsr_to_dense(jp)))
    with pytest.raises(ValueError):
        tf.pad_bcsr(t, 0, jmax, jmax_t)


def test_dense_to_bcsr_rejects_ragged_without_padding():
    with pytest.raises(ValueError):
        tf.dense_to_bcsr(np.ones((10, 10), np.float32), (8, 8),
                         pad_rows_to_multiple=False)


def test_uint4_pack_matches_reference():
    codes = np.random.default_rng(3).integers(0, 16, size=(5, 8, 64)).astype(np.uint8)
    packed = tf.pack_uint4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jf.pack_uint4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tf.unpack_uint4(packed).numpy(), codes)
    np.testing.assert_array_equal(
        tf.unpack_uint4(packed).numpy(),
        np.asarray(jf.unpack_uint4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_dequantize_codes_matches_reference(bits, lead):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 1 << bits, size=lead + (6, 8, 16)).astype(np.uint8)
    palette = rng.normal(size=lead + (1 << bits,)).astype(np.float32)
    palette[..., 0] = 0.0
    stored = codes
    if bits == 4:
        stored = np.asarray(jf.pack_uint4(jnp.asarray(codes)))
    got = tf.dequantize_codes(torch.tensor(stored), torch.tensor(palette), bits)
    want = jf.dequantize_codes(jnp.asarray(stored), jnp.asarray(palette), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[codes == 0] == 0).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_palette_bcsr_dequantize_and_bytes(bits):
    from repro.sparse.compress import quantize_bcsr
    w = block_sparse(np.random.default_rng(5), 64, 128, (8, 64), 0.5)
    jq = quantize_bcsr(jf.dense_to_bcsr(w, (8, 64)), bits)
    tq = port_format(jq)
    assert isinstance(tq, tf.PaletteBCSR) and tq.bits == bits
    assert tq.nbytes == jq.nbytes and tq.bcsr_equiv_nbytes == jq.bcsr_equiv_nbytes
    _assert_same_format(tq.dequantize(), jq.dequantize())
    np.testing.assert_array_equal(tq.to_dense().numpy(), np.asarray(jq.to_dense()))


def test_stacked_store_slicing_and_device_move():
    w = block_sparse(np.random.default_rng(6), 64, 128, (8, 128), 0.5)
    m = tf.dense_to_bcsr(w, (8, 128))
    stacked = m.map(lambda t: torch.stack([t, t]))
    s1 = stacked[1]
    _assert_same_format(s1, jf.dense_to_bcsr(w, (8, 128)))
    assert s1.data.is_contiguous() and s1.data.data_ptr() != stacked.data.data_ptr()
    moved = m.to("cpu")
    assert moved.data.device.type == "cpu" and moved.shape == m.shape
