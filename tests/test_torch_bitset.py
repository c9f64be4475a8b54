"""The port's bitset layout and wire arithmetic against the JAX package's
numpy path: packed words, popcounts, tail masks and the wire checksum
must be word-identical."""
import numpy as np
import pytest
import torch

from repro.core import level_step as jls
from repro.kernels import bitset as jbits
from repro_torch.core import level_step as tls
from repro_torch.kernels import bitset as tbits


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 37, 64, 100])
def test_pack_unpack_word_identical(n):
    rng = np.random.default_rng(n)
    bits = rng.random((3, n)) < 0.5
    want = jbits.pack_bits(bits)
    got = tbits.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbits.unpack_bits(got, n).numpy(), jbits.unpack_bits(want, n))
    # packing along a leading axis
    np.testing.assert_array_equal(
        tbits.pack_bits(torch.from_numpy(bits.T.copy()), dim=0).numpy(),
        jbits.pack_bits(bits.T, axis=0))


def test_popcount_matches_reference_extremes():
    rng = np.random.default_rng(5)
    w = np.concatenate([rng.integers(0, 1 << 32, 64, dtype=np.uint32),
                        np.array([0, 0xFFFFFFFF, 0x80000001], np.uint32)])
    got = tbits.popcount(torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jbits.popcount(w))
    # int32 bit patterns (the top bit set) count the same
    np.testing.assert_array_equal(
        tbits.popcount(torch.from_numpy(w.view(np.int32))).numpy(),
        jbits.popcount(w))


@pytest.mark.parametrize("n,words", [(1, None), (37, None), (37, 4),
                                     (64, 3), (0, 2)])
def test_tail_mask(n, words):
    np.testing.assert_array_equal(tbits.tail_mask(n, words).numpy(),
                                  jbits.tail_mask(n, words))


@pytest.mark.parametrize("n", [1, 17, 32, 45])
def test_packed_any_count_with_dirtied_tail(n):
    rng = np.random.default_rng(n)
    bits = rng.random((4, n)) < 0.4
    words = jbits.pack_bits(bits)
    dirty = words | ~jbits.tail_mask(n)
    for w in (words, dirty):
        np.testing.assert_array_equal(
            tbits.packed_any_count(torch.from_numpy(w), n).numpy(),
            jbits.packed_any_count(w, n))
    assert tbits.n_words(n) == jbits.n_words(n)


@pytest.mark.parametrize("length", [1, 2, 7, 64, 1000])
def test_wire_checksum_matches_numpy_path(length):
    rng = np.random.default_rng(length)
    wire = rng.integers(-(1 << 31), 1 << 31, length, dtype=np.int64)
    wire = wire.astype(np.int32)
    wire[0] = np.int32(-1)                 # top bit set
    want = int(jls.wire_checksum(wire))
    got = tls.wire_checksum(torch.from_numpy(wire))
    assert got.dtype == torch.int32 and int(got) == want


@pytest.mark.parametrize("cp,packed", [(64, False), (64, True),
                                       (7, True), (128, True)])
def test_reassemble_wire_matches_reference(cp, packed):
    rng = np.random.default_rng(cp)
    gsup = rng.integers(0, 1 << 16, cp).astype(np.int64)
    if packed:
        u = np.concatenate([gsup, np.zeros(cp % 2, np.int64)])
        words = (u[0::2] | (u[1::2] << 16)).astype(np.uint32)
        gw = words.view(np.int32)
    else:
        gw = gsup.astype(np.int32)
    body = np.concatenate([gw, np.array([3, 0, 0, 1 << 16, 0, 0, 1, 2, 3],
                                        np.int32)])
    wire = np.concatenate([body, [jls.wire_checksum(body)]]).astype(np.int32)
    assert len(wire) == tls.wire_words(cp, 4, packed=packed) == \
        jls.wire_words(cp, 4, packed=packed)
    np.testing.assert_array_equal(
        tls.reassemble_wire(wire, 4, packed=packed, cp=cp),
        jls.reassemble_wire(wire, 4, packed=packed, cp=cp))
    flipped = wire.copy()
    flipped[1] ^= 1 << 7
    assert tls.reassemble_wire(flipped, 4, packed=packed, cp=cp) is None


@pytest.mark.parametrize("n", [1, 31, 33, 45, 100])
def test_lane_ops_then_count_equal_jax(n):
    """Lane-AND/OR of seeded words (top bits set, pad bits dirtied past a
    ragged n), then the masked count: the port's words and counts equal
    the JAX package's, for uint32 tensors, int32 bit patterns and numpy."""
    rng = np.random.default_rng(100 + n)
    w = tbits.n_words(n)
    a = rng.integers(0, 1 << 32, (5, w), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (5, w), dtype=np.uint32)
    a[:, 0] |= np.uint32(1 << 31)
    b[0] = 0xFFFFFFFF
    for jop, top in ((jbits.lane_and, tbits.lane_and),
                     (jbits.lane_or, tbits.lane_or)):
        want = jop(a, b)
        want_count = jbits.packed_any_count(want, n)
        for ta, tb in ((torch.from_numpy(a), torch.from_numpy(b)),
                       (torch.from_numpy(a.view(np.int32)),
                        torch.from_numpy(b.view(np.int32)))):
            got = top(ta, tb)
            assert got.dtype == torch.uint32
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                tbits.packed_any_count(got, n).numpy(), want_count)
        np.testing.assert_array_equal(top(a, b), want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_workers", [1, 2, 3, 8, 256])
def test_support_path_cost_model_equals_jax(n_workers, packed):
    for c in (1, 31, 32, 33, 1000):
        for g in (1, 31, 32, 33, 2048, 40000):
            got = tbits.support_path_cost_model(c, g, n_workers,
                                                packed=packed)
            want = jbits.support_path_cost_model(c, g, n_workers,
                                                 packed=packed)
            assert got == want and list(got) == list(want)
            assert all(type(v) is float for v in got.values())
