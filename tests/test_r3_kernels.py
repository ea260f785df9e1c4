"""Encode-program ride-alongs (missing-letter count, histogram) and the
histogram's exactness, on the CPU backend."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpuhuff.core.canonical import canonicalize
from tpuhuff.core.codec import pack_codes_u8
from tpuhuff.core.tree import HuffTree
from tpuhuff.core.weights import ByteWeights
from tpuhuff.kernels.encode import (
    encode_blocks, make_canonical_encode_tables, make_encode_tables,
    words_to_payload,
)


def _tree_tables(data_bytes):
    tree = canonicalize(HuffTree.from_weights(
        ByteWeights.from_bytes(data_bytes)))
    lens_lut, codes_lut = tree.encode_tables()
    canon = make_canonical_encode_tables(tree)
    return tree, np.asarray(lens_lut), np.asarray(codes_lut), canon


def test_canonical_encode_valid_lens_parity_and_miss():
    rng = np.random.default_rng(3)
    base = np.frombuffer(b"canonical ladder parity 012345 " * 4096,
                         dtype=np.uint8)
    data = base[: 200 * 256].reshape(200, 256).copy()
    data[3, :40] = rng.integers(0, 200, 40, dtype=np.uint8)
    tree, lens_lut, codes_lut, canon = _tree_tables(data.tobytes())
    dl, da = make_encode_tables(lens_lut, codes_lut)
    valid = np.full(200, 256, np.int32)
    valid[3] = 40
    valid[199] = 1
    w, b, m = encode_blocks(
        jnp.asarray(data), dl, da, jnp.asarray(valid), max_code_len=canon[4],
        canon_tables=canon[:4], full_alphabet=bool(canon[5]), with_miss=True)
    assert int(m) == 0
    for i in (0, 3, 64, 199):
        ref, _ = pack_codes_u8(data[i, : valid[i]], lens_lut, codes_lut)
        assert words_to_payload(np.asarray(w[i]), int(b[i])) == ref


def test_canonical_encode_miss_detects_stale_tree():
    # build a tree over a limited alphabet, then inject a foreign byte
    data = np.frombuffer(b"abcabcababc!" * 512, dtype=np.uint8)[
        : 16 * 256].reshape(16, 256).copy()
    tree, lens_lut, codes_lut, canon = _tree_tables(data.tobytes())
    assert canon is not None and not canon[5]  # sparse alphabet
    dl, da = make_encode_tables(lens_lut, codes_lut)
    data2 = data.copy()
    data2[4, 7] = 255  # not in the alphabet
    _, _, m = encode_blocks(
        jnp.asarray(data2), dl, da, max_code_len=canon[4],
        canon_tables=canon[:4], full_alphabet=False, with_miss=True)
    assert int(m) == 1


def test_encode_hist_data_rides_along():
    # the adaptive dataset path: the histogram of a second operand comes
    # back from the encode program, exact, beside the packed words
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (192, 256), dtype=np.uint8)
    tree, lens_lut, codes_lut, canon = _tree_tables(data.tobytes())
    dl, da = make_encode_tables(lens_lut, codes_lut)
    hist_src = rng.integers(0, 256, 10_000, dtype=np.uint8)
    words, bits, miss, hist = encode_blocks(
        jnp.asarray(data), dl, da, max_code_len=canon[4],
        canon_tables=canon[:4], full_alphabet=bool(canon[5]),
        with_miss=True, hist_data=jnp.asarray(hist_src))
    assert int(miss) == 0
    assert np.array_equal(np.asarray(hist),
                          np.bincount(hist_src, minlength=256))
    for b in (0, 63, 191):
        ref, _ = pack_codes_u8(data[b], lens_lut, codes_lut)
        assert words_to_payload(np.asarray(words[b]), int(bits[b])) == ref


# chunk = 2^22 bytes per matrix product: below, at and above it
@pytest.mark.parametrize("n", [1, 255, 100_000, 1 << 22, (1 << 22) + 7])
def test_histogram_exact(n):
    from tpuhuff.kernels.histogram import histogram

    rng = np.random.default_rng(n)
    d = rng.integers(0, 256, n, dtype=np.uint8)
    got = np.asarray(histogram(jnp.asarray(d)))
    assert got.dtype == np.int32
    assert np.array_equal(got, np.bincount(d, minlength=256))


def test_histogram_one_hot_counts_stay_exact():
    # every byte equal: one bin takes the whole chunk, the largest count a
    # float32 partial sum must hold exactly (2^22 < 2^24)
    from tpuhuff.kernels.histogram import histogram

    d = np.full((1 << 22) + 3, 201, np.uint8)
    got = np.asarray(histogram(jnp.asarray(d)))
    assert got[201] == d.size and got.sum() == d.size


def test_encode_blocks_with_miss_nonfused_path():
    # force the XLA merge (no canon tables) — miss comes from the inline pass
    data = np.frombuffer(b"xyzzyx" * 512, dtype=np.uint8)[
        : 8 * 128].reshape(8, 128).copy()
    tree, lens_lut, codes_lut, _ = _tree_tables(data.tobytes())
    dl, da = make_encode_tables(lens_lut, codes_lut)
    data2 = data.copy()
    data2[2, 3] = 81  # 'Q' not in alphabet
    w, b, m = encode_blocks(jnp.asarray(data2), dl, da,
                            max_code_len=int(lens_lut.max()),
                            with_miss=True)
    assert int(m) == 1


def test_histogram_dispatcher_cpu_matches():
    from tpuhuff.kernels.histogram import histogram

    rng = np.random.default_rng(9)
    d = rng.integers(0, 256, 70_000, dtype=np.uint8)
    got = np.asarray(histogram(jnp.asarray(d)))
    assert np.array_equal(got, np.bincount(d, minlength=256))
