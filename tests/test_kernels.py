"""Device kernel tests (CPU backend): bit-parity with the host codec."""

import numpy as np
import pytest

from tpuhuff import ByteWeights, HuffTree
from tpuhuff.core.codec import pack_codes_u8
from tpuhuff.kernels import (
    block_bit_lengths,
    encode_blocks,
    histogram,
    make_encode_tables,
    words_to_payload,
)


def _tree_for(data):
    return HuffTree.from_weights(ByteWeights.from_bytes(data))


def test_histogram_matches_bincount():
    rng = np.random.default_rng(0)
    for n in (1, 100, 65536):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        h = np.asarray(histogram(data))
        assert np.array_equal(h, np.bincount(data, minlength=256)), n


def test_histogram_chunked(monkeypatch):
    # force the multi-chunk path with a small chunk size.  (import the module
    # via importlib: the package re-exports the `histogram` FUNCTION under
    # the same name, shadowing the submodule attribute.)
    import importlib

    hk = importlib.import_module("tpuhuff.kernels.histogram")
    monkeypatch.setattr(hk, "_CHUNK", 1 << 14)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (1 << 15) + 999, dtype=np.uint8)
    h = np.asarray(hk.histogram(data))
    assert np.array_equal(h, np.bincount(data, minlength=256))


@pytest.mark.parametrize("alphabet", [2, 37, 256])
@pytest.mark.parametrize("n", [64, 4096])
def test_encode_blocks_bit_parity(alphabet, n):
    rng = np.random.default_rng(n * alphabet)
    data = rng.integers(0, alphabet, n, dtype=np.uint8)
    tree = _tree_for(data)
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    words, bits = encode_blocks(data[None, :], dl, da)
    ref_payload, ref_pad = pack_codes_u8(data, lens, codes)
    total_bits = len(ref_payload) * 8 - ref_pad
    assert int(bits[0]) == total_bits
    assert words_to_payload(np.asarray(words[0]), int(bits[0])) == ref_payload


def test_encode_blocks_batched():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 100, (8, 1024), dtype=np.uint8)
    tree = _tree_for(data.reshape(-1))
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    words, bits = encode_blocks(data, dl, da)
    for b in range(8):
        ref_payload, ref_pad = pack_codes_u8(data[b], lens, codes)
        assert int(bits[b]) == len(ref_payload) * 8 - ref_pad
        assert words_to_payload(np.asarray(words[b]), int(bits[b])) == ref_payload


def test_block_bit_lengths():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (4, 512), dtype=np.uint8)
    tree = _tree_for(data.reshape(-1))
    lens, codes = tree.encode_tables()
    dl, _ = make_encode_tables(lens, codes)
    bl = np.asarray(block_bit_lengths(data, dl))
    expect = lens[data].astype(np.int64).sum(axis=1)
    assert np.array_equal(bl, expect)


def test_zero_len_sentinel_padding():
    # bytes with LUT len 0 contribute no bits — used to pad ragged blocks
    data = np.array([[1, 2, 1, 200, 200, 200, 200, 200]], dtype=np.uint8)
    tree = _tree_for(np.array([1, 2, 1], dtype=np.uint8))
    lens, codes = tree.encode_tables()
    assert lens[200] == 0
    dl, da = make_encode_tables(lens, codes)
    words, bits = encode_blocks(data, dl, da)
    ref_payload, ref_pad = pack_codes_u8(np.array([1, 2, 1], dtype=np.uint8), lens, codes)
    assert int(bits[0]) == len(ref_payload) * 8 - ref_pad
    assert words_to_payload(np.asarray(words[0]), int(bits[0])) == ref_payload


def test_single_symbol_blocks():
    data = np.zeros((2, 256), dtype=np.uint8)
    tree = _tree_for(data.reshape(-1))
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    words, bits = encode_blocks(data, dl, da)
    assert int(bits[0]) == 256  # code "0", 1 bit per byte
    assert words_to_payload(np.asarray(words[0]), 256) == b"\x00" * 32


def test_max_len_32_codes():
    # fib weights → 23-deep tree still packs exactly
    n = 24
    fib = [1, 1]
    for _ in range(n - 2):
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:n] = fib
    tree = HuffTree.from_weights(ByteWeights(counts))
    lens, codes = tree.encode_tables()
    assert int(lens.max()) == n - 1
    rng = np.random.default_rng(0)
    data = rng.integers(0, n, 2048, dtype=np.uint8)
    dl, da = make_encode_tables(lens, codes)
    words, bits = encode_blocks(data[None], dl, da)
    ref_payload, ref_pad = pack_codes_u8(data, lens, codes)
    assert words_to_payload(np.asarray(words[0]), int(bits[0])) == ref_payload
    assert int(bits[0]) == len(ref_payload) * 8 - ref_pad


def test_over_32bit_codes_rejected():
    n = 40
    fib = [1, 1]
    for _ in range(n - 2):
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:n] = fib
    tree = HuffTree.from_weights(ByteWeights(counts))
    lens, codes = tree.encode_tables()
    with pytest.raises(OverflowError):
        make_encode_tables(lens, codes)


@pytest.mark.parametrize("alphabet", [2, 17, 256])
def test_encode_blocks_max_code_len_parity(alphabet):
    rng = np.random.default_rng(alphabet + 99)
    data = rng.integers(0, alphabet, (3, 512), dtype=np.uint8)
    tree = _tree_for(data.reshape(-1))
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    ml = int(lens.max())
    w0, b0 = encode_blocks(data, dl, da)
    w1, b1 = encode_blocks(data, dl, da, max_code_len=ml)
    assert np.array_equal(np.asarray(b0), np.asarray(b1))
    assert w1.shape[1] <= w0.shape[1]
    for b in range(3):
        ref_payload, _ = pack_codes_u8(data[b], lens, codes)
        assert words_to_payload(np.asarray(w1[b]), int(b1[b])) == ref_payload


def test_encode_blocks_max_code_len_with_valid():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 200, (4, 256), dtype=np.uint8)
    valid = np.array([256, 100, 1, 0], dtype=np.int32)
    tree = _tree_for(data.reshape(-1))
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    w, b = encode_blocks(data, dl, da, valid, max_code_len=int(lens.max()))
    for i in range(4):
        ref_payload, ref_pad = pack_codes_u8(data[i, : valid[i]], lens, codes)
        assert int(b[i]) == len(ref_payload) * 8 - ref_pad
        assert words_to_payload(np.asarray(w[i]), int(b[i])) == ref_payload


@pytest.mark.parametrize("alphabet", [2, 17, 41, 256])
def test_encode_canonical_ladder_lut_parity(alphabet):
    from tpuhuff.core.canonical import canonicalize
    from tpuhuff.kernels.encode import make_canonical_encode_tables

    rng = np.random.default_rng(alphabet + 3)
    data = rng.integers(0, alphabet, (4, 512), dtype=np.uint8)
    tree = canonicalize(_tree_for(data.reshape(-1)))
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    ml = int(lens.max())
    tabs = make_canonical_encode_tables(tree)
    assert tabs is not None and tabs[4] == ml
    w0, b0 = encode_blocks(data, dl, da, max_code_len=ml)
    w1, b1 = encode_blocks(data, dl, da, max_code_len=ml,
                           canon_tables=tabs[:4])
    assert np.array_equal(np.asarray(b0), np.asarray(b1))
    assert np.array_equal(np.asarray(w0), np.asarray(w1))


def test_encode_canonical_ladder_missing_letter_sentinel():
    from tpuhuff.core.canonical import canonicalize
    from tpuhuff.kernels.encode import make_canonical_encode_tables

    data = np.array([[1, 2, 1, 200, 200, 200, 200, 200]], dtype=np.uint8)
    tree = canonicalize(_tree_for(np.array([1, 2, 1], dtype=np.uint8)))
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    tabs = make_canonical_encode_tables(tree)
    w, b = encode_blocks(data, dl, da, max_code_len=int(lens.max()),
                         canon_tables=tabs[:4])
    ref_payload, ref_pad = pack_codes_u8(np.array([1, 2, 1], dtype=np.uint8),
                                         lens, codes)
    assert int(b[0]) == len(ref_payload) * 8 - ref_pad
    assert words_to_payload(np.asarray(w[0]), int(b[0])) == ref_payload


def test_encode_canonical_tables_reject_noncanonical():
    from tpuhuff.kernels.encode import make_canonical_encode_tables

    rng = np.random.default_rng(9)
    data = rng.integers(0, 200, 4096, dtype=np.uint8)
    assert make_canonical_encode_tables(_tree_for(data)) is None


def test_count_missing_flags_stale_tree():
    # a tree built WITHOUT byte 200 must not silently drop it (VERDICT r1 #7)
    from tpuhuff.kernels import count_missing

    rng = np.random.default_rng(7)
    train = rng.integers(0, 100, 4096, dtype=np.uint8)
    tree = _tree_for(train)
    lens, codes = tree.encode_tables()
    dl, _ = make_encode_tables(lens, codes)
    clean = train.reshape(16, 256)
    assert count_missing(clean, dl) == 0
    stale = clean.copy()
    stale[3, 17] = 200
    stale[9, 0] = 201
    assert count_missing(stale, dl) == 2
    # bytes past valid_lens are padding and must not count
    valid = np.full(16, 256, np.int32)
    valid[3] = 17  # cuts the first stale byte off
    import jax.numpy as jnp

    assert count_missing(stale, dl, jnp.asarray(valid)) == 1


def test_device_encoder_raises_on_midstream_mutation(tmp_path):
    # .hff --device: file changes between pass 1 and pass 2 -> CompressError
    # (reference comp.rs:427-432 semantics), not silent corruption
    from tpuhuff.core.format import CompressError
    from tpuhuff.io.stream import _device_encoder

    rng = np.random.default_rng(8)
    train = rng.integers(0, 50, 2048, dtype=np.uint8)
    enc = _device_encoder(_tree_for(train))
    bad = train.copy()
    bad[100] = 99
    with pytest.raises(CompressError):
        enc(bad)
