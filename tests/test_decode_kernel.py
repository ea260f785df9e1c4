"""Device decode tests (CPU backend): the XLA scan, the plain reference."""

import numpy as np
import pytest

from tpuhuff import ByteWeights, HuffTree
from tpuhuff.core.codec import pack_codes_u8
from tpuhuff.kernels.decode import (
    decode_blocks_device,
    make_decode_tables,
    payload_to_lane_words,
)

import jax.numpy as jnp


def _decode(rows, bit0, starts, ends, tree, block_len):
    tables, statics = make_decode_tables(tree)
    return np.asarray(
        decode_blocks_device(
            jnp.asarray(rows), jnp.asarray(bit0),
            jnp.asarray((ends - starts).astype(np.int32)),
            *tables, block_len=block_len, **statics,
        )
    )


def _encode_blocks_host(data, block_len, tree):
    lens, codes = tree.encode_tables()
    B = -(-data.size // block_len)
    parts, bit_lens = [], []
    for b in range(B):
        blk = data[b * block_len : (b + 1) * block_len]
        p, pad = pack_codes_u8(blk, lens, codes)
        parts.append(p)
        bit_lens.append(len(p) * 8 - pad)
    # stitch with big-int for the test
    value, total = 0, 0
    for p, nb in zip(parts, bit_lens):
        value = (value << nb) | (int.from_bytes(p, "big") >> (len(p) * 8 - nb))
        total += nb
    pad = (8 - total % 8) % 8
    payload = (value << pad).to_bytes((total + pad) // 8, "big")
    ends = np.cumsum(bit_lens)
    starts = ends - np.array(bit_lens)
    return payload, starts.astype(np.int64), ends.astype(np.int64)


@pytest.mark.parametrize("alphabet", [2, 41, 256])
def test_decode_blocks_device_roundtrip(alphabet):
    rng = np.random.default_rng(alphabet)
    block_len = 512
    data = rng.integers(0, alphabet, 8 * block_len - 100, dtype=np.uint8)
    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    payload, starts, ends = _encode_blocks_host(data, block_len, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    out = _decode(rows, bit0, starts, ends, tree, block_len)
    for b in range(starts.size):
        blk = data[b * block_len : (b + 1) * block_len]
        assert np.array_equal(out[b, : blk.size], blk), b


@pytest.mark.parametrize("block_len", [17, 100, 256])
@pytest.mark.parametrize("alphabet", [2, 41, 256])
def test_decode_blocks_device_block_lengths(alphabet, block_len):
    rng = np.random.default_rng(alphabet * 31 + block_len)
    data = rng.integers(0, alphabet, 8 * block_len - 7, dtype=np.uint8)
    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    payload, starts, ends = _encode_blocks_host(data, block_len, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    out = _decode(rows, bit0, starts, ends, tree, block_len)
    assert out.shape == (starts.size, block_len)
    for b in range(starts.size):
        blk = data[b * block_len : (b + 1) * block_len]
        assert np.array_equal(out[b, : blk.size], blk), b
        assert not out[b, blk.size:].any()  # zero past the symbols


def test_decode_narrow_rows():
    # rows of a single word: the two-word window clamps at the row's end
    data = np.frombuffer(b"ab" * 40, dtype=np.uint8).copy()
    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    payload, starts, ends = _encode_blocks_host(data, 16, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, 16)
    out = _decode(rows[:, :1], bit0, starts, ends, tree, 16)
    assert np.array_equal(out.reshape(-1)[: data.size], data)


def test_decode_single_letter_tree():
    data = np.zeros(100, dtype=np.uint8)
    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    payload, starts, ends = _encode_blocks_host(data, 64, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, 64)
    out = _decode(rows, bit0, starts, ends, tree, 64)
    assert np.array_equal(out[0], np.zeros(64, dtype=np.uint8))


def test_decode_deep_tree():
    n = 24
    fib = [1, 1]
    for _ in range(n - 2):
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:n] = fib
    tree = HuffTree.from_weights(ByteWeights(counts))
    rng = np.random.default_rng(0)
    data = rng.choice(np.arange(n, dtype=np.uint8), 2048,
                      p=np.array(fib) / sum(fib))
    payload, starts, ends = _encode_blocks_host(data, 256, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, 256)
    out = _decode(rows, bit0, starts, ends, tree, 256)
    assert np.array_equal(out.reshape(-1)[: data.size], data)


def test_decode_hf2_device_end_to_end(tmp_path):
    from tpuhuff.io import read_compress_write_hf2, read_hf2_header
    from tpuhuff.kernels.decode import decode_hf2_device

    data = np.random.default_rng(5).integers(0, 77, 33_333, dtype=np.uint8)
    src = tmp_path / "f.bin"
    src.write_bytes(data.tobytes())
    hf2 = str(src) + ".hf2"
    read_compress_write_hf2(str(src), hf2, block_len=2048)
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
        payload = fp.read()
    assert decode_hf2_device(hdr, payload) == data.tobytes()


def _canonical_tree(data):
    from tpuhuff.core.canonical import canonicalize

    return canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(data)))


@pytest.mark.parametrize("alphabet", [2, 41, 256])
@pytest.mark.parametrize("block_len", [64, 256])
def test_decode_blocks_canonical(alphabet, block_len):
    from tpuhuff.kernels.decode import make_canonical_decode_tables

    rng = np.random.default_rng(alphabet * 13 + block_len)
    data = rng.integers(0, alphabet, 8 * block_len - 31, dtype=np.uint8)
    tree = _canonical_tree(data)
    payload, starts, ends = _encode_blocks_host(data, block_len, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    assert make_canonical_decode_tables(tree) is not None, \
        "canonicalized tree must be detected canonical"
    assert make_decode_tables(tree)[1]["canonical"]
    out = _decode(rows, bit0, starts, ends, tree, block_len)
    for b in range(starts.size):
        blk = data[b * block_len : (b + 1) * block_len]
        assert np.array_equal(out[b, : blk.size], blk), b


def test_canonical_detection_rejects_noncanonical():
    from tpuhuff.kernels.decode import make_canonical_decode_tables

    rng = np.random.default_rng(3)
    data = rng.integers(0, 200, 4096, dtype=np.uint8)
    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    # heap-built trees are essentially never canonical for large alphabets
    assert make_canonical_decode_tables(tree) is None
    assert make_canonical_decode_tables(_canonical_tree(data)) is not None


def test_decode_hf2_device_canonical_end_to_end(tmp_path):
    from tpuhuff.io import read_compress_write_hf2, read_hf2_header
    from tpuhuff.kernels.decode import decode_hf2_device

    data = np.random.default_rng(7).integers(0, 130, 20_000, dtype=np.uint8)
    src = tmp_path / "f.bin"
    src.write_bytes(data.tobytes())
    hf2 = str(src) + ".hf2"
    read_compress_write_hf2(str(src), hf2, block_len=1024)
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
        payload = fp.read()
    assert hdr.canonical
    assert decode_hf2_device(hdr, payload) == data.tobytes()
