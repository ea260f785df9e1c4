"""Card tests: the device routes compiled for the GPU, checked exactly.

Skip without a GPU.  Run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import hashlib

import numpy as np
import pytest

import jax.numpy as jnp

from bench import make_textlike
from tpuhuff import ByteWeights, HuffTree, native
from tpuhuff.core.canonical import build_tree_for_device, canonicalize

pytestmark = pytest.mark.gpu

N = 4 << 20


@pytest.fixture(scope="module")
def data():
    return make_textlike(N, seed=11)


@pytest.mark.parametrize("canonical", [True, False], ids=["canon", "foreign"])
def test_decode_on_gpu(gpu, data, canonical):
    from tpuhuff.kernels.decode import (
        decode_blocks_device, make_decode_tables, payload_to_lane_words,
    )

    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    if canonical:
        tree = canonicalize(tree)
    lens, codes = tree.encode_tables()
    payload, _, bit_lens = native.encode_blocks_host(data, 256, lens, codes)
    ends = np.cumsum(bit_lens.astype(np.int64))
    starts = ends - bit_lens.astype(np.int64)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, 256)
    args = (jnp.asarray(rows), jnp.asarray(bit0),
            jnp.asarray((ends - starts).astype(np.int32)))
    tables, statics = make_decode_tables(tree)
    assert statics["canonical"] == canonical
    out = np.asarray(decode_blocks_device(*args, *tables, block_len=256,
                                          **statics))
    assert np.array_equal(out.reshape(-1), data)


def test_encode_and_histogram_on_gpu(gpu, data):
    from tpuhuff.dist import stitch_words
    from tpuhuff.kernels.encode import (
        encode_blocks, make_canonical_encode_tables, make_encode_tables,
    )
    from tpuhuff.kernels.histogram import histogram

    counts = np.bincount(data, minlength=256)
    assert np.array_equal(np.asarray(histogram(jnp.asarray(data))), counts)
    tree = canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    tabs = make_canonical_encode_tables(tree)
    for canon in (tabs[:4], None):  # ladder and take lookups
        words, bits = encode_blocks(
            jnp.asarray(data.reshape(-1, 256)), dl, da,
            max_code_len=int(lens.max()), canon_tables=canon,
            full_alphabet=bool(tabs[5]))
        payload, _ = stitch_words(np.asarray(words),
                                  np.asarray(bits).astype(np.uint64))
        ref, _ = native.encode(data, lens, codes)
        assert hashlib.sha256(payload).digest() == hashlib.sha256(ref).digest()


def test_device_hf2_file_roundtrip_on_gpu(gpu, data, tmp_path):
    from tpuhuff.io import read_compress_write_hf2, read_decompress_write_hf2

    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    host, dev, back = (str(tmp_path / x) for x in ("h.hf2", "d.hf2", "b"))
    read_compress_write_hf2(str(src), host, block_len=256)
    read_compress_write_hf2(str(src), dev, device=True)
    assert open(dev, "rb").read() == open(host, "rb").read()
    read_decompress_write_hf2(dev, back, device=True)
    assert open(back, "rb").read() == data.tobytes()
