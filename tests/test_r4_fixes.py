"""Round-4 regression tests: ADVICE r3 findings + small parity closures."""

import numpy as np
import pytest

from tpuhuff.core.tree import HuffTree
from tpuhuff.core.weights import ByteWeights


def test_threaded_from_bytes_honors_thread_num():
    # parity with the reference API (`weights.rs:293-319`): the thread
    # count is a real knob, and any count gives identical counts
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 1 << 18, dtype=np.uint8).tobytes()
    base = ByteWeights.from_bytes(data)
    for t in (1, 2, 12):
        assert ByteWeights.threaded_from_bytes(data, t) == base


def test_encode_blocks_host_empty_input_empty_table():
    native = pytest.importorskip("tpuhuff.native")
    if not native.available():
        pytest.skip("native runtime unavailable")
    lens = np.zeros(256, np.uint8)
    codes = np.zeros(256, np.uint64)
    lens[65] = 1
    payload, total, bit_lens = native.encode_blocks_host(
        np.zeros(0, np.uint8), 256, lens, codes)
    assert payload == b"" and total == 0 and bit_lens.size == 0


def test_encode_blocks_host_tiny_blocks_threaded_exact():
    # ADVICE r3: with block spans < 8 bits thread-adjacent blocks share
    # seam bytes; the C++ side must serialize.  Skewed 2-symbol tree gives
    # 1-bit codes; block_len=4 -> 4-bit blocks.
    native = pytest.importorskip("tpuhuff.native")
    if not native.available():
        pytest.skip("native runtime unavailable")
    from tpuhuff.core.codec import pack_codes_u8

    rng = np.random.default_rng(11)
    data = rng.choice(np.array([0, 255], np.uint8), size=4093).astype(np.uint8)
    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    lens, codes = tree.encode_tables()
    ref_payload, _ = pack_codes_u8(data, lens, codes)
    for bl in (1, 4, 7):
        payload, total, bit_lens = native.encode_blocks_host(
            data, bl, lens, codes, threads=8)
        assert int(bit_lens.sum()) == total
        assert payload == ref_payload


