"""The decode scan (the one device decode route) against the input bytes and
a bit-by-bit Python reference, plus the programs the dispatch lowers to."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpuhuff import ByteWeights, HuffTree
from tpuhuff.core.canonical import canonicalize
from tpuhuff.kernels import decode as kdec
from tpuhuff.kernels.decode import (
    decode_blocks_device,
    make_decode_tables,
    payload_to_lane_words,
)

from test_decode_kernel import _encode_blocks_host


def _lanes(data, block_len, tree):
    payload, starts, ends = _encode_blocks_host(data, block_len, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    return rows, bit0, (ends - starts).astype(np.int32)


def _scan(rows, bit0, nbits, tree, block_len):
    tables, statics = make_decode_tables(tree)
    return np.asarray(decode_blocks_device(
        jnp.asarray(rows), jnp.asarray(bit0), jnp.asarray(nbits), *tables,
        block_len=block_len, **statics))


def _reference(rows, bit0, nbits, tree, block_len):
    """Lane by lane, bit by bit: match the code at the cursor; stop at the
    first code that would run past the lane's bit budget."""
    codes = {(c.value, c.length): int(letter)
             for letter, c in tree.read_codes().items()}
    out = np.zeros((rows.shape[0], block_len), np.uint8)
    for k, row in enumerate(rows):
        bits = "".join(format(int(w), "032b") for w in row)
        pos, used = int(bit0[k]), 0
        for j in range(block_len):
            for length in range(1, 33):
                key = (int(bits[pos:pos + length], 2), length)
                if key in codes:
                    break
            if used + length > nbits[k]:
                break
            out[k, j] = codes[key]
            pos += length
            used += length
    return out


def _tree(data, canonical):
    tree = HuffTree.from_weights(ByteWeights.from_bytes(data))
    return canonicalize(tree) if canonical else tree


@pytest.mark.parametrize("canonical", [True, False], ids=["canon", "foreign"])
@pytest.mark.parametrize("block_len", [18, 64, 256])
@pytest.mark.parametrize("alphabet", [2, 41, 256])
def test_scan_decode_roundtrip(alphabet, block_len, canonical):
    rng = np.random.default_rng(alphabet * 7 + block_len)
    # ragged tail: the last block is partial
    data = rng.integers(0, alphabet, 5 * block_len - 3, dtype=np.uint8)
    tree = _tree(data, canonical)
    if canonical or alphabet == 256:  # 256 letters: never canonical by chance
        assert make_decode_tables(tree)[1]["canonical"] == canonical
    rows, bit0, nbits = _lanes(data, block_len, tree)
    out = _scan(rows, bit0, nbits, tree, block_len)
    assert out.shape == (rows.shape[0], block_len) and out.dtype == np.uint8
    assert np.array_equal(out.reshape(-1)[: data.size], data)
    assert not out.reshape(-1)[data.size:].any()  # zero past the symbols


@pytest.mark.parametrize("letters", [[9], [7, 200]], ids=["one", "two"])
def test_scan_decode_max_code_len_1(letters):
    rng = np.random.default_rng(len(letters))
    data = rng.choice(np.array(letters, np.uint8), 300).astype(np.uint8)
    tree = _tree(data, True)
    tables, statics = make_decode_tables(tree)
    assert statics["max_len"] == 1
    rows, bit0, nbits = _lanes(data, 64, tree)
    out = _scan(rows, bit0, nbits, tree, 64)
    assert np.array_equal(out.reshape(-1)[: data.size], data)


@pytest.mark.parametrize("canonical", [True, False], ids=["canon", "foreign"])
def test_scan_decode_deep_tree(canonical):
    # Fibonacci counts: 23-bit codes, window spans two words every symbol
    n = 24
    fib = [1, 1]
    for _ in range(n - 2):
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:n] = fib
    tree = HuffTree.from_weights(ByteWeights(counts))
    if canonical:
        tree = canonicalize(tree)
    assert max(c.length for c in tree.read_codes().values()) == n - 1
    rng = np.random.default_rng(0)
    # rarest letters included so the longest codes really occur
    data = np.concatenate([
        np.arange(n, dtype=np.uint8),
        rng.choice(np.arange(n, dtype=np.uint8), 1000,
                   p=np.array(fib) / sum(fib)),
    ]).astype(np.uint8)
    rows, bit0, nbits = _lanes(data, 64, tree)
    out = _scan(rows, bit0, nbits, tree, 64)
    assert np.array_equal(out.reshape(-1)[: data.size], data)


def test_scan_decode_one_word_rows():
    data = np.frombuffer(b"ab" * 12, dtype=np.uint8).copy()
    tree = _tree(data, True)
    rows, bit0, nbits = _lanes(data, 8, tree)
    rows = rows[:, :1]
    assert rows.shape == (3, 1)
    out = _scan(rows, bit0, nbits, tree, 8)
    assert out.shape == (3, 8)
    assert np.array_equal(out.reshape(-1), data)


def test_scan_decode_zero_bit_lanes_emit_zeros():
    rng = np.random.default_rng(6)
    data = rng.integers(0, 100, 4 * 64, dtype=np.uint8)
    tree = _tree(data, True)
    rows, bit0, nbits = _lanes(data, 64, tree)
    nbits = nbits.copy()
    nbits[1] = 0
    out = _scan(rows, bit0, nbits, tree, 64)
    assert not out[1].any()
    assert np.array_equal(out[2], data[128:192])


@pytest.mark.parametrize("canonical", [True, False], ids=["canon", "foreign"])
def test_scan_decode_matches_reference_on_arbitrary_bits(canonical):
    # garbage payload bits and odd bit budgets: symbol for symbol, including
    # where each lane stops (12-word rows: no window reads past the row)
    rng = np.random.default_rng(12)
    data = rng.integers(0, 180, 2000, dtype=np.uint8)
    tree = _tree(data, canonical)
    rows = rng.integers(0, 2**32, (9, 12), dtype=np.uint32)
    bit0 = rng.integers(0, 32, 9).astype(np.int32)
    nbits = rng.integers(0, 300, 9).astype(np.int32)
    assert np.array_equal(_scan(rows, bit0, nbits, tree, 32),
                          _reference(rows, bit0, nbits, tree, 32))


def test_scan_decode_matches_reference_on_real_lanes():
    rng = np.random.default_rng(13)
    data = rng.integers(0, 60, 6 * 40 - 5, dtype=np.uint8)
    tree = _tree(data, False)
    rows, bit0, nbits = _lanes(data, 40, tree)
    assert np.array_equal(_scan(rows, bit0, nbits, tree, 40),
                          _reference(rows, bit0, nbits, tree, 40))


# ---------------------------------------------------------------------------
# one route on every platform
# ---------------------------------------------------------------------------
def _routes_in(lowered_text):
    """What a lowered decode program is made of: the scan is a while loop;
    a hand-written kernel would be a custom call."""
    found = set()
    if "stablehlo.custom_call" in lowered_text:
        found.add("custom_call")
    if "stablehlo.while" in lowered_text:
        found.add("scan")
    return found


def _dispatch_args(canonical=True):
    rng = np.random.default_rng(2)
    data = rng.integers(0, 60, 3 * 64, dtype=np.uint8)
    tree = _tree(data, canonical)
    return data, tree, _lanes(data, 64, tree)


@pytest.mark.parametrize("canonical", [True, False], ids=["canon", "foreign"])
@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_decode_dispatch_picks_one_route(platform, canonical):
    _, tree, (rows, bit0, nbits) = _dispatch_args(canonical)
    tables, statics = make_decode_tables(tree)
    text = decode_blocks_device.trace(
        jnp.asarray(rows), jnp.asarray(bit0), jnp.asarray(nbits), *tables,
        block_len=64, **statics,
    ).lower(lowering_platforms=(platform,)).as_text()
    assert _routes_in(text) == {"scan"}


def test_decode_dispatch_runs_the_scan_on_the_cpu():
    data, tree, (rows, bit0, nbits) = _dispatch_args()
    out = kdec.decode_rows_device(rows, bit0, nbits, tree, 64)
    assert np.array_equal(out.reshape(-1), data)
    assert np.array_equal(out, _scan(rows, bit0, nbits, tree, 64))


def _sharded_case():
    from jax.sharding import Mesh

    from tpuhuff.dist.mesh import BLOCK_AXIS

    rng = np.random.default_rng(8)
    data = rng.integers(0, 90, 8 * 64, dtype=np.uint8)
    tree = _tree(data, False)
    rows, bit0, nbits = _lanes(data, 64, tree)
    mesh = Mesh(np.asarray(jax.devices()[:4]), (BLOCK_AXIS,))
    return data, tree, (jnp.asarray(rows), jnp.asarray(bit0),
                        jnp.asarray(nbits)), mesh


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_sharded_decode_takes_the_same_dispatch(platform):
    from tpuhuff.dist.block import _decode_program

    _, tree, args, mesh = _sharded_case()
    tables, statics = make_decode_tables(tree)
    text = _decode_program(mesh, 64, **statics).trace(
        *args, *tables).lower(lowering_platforms=(platform,)).as_text()
    assert _routes_in(text) == {"scan"}


def test_sharded_decode_on_a_cpu_mesh_takes_the_scan(monkeypatch):
    # nothing keys on the default backend: a CPU mesh on a GPU host decodes
    from tpuhuff.dist import sharded_decode_blocks

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    data, tree, args, mesh = _sharded_case()
    out = np.asarray(sharded_decode_blocks(*args, tree, 64, mesh))
    assert np.array_equal(out.reshape(-1), data)


def test_sharded_programs_compile_once_per_mesh():
    from tpuhuff.dist import sharded_decode_blocks
    from tpuhuff.dist.block import _decode_program

    data, tree, args, mesh = _sharded_case()
    _decode_program.cache_clear()
    for _ in range(3):
        out = np.asarray(sharded_decode_blocks(*args, tree, 64, mesh))
        assert np.array_equal(out.reshape(-1), data)
    info = _decode_program.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    assert _decode_program(mesh, 64, **make_decode_tables(tree)[1]
                           )._cache_size() == 1
