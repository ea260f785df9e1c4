"""Round-3 correctness fixes (VERDICT r2 items 5-8).

* generic-letter ltype inference: ``compress(list_of_u16).to_bytes()``
  round-trips (reference parity: `huff_coding/src/comp.rs:353` is typed
  over ``L``, `letter.rs:57-60`)
* ``.hf2`` u16 block-table edge: headroom + hard overflow guard
* big-block device decode without the native runtime falls back to the
  resumable python DFA (never the block_len-step XLA scan)
* every public kernel entry point imports and runs (no rotted public code)
"""

import io

import numpy as np
import pytest

from tpuhuff import ByteWeights, CompressData, HuffTree, compress, decompress
from tpuhuff.core.letters import I8, I16, I64, U8, U16, U32, U64
from tpuhuff.io.hff import hf2_table_width, write_hf2_table_slice


# ---------------------------------------------------------------------------
# generic-letter wire inference (VERDICT r2 missing #5 / next #6)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "letters,want",
    [
        ([1, 2, 2, 3, 3, 3], U8),
        ([1000, 2000, 2000, 3000, 3000, 3000], U16),
        ([70_000, 70_000, 5, 9], U32),
        ([1 << 40, 1, 1, 2], U64),
        ([-1, -1, 4, 4, 9], I8),
        ([-200, -200, 7, 7, 7], I16),
        ([-(1 << 40), 3, 3], I64),
    ],
)
def test_infer_ltype_roundtrip(letters, want):
    comp = compress(letters)
    assert comp.ltype == want
    raw = comp.to_bytes()  # must not raise OverflowError (r2 bug)
    rt = CompressData.try_from_bytes(raw, comp.ltype)
    got = decompress(rt)
    if isinstance(got, bytes):  # u8-valued letters decode to bytes by design
        got = list(got)
    assert got == letters


def test_infer_ltype_explicit_wins():
    comp = compress([5, 6, 6, 7, 7, 7], ltype="u64")
    assert comp.ltype == U64
    rt = CompressData.try_from_bytes(comp.to_bytes(), "u64")
    assert list(decompress(rt)) == [5, 6, 6, 7, 7, 7]


def test_char_letters_still_tree_only():
    # char/str letters have no wire form (`letter.rs:33-37`): in-memory
    # round-trip works, serialization raises the letter type's TypeError
    comp = compress(["a", "b", "b"])
    assert decompress(comp) == ["a", "b", "b"]
    with pytest.raises(TypeError):
        comp.to_bytes()


# ---------------------------------------------------------------------------
# .hf2 u16 table edge (VERDICT r2 weak #5 / next #7)
# ---------------------------------------------------------------------------
def test_hf2_table_width_headroom():
    # block_len * ml = 65535 (the old wrap band): entry must widen to u32,
    # because the transcoder may attribute up to ml-1+7 extra bits to the
    # final block
    assert hf2_table_width(4369, 15) == 4  # 4369*15 == 65535
    assert hf2_table_width(65529, 1) == 4
    assert hf2_table_width(4096, 15) == 2  # comfortably inside u16
    assert hf2_table_width(1 << 28, 16) == 8


def test_write_hf2_table_slice_overflow_raises():
    fp = io.BytesIO(b"\x00" * 64)
    write_hf2_table_slice(fp, 0, 2, 0, np.array([65535], np.uint64))  # fits
    with pytest.raises(OverflowError):
        write_hf2_table_slice(fp, 0, 2, 0, np.array([65536], np.uint64))
    with pytest.raises(OverflowError):
        write_hf2_table_slice(fp, 0, 4, 0, np.array([1 << 32], np.uint64))


# ---------------------------------------------------------------------------
# safe fallback: big-block device decode without the native lib (next #8)
# ---------------------------------------------------------------------------
def test_bigblock_device_decode_without_native_uses_python_dfa(
    tmp_path, monkeypatch
):
    import tpuhuff.io.stream as stream
    import tpuhuff.kernels.decode as kdec

    rng = np.random.default_rng(83)
    data = rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
    src = tmp_path / "x.bin"
    src.write_bytes(data)
    comp = tmp_path / "x.hf2"
    out = tmp_path / "x.out"
    # host-written container with big blocks (> the 2048 device threshold)
    stream.read_compress_write_hf2(str(src), str(comp), block_len=16384)
    monkeypatch.setattr(stream, "_native", lambda: None)

    def _boom(*a, **k):  # the XLA scan path must never engage here
        raise AssertionError("device decode taken for big-block container")

    monkeypatch.setattr(kdec, "decode_rows_device", _boom)
    stream.read_decompress_write_hf2(str(comp), str(out), device=True)
    assert out.read_bytes() == data


# ---------------------------------------------------------------------------
# every public kernel entry imports and runs once (next #5)
# ---------------------------------------------------------------------------
def test_all_public_kernel_entries_run():
    import importlib

    import jax.numpy as jnp

    from tpuhuff.core.canonical import canonicalize
    from tpuhuff.kernels import decode as kdec
    from tpuhuff.kernels import encode as kenc

    # the package re-exports the histogram FUNCTION under the module's name
    khist = importlib.import_module("tpuhuff.kernels.histogram")

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 1024, dtype=np.uint8)
    tree = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(data)))
    lens, codes = tree.encode_tables()
    dl, da = kenc.make_encode_tables(lens, codes)
    ml = int(lens.max())
    canon = kenc.make_canonical_encode_tables(tree)
    assert canon is not None
    blocks = data.reshape(-1, 64)

    ran = set()

    def run(name, thunk):
        out = thunk()
        ran.add(name)
        return out

    run("encode.make_encode_tables", lambda: kenc.make_encode_tables(lens, codes))
    words, bits = run("encode.encode_blocks",
                      lambda: kenc.encode_blocks(blocks, dl, da))
    run("encode.block_bit_lengths", lambda: kenc.block_bit_lengths(blocks, dl))
    run("encode.count_missing", lambda: kenc.count_missing(blocks, dl))
    run("encode.words_to_payload",
        lambda: kenc.words_to_payload(np.asarray(words[0]), int(bits[0])))
    run("encode.make_canonical_encode_tables",
        lambda: kenc.make_canonical_encode_tables(tree))
    run("encode.lut_canonical",
        lambda: kenc.lut_canonical(
            jnp.arange(256, dtype=jnp.int32), *canon[:4], ml, bool(canon[5])))
    run("histogram.histogram", lambda: khist.histogram(data))
    # decode side: one block through every entry
    payload = kenc.words_to_payload(np.asarray(words[0]), int(bits[0]))
    starts = np.array([0], np.int64)
    ends = np.array([int(bits[0])], np.int64)
    nbits = (ends - starts).astype(np.int32)
    rows, bit0 = run("decode.payload_to_lane_words",
                     lambda: kdec.payload_to_lane_words(payload, starts,
                                                        ends, 64))
    run("decode.make_canonical_decode_tables",
        lambda: kdec.make_canonical_decode_tables(tree))
    tables, statics = run("decode.make_decode_tables",
                          lambda: kdec.make_decode_tables(tree))
    outs = [
        run("decode.decode_blocks_device",
            lambda: kdec.decode_blocks_device(
                rows, bit0, nbits, *tables, block_len=64, **statics)),
        run("decode.decode_rows_device",
            lambda: kdec.decode_rows_device(rows, bit0, nbits, tree, 64)),
    ]
    for out in outs:
        assert np.array_equal(np.asarray(out)[0], blocks[0])

    class _Hdr:
        block_len = 64
        orig_len = 64
        end_bits = ends.astype(np.uint64)

    _Hdr.tree = tree
    assert run("decode.decode_hf2_device",
               lambda: kdec.decode_hf2_device(_Hdr, payload)) == blocks[0].tobytes()

    # completeness: every exported kernel name was exercised
    for mod, prefix in (
        (kenc, "encode"), (khist, "histogram"), (kdec, "decode"),
    ):
        for name in mod.__all__:
            assert f"{prefix}.{name}" in ran, f"{prefix}.{name}"
