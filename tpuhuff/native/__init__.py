"""ctypes bindings to the C++ host runtime (``cpp/huffc.cpp``).

The native library is built from ``cpp/huffc.cpp`` into the git-ignored
``build/`` directory on first use (no pip/pybind needed — plain ``g++ -shared``
+ ctypes); ``python -m tpuhuff --warmup`` builds it up front.  Every entry point has a numpy fallback in
:mod:`tpuhuff.core`, so the framework works without a compiler; with it, the
host paths run at memory-bandwidth-class speed:

* :func:`hist`          — threaded byte histogram
* :func:`encode`        — threaded MSB-first bit packer (exact
  `comp.rs:419-451` semantics incl. padding)
* :func:`build_dfa`     — byte-driven DFA tables from flat tree arrays
* :func:`decode`        — table decode of a bit range
* :func:`decode_blocks` — threaded decode over independent bit ranges
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "available",
    "hist",
    "encode",
    "build_dfa",
    "decode",
    "decode_resume",
    "decode_blocks",
    "decode_index",
    "crc32",
    "crc32_blocks",
    "extract_rows",
    "index_blocks",
    "spec_index",
    "stitch_blocks",
    "DfaTables",
    "num_threads",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC_PATH = os.path.join(_REPO_ROOT, "cpp", "huffc.cpp")
_LIB_PATH = os.path.join(_REPO_ROOT, "build", "libhuffc.so")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def num_threads() -> int:
    return max(1, os.cpu_count() or 1)


def _build() -> bool:
    if not os.path.exists(_SRC_PATH):
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # build to a private name and rename into place: concurrent processes
    # (test workers) must never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    # prefer linking zlib (its SIMD crc32 is ~2x our slicing-by-8); fall
    # back to the self-contained build when libz/headers are absent
    variants = [
        ("-march=native", True), ("-march=native", False),
        ("", True), ("", False),
    ]
    for arch, use_z in variants:
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-pthread", "-funroll-loops"]
        if arch:
            cmd.append(arch)
        if use_z:
            cmd.append("-DHUFFC_USE_ZLIB")
        cmd += ["-o", tmp, _SRC_PATH]
        if use_z:
            cmd.append("-lz")
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, _LIB_PATH)
                return True
        except (OSError, subprocess.TimeoutExpired):
            break
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        stale = not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH)
        )
        if stale and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.huffc_hist.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_int, _u64p]
    lib.huffc_hist.restype = None
    lib.huffc_encode.argtypes = [
        _u8p, ctypes.c_uint64, _u8p, _u64p,
        _u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.huffc_encode.restype = ctypes.c_int64
    lib.huffc_build_dfa.argtypes = [
        _i32p, _i32p, _i32p, ctypes.c_int32, ctypes.c_int32,
        _i16p, _u8p, _u8p, _u8p, _i16p,
    ]
    lib.huffc_build_dfa.restype = ctypes.c_int32
    lib.huffc_decode.argtypes = [
        _u8p, ctypes.c_uint64, ctypes.c_uint64,
        _i16p, _u8p, _u8p, _u8p, _i32p, _i32p, _i32p, _i16p, _i32p,
        ctypes.c_int32, _u8p, ctypes.c_uint64, _u64p,
    ]
    lib.huffc_decode.restype = ctypes.c_int64
    lib.huffc_decode_blocks.argtypes = [
        _u8p, _u64p, _u64p, ctypes.c_int64,
        _i16p, _u8p, _u8p, _u8p, _i32p, _i32p, _i32p, _i16p, _i32p,
        ctypes.c_int32, _u8p, _u64p, _u64p, _u64p, ctypes.c_int,
    ]
    lib.huffc_decode_blocks.restype = ctypes.c_int64
    lib.huffc_or_copy.argtypes = [_u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64]
    lib.huffc_or_copy.restype = None
    lib.huffc_extract_rows.argtypes = [
        _u32p, ctypes.c_uint64, _u64p, ctypes.c_int64, ctypes.c_int64,
        _u32p, ctypes.c_int,
    ]
    lib.huffc_extract_rows.restype = None
    lib.huffc_index_blocks.argtypes = [
        _u8p, ctypes.c_uint64, ctypes.c_uint64,
        _i16p, _u8p, _u8p, _i32p, _i32p, _i16p, _i32p, ctypes.c_int32,
        ctypes.c_uint64, _u64p, ctypes.c_int64, _u64p, _u64p,
    ]
    lib.huffc_index_blocks.restype = ctypes.c_int64
    lib.huffc_stitch_blocks.argtypes = [
        _u8p, ctypes.c_uint64, _u64p, ctypes.c_int64,
        _u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.huffc_stitch_blocks.restype = ctypes.c_int64
    lib.huffc_encode_blocks.argtypes = [
        _u8p, ctypes.c_uint64, ctypes.c_uint64, _u8p, _u64p,
        _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,
    ]
    lib.huffc_encode_blocks.restype = ctypes.c_int64
    lib.huffc_decode_index.argtypes = [
        _u8p, ctypes.c_uint64, ctypes.c_uint64,
        _i16p, _u8p, _u8p, _u8p, _i32p, _i32p, _i32p, _i16p, _i32p,
        ctypes.c_int32, _u8p, ctypes.c_uint64, _u64p,
        ctypes.c_uint64, _u64p, ctypes.c_int64, _u64p, _i64p,
    ]
    lib.huffc_decode_index.restype = ctypes.c_int64
    lib.huffc_crc32.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint32]
    lib.huffc_crc32.restype = ctypes.c_uint32
    lib.huffc_crc32_blocks.argtypes = [
        _u8p, ctypes.c_uint64, ctypes.c_uint64, _u32p, ctypes.c_int,
    ]
    lib.huffc_crc32_blocks.restype = None
    lib.huffc_spec_index.argtypes = [
        _u8p, ctypes.c_uint64, ctypes.c_uint64,
        _i16p, _u8p, _u8p, _i32p, _i32p, _i16p, _i32p, ctypes.c_int32,
        ctypes.c_uint64, _u64p, ctypes.c_int64, _u64p, _u64p,
        ctypes.c_int,
    ]
    lib.huffc_spec_index.restype = ctypes.c_int64


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# high-level wrappers
# ---------------------------------------------------------------------------
def hist(data: np.ndarray, threads: int | None = None) -> np.ndarray:
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.zeros(256, dtype=np.uint64)
    lib.huffc_hist(data, data.size, threads or num_threads(), out)
    return out.astype(np.int64)


def encode(
    data: np.ndarray,
    lens_lut: np.ndarray,
    codes_lut: np.ndarray,
    threads: int | None = None,
) -> Tuple[bytes, int]:
    """Pack to an MSB-first bitstream; returns (payload, padding_bits)."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lens_lut = np.ascontiguousarray(lens_lut, dtype=np.uint8)
    codes_lut = np.ascontiguousarray(codes_lut, dtype=np.uint64)
    max_len = int(lens_lut.max()) if lens_lut.size else 0
    cap = (data.size * max(max_len, 1) + 7) // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    r = int(lib.huffc_encode(data, data.size, lens_lut, codes_lut, out, cap, 0,
                             threads or num_threads()))
    if r == -2:
        from ..core.format import CompressError
        raise CompressError("letter not found in codes", None)
    if r < 0:
        raise RuntimeError(f"huffc_encode failed: {r}")
    nbytes = (r + 7) // 8
    return out[:nbytes].tobytes(), (8 - r % 8) % 8


def encode_blocks_host(
    data: np.ndarray,
    block_len: int,
    lens_lut: np.ndarray,
    codes_lut: np.ndarray,
    threads: int | None = None,
) -> Tuple[bytes, int, np.ndarray]:
    """Threaded independent-block encode + bit-carry stitch in ONE call.

    The whole-chunk form of the ``.hf2`` writer's block loop: returns
    ``(payload, total_bits, bit_lens)`` where ``bit_lens[k]`` is block k's
    exact bit count (the container's block-table entries).  One FFI call
    per streaming chunk — the per-block python loop spent as long in call
    overhead as in the encoder itself (r3 profile).
    """
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    lens_lut = np.ascontiguousarray(lens_lut, dtype=np.uint8)
    codes_lut = np.ascontiguousarray(codes_lut, dtype=np.uint64)
    # empty chunk -> empty block table (the C++ side computes nb = 0 and
    # writes nothing; a spurious [0] entry here would desync the `.hf2`
    # table semantics between backends — ADVICE r3)
    if data.size == 0:
        return b"", 0, np.zeros(0, dtype=np.uint64)
    nb = -(-data.size // block_len)
    max_len = int(lens_lut.max()) if lens_lut.size else 1
    cap = (data.size * max(max_len, 1) + 7) // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    bit_lens = np.zeros(nb, dtype=np.uint64)
    r = int(lib.huffc_encode_blocks(
        data, data.size, block_len, lens_lut, codes_lut, out, cap,
        bit_lens, threads or num_threads()))
    if r == -2:
        from ..core.format import CompressError

        raise CompressError("letter not found in codes", None)
    if r < 0:
        raise RuntimeError(f"huffc_encode_blocks failed: {r}")
    return out[: (r + 7) // 8].tobytes(), r, bit_lens


class DfaTables:
    """Byte-driven DFA decode tables for a tree (native layout)."""

    __slots__ = (
        "next_state", "emit_count", "emit_syms", "last_emit_bit",
        "state_of_node", "node_of_state", "left", "right", "letter", "root",
        "num_states",
    )

    def __init__(self, tree) -> None:
        lib = _load()
        assert lib is not None
        left, right, letter = tree.node_arrays()
        self.left = np.ascontiguousarray(left, dtype=np.int32)
        self.right = np.ascontiguousarray(right, dtype=np.int32)
        self.letter = np.ascontiguousarray(letter, dtype=np.int32)
        self.root = int(tree.root)
        n = self.left.size
        n_internal = int(np.count_nonzero(self.left >= 0))
        S = max(n_internal, 1)
        self.next_state = np.zeros((S, 256), dtype=np.int16)
        self.emit_count = np.zeros((S, 256), dtype=np.uint8)
        self.emit_syms = np.zeros((S, 256, 8), dtype=np.uint8)
        self.last_emit_bit = np.zeros((S, 256), dtype=np.uint8)
        self.state_of_node = np.zeros(n, dtype=np.int16)
        self.num_states = int(
            lib.huffc_build_dfa(
                self.left, self.right, self.letter, n, self.root,
                self.next_state.reshape(-1), self.emit_count.reshape(-1),
                self.emit_syms.reshape(-1), self.last_emit_bit.reshape(-1),
                self.state_of_node,
            )
        )
        self.node_of_state = np.zeros(max(self.num_states, 1), dtype=np.int32)
        for node, s in enumerate(self.state_of_node):
            if s >= 0:
                self.node_of_state[s] = node


def decode(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    out_cap: int,
) -> bytes:
    out, _ = decode_resume(comp, start_bit, end_bit, tables, out_cap)
    return out


def decode_resume(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    out_cap: int,
) -> Tuple[bytes, int]:
    """Decode a bit range; also return the bit offset just past the LAST
    complete code (for chunked streaming, where a code may straddle the
    chunk boundary — the reference keeps walker state across blocks,
    huff/src/comp.rs:240; we instead re-read the tail bits)."""
    lib = _load()
    assert lib is not None
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    out = np.empty(out_cap, dtype=np.uint8)
    resume = np.zeros(1, dtype=np.uint64)
    r = int(
        lib.huffc_decode(
            comp, start_bit, end_bit,
            tables.next_state.reshape(-1), tables.emit_count.reshape(-1),
            tables.emit_syms.reshape(-1), tables.last_emit_bit.reshape(-1),
            tables.left, tables.right, tables.letter, tables.state_of_node,
            tables.node_of_state, tables.root, out, out_cap, resume,
        )
    )
    if r < 0:
        raise RuntimeError(f"huffc_decode failed: {r}")
    return out[:r].tobytes(), int(resume[0])


def decode_blocks(
    comp: np.ndarray,
    start_bits: np.ndarray,
    end_bits: np.ndarray,
    tables: DfaTables,
    out_offsets: np.ndarray,
    out_caps: np.ndarray,
    threads: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode independent bit ranges in parallel.

    Returns ``(out_buffer, out_lens)`` where block ``k``'s letters are at
    ``out_buffer[out_offsets[k] : out_offsets[k] + out_lens[k]]``.
    """
    lib = _load()
    assert lib is not None
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    start_bits = np.ascontiguousarray(start_bits, dtype=np.uint64)
    end_bits = np.ascontiguousarray(end_bits, dtype=np.uint64)
    out_offsets = np.ascontiguousarray(out_offsets, dtype=np.uint64)
    out_caps = np.ascontiguousarray(out_caps, dtype=np.uint64)
    total = int(out_offsets[-1] + out_caps[-1]) if out_caps.size else 0
    out = np.empty(total, dtype=np.uint8)
    out_lens = np.zeros(start_bits.size, dtype=np.uint64)
    r = int(
        lib.huffc_decode_blocks(
            comp, start_bits, end_bits, start_bits.size,
            tables.next_state.reshape(-1), tables.emit_count.reshape(-1),
            tables.emit_syms.reshape(-1), tables.last_emit_bit.reshape(-1),
            tables.left, tables.right, tables.letter, tables.state_of_node,
            tables.node_of_state, tables.root, out, out_offsets, out_caps,
            out_lens, threads or num_threads(),
        )
    )
    if r != 0:
        raise RuntimeError(f"huffc_decode_blocks failed on block {-r - 1}")
    return out, out_lens


def decode_index(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    out_cap: int, block_len: int, in_block: int = 0,
) -> Tuple[bytes, np.ndarray, int, int]:
    """Decode a bit range AND record block boundaries in one DFA pass.

    The fused form of :func:`decode_resume` + :func:`index_blocks` — the
    foreign-``.hff`` first decode emits its output and builds the block
    index sidecar from a single payload walk (VERDICT r4 #5: previously an
    index pass, a copy pass, and a decode pass).  Returns ``(out,
    boundaries, resume_bit, in_block)``; resumable across windows like
    :func:`decode_resume`."""
    lib = _load()
    assert lib is not None
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    out = np.empty(out_cap, dtype=np.uint8)
    cap_b = int(end_bit - start_bit) // max(int(block_len), 1) + 2
    bounds = np.zeros(cap_b, dtype=np.uint64)
    state = np.asarray([in_block], dtype=np.uint64)
    resume = np.zeros(1, dtype=np.uint64)
    nb = np.zeros(1, dtype=np.int64)
    r = int(
        lib.huffc_decode_index(
            comp, start_bit, end_bit,
            tables.next_state.reshape(-1), tables.emit_count.reshape(-1),
            tables.emit_syms.reshape(-1), tables.last_emit_bit.reshape(-1),
            tables.left, tables.right, tables.letter, tables.state_of_node,
            tables.node_of_state, tables.root, out, out_cap, resume,
            block_len, bounds, cap_b, state, nb,
        )
    )
    if r < 0:
        raise RuntimeError(f"huffc_decode_index failed: {r}")
    return (out[:r].tobytes(), bounds[: int(nb[0])].copy(), int(resume[0]),
            int(state[0]))


def crc32(data, seed: int = 0) -> int:
    """zlib-compatible CRC32 (one call, threaded callers use crc32_blocks)."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8)
                                if isinstance(data, (bytes, bytearray,
                                                     memoryview))
                                else data, dtype=np.uint8)
    return int(lib.huffc_crc32(data, data.size, seed & 0xFFFFFFFF))


def crc32_blocks(data: np.ndarray, span: int,
                 threads: int | None = None) -> np.ndarray:
    """Per-span zlib CRC32s of a contiguous buffer, threaded over spans.

    ``out[k] = crc32(data[k*span : (k+1)*span])`` (last span may be short).
    The ``.hf2`` integrity column is these CRCs over the ORIGINAL bytes."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    ns = -(-data.size // max(span, 1)) if data.size else 0
    out = np.zeros(ns, dtype=np.uint32)
    if ns:
        lib.huffc_crc32_blocks(data, data.size, span, out,
                               threads or num_threads())
    return out


def build_dfa(tree) -> DfaTables:
    return DfaTables(tree)


def index_blocks(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    block_len: int, in_block: int = 0,
) -> Tuple[np.ndarray, int, int]:
    """Walk a bit range without emitting; returns ``(boundaries, resume_bit,
    in_block)`` where ``boundaries`` holds the bit offset after every
    ``block_len``-th letter.  Resumable across windows like
    :func:`decode_resume` (re-feed from ``resume_bit`` with the returned
    ``in_block``).  Powers the .hff -> .hf2 transcoder."""
    lib = _load()
    assert lib is not None
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    # every letter is >= 1 bit, so at most (bits // block_len) + 1 boundaries
    cap = int(end_bit - start_bit) // max(int(block_len), 1) + 2
    bounds = np.zeros(cap, dtype=np.uint64)
    state = np.asarray([in_block], dtype=np.uint64)
    resume = np.zeros(1, dtype=np.uint64)
    nb = int(
        lib.huffc_index_blocks(
            comp, start_bit, end_bit,
            tables.next_state.reshape(-1), tables.emit_count.reshape(-1),
            tables.last_emit_bit.reshape(-1), tables.left, tables.right,
            tables.state_of_node, tables.node_of_state, tables.root,
            block_len, bounds, cap, state, resume,
        )
    )
    if nb < 0:
        raise RuntimeError("huffc_index_blocks: boundary buffer overflow")
    return bounds[:nb].copy(), int(resume[0]), int(state[0])


def spec_index(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    block_len: int, in_block: int = 0, threads: int | None = None,
) -> Tuple[np.ndarray, int, int]:
    """PARALLEL block indexer via DFA self-synchronization (r5, the
    SURVEY §7 "speculative chunk-resync" design).

    Same contract as :func:`index_blocks` — ``(boundaries, resume_bit,
    in_block)``, resumable across windows — but T threads parse
    byte-aligned chunks speculatively from the root state and a cheap
    serial seam reconciliation splices the true parse together; a seam
    that fails to coalesce (adversarial tree) degrades to a serial walk
    of that one chunk.  Falls back to :func:`index_blocks` outright for
    degenerate trees or regions too small to split."""
    lib = _load()
    assert lib is not None
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    cap = int(end_bit - start_bit) // max(int(block_len), 1) + 2
    bounds = np.zeros(cap, dtype=np.uint64)
    state = np.asarray([in_block], dtype=np.uint64)
    resume = np.zeros(1, dtype=np.uint64)
    nb = int(
        lib.huffc_spec_index(
            comp, start_bit, end_bit,
            tables.next_state.reshape(-1), tables.emit_count.reshape(-1),
            tables.last_emit_bit.reshape(-1), tables.left, tables.right,
            tables.state_of_node, tables.node_of_state, tables.root,
            block_len, bounds, cap, state, resume,
            threads or num_threads(),
        )
    )
    if nb == -3:
        return index_blocks(comp, start_bit, end_bit, tables, block_len,
                            in_block)
    if nb < 0:
        raise RuntimeError(f"huffc_spec_index failed: {nb}")
    return bounds[:nb].copy(), int(resume[0]), int(state[0])


def extract_rows(
    words: np.ndarray, starts_w: np.ndarray, row_words: int,
    threads: int | None = None,
) -> np.ndarray:
    """Threaded per-block row gather: out[k] = words[starts_w[k]:+row_words]
    (zero-filled past the end).  Feeds the device decoders' (B, W) layout."""
    lib = _load()
    assert lib is not None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    starts_w = np.ascontiguousarray(starts_w, dtype=np.uint64)
    out = np.empty((starts_w.size, row_words), dtype=np.uint32)
    lib.huffc_extract_rows(words, words.size, starts_w, starts_w.size,
                           row_words, out.reshape(-1),
                           threads or num_threads())
    return out


def stitch_blocks(
    rows: np.ndarray, bit_lens: np.ndarray, threads: int | None = None
) -> Tuple[bytes, int]:
    """Bit-carry concat of block bitstreams (rows (B, row_bytes) uint8,
    MSB-first).  Returns ``(payload, padding_bits)``."""
    lib = _load()
    assert lib is not None
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    bit_lens = np.ascontiguousarray(bit_lens, dtype=np.uint64)
    total = int(bit_lens.sum())
    cap = total // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    r = int(
        lib.huffc_stitch_blocks(
            rows.reshape(-1), rows.shape[1] if rows.ndim == 2 else rows.size,
            bit_lens, bit_lens.size, out, cap, 0, threads or num_threads(),
        )
    )
    if r < 0:
        raise RuntimeError("huffc_stitch_blocks overflow")
    nbytes = (total + 7) // 8
    return out[:nbytes].tobytes(), (8 - total % 8) % 8
