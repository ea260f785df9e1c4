"""Streaming file compress/decompress (bounded memory, ``.hff`` + ``.hf2``).

Capability match for L4 of the reference (`/root/reference/huff/src/comp.rs`):

* :func:`read_compress_write` — the two-pass scheme (`comp.rs:32-74`):
  pass 1 streams the file into a histogram and builds ONE whole-file tree
  (`comp.rs:46,161-172`); pass 2 re-reads, packs each block, and stitches
  blocks at the bit level.  Unlike the reference's seek-back stitch — whose
  carry shift is wrong for padding ∉ {0,4} (`comp.rs:199`, SURVEY §2
  quirk) — the carry here is exact for every block size, while remaining
  byte-identical to the reference wherever the reference itself is correct
  (single-block files, i.e. any file < block_size).
* :func:`read_decompress_write` — streamed decode (`comp.rs:79-157`) with
  code-straddling chunk boundaries handled by resume offsets (the analogue
  of the reference's persistent walker state, `comp.rs:240`).
* :func:`read_compress_write_hf2` / :func:`read_decompress_write_hf2` —
  the block-indexed container: same tree + payload, plus per-block bit
  offsets enabling parallel (threaded / device) decode.

Encode backend: C++ native when available, numpy otherwise; ``device=True``
routes block packing through the JAX kernels.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Optional

import numpy as np

from ..core.bits import calc_padding_bits
from ..core.codec import pack_codes_u8
from ..core.format import CompressError
from ..core.tree import HuffTree
from ..core.weights import ByteWeights
from .hff import (
    default_crc_every,
    hf2_table_width,
    read_hf2_header,
    write_hf2_crc_slice,
    write_hf2_prelude,
    write_hf2_table_slice,
)

__all__ = [
    "read_compress_write",
    "read_decompress_write",
    "read_compress_write_hf2",
    "read_decompress_write_hf2",
    "transcode_hff_to_hf2",
    "decode_hff_indexed",
    "huff_tree_from_stream",
    "StreamError",
]

DEFAULT_BLOCK = 2_000_000_000  # reference default block-size "2G" (cli.yml:31)
_CHUNK = 64 << 20  # streaming granularity independent of the logical block


class StreamError(ValueError):
    """Header/stream errors (reference `huff/src/error.rs:9-26` kinds)."""

    def __init__(self, message: str, kind: str = "Io"):
        super().__init__(message)
        self.kind = kind


def _native():
    try:
        from .. import native

        return native if native.available() else None
    except Exception:
        return None


def _now() -> float:
    import time

    return time.perf_counter()


def _record_call(stats: dict | None, dt: float) -> None:
    """Append one device-call wall time for compile/steady-state separation."""
    if stats is not None:
        stats.setdefault("device_call_s", []).append(dt)


def _weights_from_stream(fp: BinaryIO, size: int, block_size: int,
                         hist_sample: int = 1) -> ByteWeights:
    bw = ByteWeights()
    samp = max(1, int(hist_sample))
    left = size
    step = min(block_size, _CHUNK)
    while left > 0:
        chunk = fp.read(min(step, left))
        if not chunk:
            break
        piece = (chunk if samp == 1
                 else chunk[: max(1, len(chunk) // samp)])
        bw += ByteWeights.from_bytes(piece)
        left -= len(chunk)
    if samp > 1 and size > 0:
        bw = ByteWeights(bw.counts + 1)
    return bw


def huff_tree_from_stream(fp: BinaryIO, size: int, block_size: int,
                          hist_sample: int = 1) -> HuffTree:
    """Pass 1: histogram the whole stream, build the file tree
    (`huff/src/comp.rs:161-172`).

    ``hist_sample > 1``: count only each chunk's first ``1/hist_sample``
    bytes and Laplace-smooth (+1 every bin) — the complete alphabet keeps
    the encode pass exact while pass 1 shrinks ~hist_sample x (the same
    fast mode as :func:`read_compress_write_hf2`)."""
    return HuffTree.from_weights(
        _weights_from_stream(fp, size, block_size, hist_sample))


def _encode_chunk(data: np.ndarray, lens_lut, codes_lut, nat) -> tuple[bytes, int]:
    """Pack one chunk; returns (payload, total_bits)."""
    if nat is not None:
        payload, pad = nat.encode(data, lens_lut, codes_lut)
    else:
        payload, pad = pack_codes_u8(data, lens_lut, codes_lut)
    return payload, len(payload) * 8 - pad


def _crc_spans(data: np.ndarray, span: int, nat) -> np.ndarray:
    """Per-span zlib CRC32s of ``data`` (threaded C++ when available)."""
    if nat is not None:
        return nat.crc32_blocks(data, span)
    import zlib

    ns = -(-data.size // span) if data.size else 0
    out = np.zeros(ns, dtype=np.uint32)
    mv = memoryview(np.ascontiguousarray(data))
    for k in range(ns):
        out[k] = zlib.crc32(mv[k * span : (k + 1) * span]) & 0xFFFFFFFF
    return out


class _CrcVerifier:
    """Streaming verifier of the ``.hf2`` integrity column.

    Fed the decoded output IN FILE ORDER (any piece sizes); compares each
    completed span's CRC against the stored column and raises a typed
    :class:`StreamError` on the first mismatch — the detection the
    reference format lacks (`comp.rs:487-519` walks corrupt bits into
    silently-wrong output).  Span-aligned bulk regions go through the
    threaded native CRC; ragged edges chain through ``zlib.crc32``.
    """

    def __init__(self, crcs: np.ndarray, span_bytes: int, nat, path: str):
        self.crcs = np.asarray(crcs, dtype=np.uint32)
        self.span = int(span_bytes)
        self.nat = nat
        self.path = path
        self.idx = 0      # next span to complete
        self.run = 0      # running CRC of the current partial span
        self.in_span = 0  # bytes fed into the current span

    def _fail(self, k: int) -> None:
        raise StreamError(
            f"{self.path!r} block CRC mismatch in span {k} "
            f"(corrupt payload or index)", "CorruptData",
        )

    def feed(self, piece) -> None:
        import zlib

        arr = np.frombuffer(piece, dtype=np.uint8) if isinstance(
            piece, (bytes, bytearray, memoryview)) else np.asarray(
            piece, dtype=np.uint8).reshape(-1)
        pos, n = 0, arr.size
        while pos < n:
            if self.in_span == 0 and n - pos >= self.span:
                k = (n - pos) // self.span
                got = _crc_spans(arr[pos : pos + k * self.span], self.span,
                                 self.nat)
                want = self.crcs[self.idx : self.idx + k]
                if want.size < k:
                    self._fail(self.idx + want.size)
                if not np.array_equal(got, want):
                    self._fail(self.idx + int(np.argmax(got != want)))
                self.idx += k
                pos += k * self.span
                continue
            take = min(self.span - self.in_span, n - pos)
            chunk = np.ascontiguousarray(arr[pos : pos + take])
            self.run = (zlib.crc32(chunk, self.run) if self.in_span
                        else zlib.crc32(chunk)) & 0xFFFFFFFF
            self.in_span += take
            pos += take
            if self.in_span == self.span:
                if (self.idx >= self.crcs.size
                        or self.run != int(self.crcs[self.idx])):
                    self._fail(self.idx)
                self.idx += 1
                self.run = 0
                self.in_span = 0

    def finish(self) -> None:
        if self.in_span:
            if (self.idx >= self.crcs.size
                    or self.run != int(self.crcs[self.idx])):
                self._fail(self.idx)
            self.idx += 1
            self.run = 0
            self.in_span = 0


def _gf2_matrix_times(mat, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(square, mat) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """``crc32(A || B)`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)``
    (zlib's crc32_combine, GF(2) matrix exponentiation).

    Lets distributed writers CRC a span whose bytes live on several hosts:
    each host CRCs its local piece, the coordinator combines in order —
    O(32^2 log len) per combine, no byte ever crosses the network for it
    (the config-5 multihost ``.hf2`` integrity column)."""
    if len2 <= 0:
        return crc1
    even = [0] * 32
    odd = [0] * 32
    odd[0] = 0xEDB88320  # the CRC-32 polynomial, bit-reflected
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    _gf2_matrix_square(even, odd)   # even = x^2
    _gf2_matrix_square(odd, even)   # odd = x^4
    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def crc_span_pieces(data: np.ndarray, global_off: int, span: int,
                    nat=None) -> list:
    """Split ``data`` (living at ``global_off`` in the logical stream) at
    global ``span`` boundaries and CRC each piece: ``[(crc, nbytes), ...]``.
    A distributed writer gathers these and folds them into whole-span CRCs
    with :func:`crc32_combine`."""
    import zlib

    if nat is None:
        nat = _native()
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    pieces = []
    pos, n = 0, data.size
    while pos < n:
        take = min(span - ((global_off + pos) % span), n - pos)
        if take == span and n - pos >= span:
            # bulk run of aligned whole spans: one threaded native call
            k = (n - pos) // span
            for c in _crc_spans(data[pos : pos + k * span], span, nat):
                pieces.append((int(c), span))
            pos += k * span
            continue
        piece = data[pos : pos + take]
        c = (nat.crc32(piece) if nat is not None
             else zlib.crc32(piece) & 0xFFFFFFFF)
        pieces.append((int(c), take))
        pos += take
    return pieces


class _CrcCollector:
    """Streaming producer of the ``.hf2`` CRC column: feed decoded bytes in
    order, collect one CRC32 per ``span_bytes`` (the write-side twin of
    :class:`_CrcVerifier`, same bulk-native/ragged-zlib split)."""

    def __init__(self, span_bytes: int, nat):
        self.span = int(span_bytes)
        self.nat = nat
        self.crcs: list = []
        self.run = 0
        self.in_span = 0

    def feed(self, piece) -> None:
        import zlib

        arr = np.frombuffer(piece, dtype=np.uint8) if isinstance(
            piece, (bytes, bytearray, memoryview)) else np.asarray(
            piece, dtype=np.uint8).reshape(-1)
        pos, n = 0, arr.size
        while pos < n:
            if self.in_span == 0 and n - pos >= self.span:
                k = (n - pos) // self.span
                self.crcs.extend(
                    _crc_spans(arr[pos : pos + k * self.span], self.span,
                               self.nat).tolist())
                pos += k * self.span
                continue
            take = min(self.span - self.in_span, n - pos)
            chunk = np.ascontiguousarray(arr[pos : pos + take])
            self.run = (zlib.crc32(chunk, self.run) if self.in_span
                        else zlib.crc32(chunk)) & 0xFFFFFFFF
            self.in_span += take
            pos += take
            if self.in_span == self.span:
                self.crcs.append(self.run)
                self.run = 0
                self.in_span = 0

    def finish(self) -> np.ndarray:
        if self.in_span:
            self.crcs.append(self.run)
            self.run = 0
            self.in_span = 0
        return np.asarray(self.crcs, dtype=np.uint32)


class _BitSink:
    """Write a bitstream to a file through byte-aligned chunks, carrying the
    partial byte between writes (the correct version of the reference's
    seek-back-and-OR, `huff/src/comp.rs:196-201`)."""

    def __init__(self, fp: BinaryIO):
        self.fp = fp
        self.partial = 0  # current partial byte value (high bits occupied)
        self.partial_bits = 0
        self.total_bits = 0

    def write(self, payload: bytes, nbits: int) -> None:
        if nbits == 0:
            return
        self.total_bits += nbits
        if self.partial_bits == 0:
            full, rem = divmod(nbits, 8)
            self.fp.write(payload[:full])
            if rem:
                self.partial = payload[full]
                self.partial_bits = rem
            return
        # shift payload right by partial_bits and OR into the partial byte
        arr = np.frombuffer(payload, dtype=np.uint8)
        s = self.partial_bits
        shifted = (arr >> s).astype(np.uint8)
        shifted |= np.concatenate(
            [np.uint8([self.partial]), (arr[:-1] << (8 - s)).astype(np.uint8)]
        )
        carry = int(arr[-1] << (8 - s)) & 0xFF
        total = s + nbits
        full, rem = divmod(total, 8)
        stream = shifted.tobytes() + bytes([carry])
        self.fp.write(stream[:full])
        self.partial = stream[full] if rem else 0
        self.partial_bits = rem

    def flush(self) -> int:
        """Write the final partial byte; returns data padding bits."""
        if self.partial_bits:
            self.fp.write(bytes([self.partial]))
        pad = calc_padding_bits(self.total_bits)
        self.partial = 0
        self.partial_bits = 0
        return pad


def read_compress_write(
    src_path: str, dst_path: str, block_size: int = DEFAULT_BLOCK,
    device: bool = False, timer=None, stats: dict | None = None,
    hist_sample: int = 1, tree: HuffTree | None = None,
    max_code_len: int | None = None,
) -> None:
    """Compress ``src`` into ``dst`` as ``.hff`` (`huff/src/comp.rs:32-74`).

    ``stats``: optional dict; device runs append each device-call wall time
    to ``stats["device_call_s"]`` so callers (CLI ``--stats``) can separate
    one-time JIT compile cost from steady-state throughput.

    ``tree`` (r5, config 4): a pre-built shared tree skips pass 1 entirely
    — single-pass compress; the tree must cover every byte of the file
    (see :func:`read_compress_write_hf2`).  ``max_code_len``: optional
    package-merge length limit (speed/ratio knob; with ``device`` the
    device's 32-bit codeword cap applies automatically on pathological
    deep trees, matching the ``.hf2`` writer — the container stays a
    valid ``.hff``).
    """
    from ..profiling import StageTimer

    timer = timer if timer is not None else StageTimer()
    size = os.path.getsize(src_path)
    nat = _native()
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        if tree is None:
            with timer.stage("histogram", size):
                bw = _weights_from_stream(src, size, block_size,
                                          hist_sample)
            cap = max_code_len if max_code_len is not None else (
                32 if device else None)
            if cap is not None:
                from ..core.canonical import build_tree_for_device

                tree, _limited = build_tree_for_device(
                    bw, max_len=min(cap, 32) if device else cap)
            else:
                tree = HuffTree.from_weights(bw)
        tree_bin = tree.as_bin()
        tree_padding = calc_padding_bits(len(tree_bin))
        tree_bytes = tree_bin.to_bytes()
        src.seek(0)
        # header: placeholder padding byte, tree length, tree (comp.rs:54-59)
        dst.write(b"\x00")
        dst.write(len(tree_bytes).to_bytes(4, "big"))
        dst.write(tree_bytes)
        lens_lut, codes_lut = tree.encode_tables()
        enc = _device_encoder(tree) if device else None
        sink = _BitSink(dst)
        left = size
        step = min(block_size, _CHUNK)
        if enc is None:
            # host pipeline (r5, same shape as the .hf2 writer): chunk k
            # encodes on a worker (threaded C++ releases the GIL) while
            # the main thread writes k-1 and reads k+1
            import concurrent.futures as _cf

            with _cf.ThreadPoolExecutor(max_workers=1) as ex:
                pending = None
                while True:
                    fut = None
                    if left > 0:
                        chunk = src.read(min(step, left))
                        if chunk:
                            left -= len(chunk)
                            fut = ex.submit(
                                _encode_chunk,
                                np.frombuffer(chunk, dtype=np.uint8),
                                lens_lut, codes_lut, nat)
                        else:
                            left = 0
                    if pending is not None:
                        payload, nbits = pending.result()
                        with timer.stage("write", (nbits + 7) // 8):
                            sink.write(payload, nbits)
                    pending = fut
                    if pending is None and left <= 0:
                        break
        else:
            while left > 0:
                chunk = src.read(min(step, left))
                if not chunk:
                    break
                data = np.frombuffer(chunk, dtype=np.uint8)
                with timer.stage("pack", len(chunk)):
                    # multi-chunk streams pad the ragged tail to the full
                    # chunk shape so it reuses the body's compile
                    t0 = _now()
                    payload, nbits = enc(
                        data, pad_to_bytes=step if size > step else None)
                    _record_call(stats, _now() - t0)
                with timer.stage("write", (nbits + 7) // 8):
                    sink.write(payload, nbits)
                left -= len(chunk)
        data_padding = sink.flush()
        # patch the padding byte (comp.rs:69-70)
        dst.seek(0)
        dst.write(bytes([(tree_padding << 4) | data_padding]))


def _device_encoder(tree: HuffTree):
    """Chunk encoder routed through the JAX device pipeline.

    When the tree's codes happen to be canonical (any canonicalized tree)
    the canonical ladder tables are passed through, which selects the
    faster lookup (:func:`tpuhuff.kernels.encode.encode_blocks`).
    Kernel lanes are ``DEVICE_HF2_BLOCK`` bytes, the shape measured on the
    card (PERF.md); the stitched ``.hff`` stream does not depend on it."""
    from ..dist import stitch_words
    from ..dist.block import pad_to_blocks
    from ..kernels.encode import (
        encode_blocks, make_canonical_encode_tables, make_encode_tables,
    )

    import jax.numpy as jnp

    lens_t, codes_t = tree.encode_tables()
    dl, da = make_encode_tables(lens_t, codes_t)
    ml = int(lens_t.max())
    tabs = make_canonical_encode_tables(tree)
    canon_tabs = tabs[:4] if tabs is not None else None
    full_alpha = bool(tabs[5]) if tabs is not None else False

    block_len = DEVICE_HF2_BLOCK

    def encode(data: np.ndarray, pad_to_bytes: int | None = None
               ) -> tuple[bytes, int]:
        blocks, valid, _ = pad_to_blocks(data, block_len, 1)
        pad_rows = (-(-pad_to_bytes // block_len)
                    if pad_to_bytes is not None else None)
        if pad_rows is not None and blocks.shape[0] < pad_rows:
            # fixed row count across chunks: the ragged tail chunk reuses
            # the full-chunk compile (valid=0 rows emit nothing)
            extra = pad_rows - blocks.shape[0]
            blocks = np.concatenate(
                [blocks, np.zeros((extra, block_len), np.uint8)], axis=0)
            valid = np.concatenate([valid, np.zeros(extra, np.int32)])
        jblocks, jvalid = jnp.asarray(blocks), jnp.asarray(valid)
        # missing-letter guard (`comp.rs:427-432`): possible only if the
        # file changed between the histogram pass and this one — the device
        # kernels would otherwise drop the byte's bits silently.  It rides
        # the encode program.
        words, bits, miss = encode_blocks(jblocks, dl, da, jvalid,
                                          max_code_len=ml,
                                          canon_tables=canon_tabs,
                                          full_alphabet=full_alpha,
                                          with_miss=True)
        if int(miss):
            raise CompressError("letter not found in codes", None)
        payload, pad = stitch_words(np.asarray(words), np.asarray(bits))
        return payload, len(payload) * 8 - pad

    return encode


def _read_hff_header(src: BinaryIO, src_path: str):
    """Parse padding byte, tree length, tree (`huff/src/comp.rs:92-145`)."""
    head = src.read(5)
    if len(head) < 5:
        raise StreamError(
            f"{src_path!r} too short to decompress, missing header information",
            "MissingHeaderInfo",
        )
    tree_padding = head[0] >> 4
    data_padding = head[0] & 0x0F
    if tree_padding > 7 or data_padding > 7:
        raise StreamError(
            f"{src_path!r} stores invalid header information", "InvalidHeaderInfo"
        )
    tree_len = int.from_bytes(head[1:5], "big")
    tree_bytes = src.read(tree_len)
    if len(tree_bytes) < tree_len:
        raise StreamError(
            f"{src_path!r} too short to decompress, missing header information",
            "MissingHeaderInfo",
        )
    from ..core.bits import BitString
    from ..core.tree import FromBinError

    try:
        tree = HuffTree.try_from_bin(
            BitString.from_bytes(tree_bytes, tree_len * 8 - tree_padding)
        )
    except (FromBinError, ValueError):
        raise StreamError(
            f"{src_path!r} stores invalid header information", "InvalidHeaderInfo"
        ) from None
    return tree, data_padding, 5 + tree_len


# payload size above which a foreign .hff is auto-transcoded to a block
# index sidecar on first decode (one extra DFA pass then, block-parallel
# decode now and on every later decode of the same file)
AUTO_INDEX_MIN = 32 << 20


def _sidecar_matches(src_path: str, sidecar: str) -> bool:
    """Content check that a ``.hf2x`` sidecar was built from THIS source.

    mtime alone is not enough — timestamp-preserving replacement (cp -p,
    rsync -t, tar -x) would silently serve the previous file's contents.
    The sidecar carries the tree + payload verbatim, so compare the tree
    bits, the payload bit count, and 16 stratified 4 KiB payload regions
    (first, last, and 14 evenly spread — seeks, not a full read).

    KNOWN LIMIT: this is sampling, not a proof — a
    same-size same-tree replacement differing ONLY between sampled
    regions would pass.  The failure then stays detectable downstream:
    the sidecar's CRC column was computed from the ORIGINAL decode, so
    decoding the swapped payload against it raises ``CorruptData``
    (unless the decode happens to still be byte-identical, in which case
    serving it is correct anyway).  A full-payload hash here would cost a
    complete extra read of the source on EVERY decode — the sampled check
    plus CRC backstop covers the realistic cases for free.
    """
    try:
        with open(src_path, "rb") as s:
            tree, data_padding, header_len = _read_hff_header(s, src_path)
            plen = os.path.getsize(src_path) - header_len
            total_bits = max(plen * 8 - data_padding, 0)
            with open(sidecar, "rb") as f:
                hdr = read_hf2_header(f)
                if hdr.total_bits != total_bits:
                    return False
                if hdr.tree.as_bin().to_bytes() != tree.as_bin().to_bytes():
                    return False
                offs = {0, max(0, plen - 4096)}
                for k in range(1, 15):
                    offs.add(max(0, (plen * k) // 15 - 2048))
                for off in sorted(offs):
                    s.seek(header_len + off)
                    f.seek(hdr.payload_offset + off)
                    n = min(4096, plen - off)
                    if s.read(n) != f.read(n):
                        return False
        return True
    except (OSError, StreamError, ValueError):
        return False


def read_decompress_write(
    src_path: str, dst_path: str, block_size: int = DEFAULT_BLOCK,
    auto_index: bool | None = None, stats: dict | None = None,
) -> None:
    """Decompress a ``.hff`` file (`huff/src/comp.rs:79-157`), streaming.

    ``auto_index``: a reference-format ``.hff``
    carries no block boundaries, forcing a bit-serial walk.  By default,
    when the native runtime is up and the payload is large
    (>= ``AUTO_INDEX_MIN``), the file is transcoded ONCE into a sidecar
    ``<src>.hf2x`` (identical tree + payload bits plus a block index —
    :func:`transcode_hff_to_hf2`) and decoded block-parallel from it;
    every later decode of the same file reuses the sidecar at full
    parallel speed with no user action (the CLI ``--reindex`` flag is now
    just the explicit form).  ``auto_index=False`` disables; a sidecar
    older than the source is rebuilt.  ``stats["auto_index"]`` records
    what happened ("created"/"reused") for the CLI to report.
    """
    size = os.path.getsize(src_path)
    nat = _native()
    sidecar = src_path + ".hf2x"
    want_auto = (auto_index if auto_index is not None
                 else nat is not None and size >= AUTO_INDEX_MIN)
    if want_auto and nat is None and stats is not None:
        # explicit request without the native runtime: record the
        # degradation instead of silently running bit-serial
        stats["auto_index"] = "unavailable"
    if want_auto and nat is not None:
        try:
            fresh = (os.path.exists(sidecar) and
                     os.path.getmtime(sidecar) >= os.path.getmtime(src_path)
                     and _sidecar_matches(src_path, sidecar))
        except OSError:
            fresh = False
        if fresh:
            try:
                read_decompress_write_hf2(sidecar, dst_path)
                if stats is not None:
                    stats["auto_index"] = "reused"
                return
            except StreamError:
                # a bad SIDECAR (e.g. corrupted by a crashed writer) must
                # not masquerade as a bad source: drop it and rebuild below
                try:
                    os.remove(sidecar)
                except OSError:
                    pass
        # no (usable) sidecar: the r5 fused first decode — ONE DFA pass
        # emits the decoded output, the block index AND the CRC column,
        # then the sidecar is a verbatim payload copy (
        # previously: index pass + copy pass + decode-from-sidecar pass).
        # Unique tmp: concurrent decoders must not interleave writes into
        # one file (a corrupt promoted sidecar would poison later decodes).
        tmp = f"{sidecar}.tmp.{os.getpid()}"
        try:
            try:
                wrote = decode_hff_indexed(src_path, dst_path, tmp)
            except StreamError:
                raise  # malformed SOURCE: same surface as the serial path
            except Exception:
                # native hiccup — fall through to the serial decode below
                # (dst is rewritten from scratch there)
                if stats is not None:
                    stats["auto_index"] = "failed"
            else:
                if wrote:
                    try:
                        os.replace(tmp, sidecar)
                    except OSError:
                        wrote = False
                if stats is not None:
                    stats["auto_index"] = ("created" if wrote
                                           else "nosidecar")
                return  # decoded output is complete with or without sidecar
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        tree, data_padding, header_len = _read_hff_header(src, src_path)
        payload_len = size - header_len
        total_bits = payload_len * 8 - data_padding
        if payload_len <= 0:
            return
        if tree.is_leaf(tree.root):
            # degenerate single-letter stream: one letter per payload bit
            letter = bytes([int(tree.letters[tree.root])])
            left_bits = total_bits
            while left_bits > 0:
                emit = min(left_bits, _CHUNK * 8)
                dst.write(letter * emit)
                src.seek((emit + 7) // 8, 1)
                left_bits -= emit
        elif nat is not None:
            tables = nat.build_dfa(tree)
            step_bytes = min(max(block_size, 1 << 20), _CHUNK)
            pos_bit = 0          # next un-decoded bit (global)
            window = b""
            win_byte = 0         # global byte index of window[0]
            while pos_bit < total_bits:
                # slide the window: drop consumed whole bytes, read ahead
                drop = pos_bit // 8 - win_byte
                if drop > 0:
                    window = window[drop:]
                    win_byte += drop
                want_end_byte = min(
                    win_byte + len(window) + step_bytes, (total_bits + 7) // 8
                )
                need = want_end_byte - (win_byte + len(window))
                if need > 0:
                    window += src.read(need)
                end_bit = min((win_byte + len(window)) * 8, total_bits)
                out, resume = nat.decode_resume(
                    np.frombuffer(window, dtype=np.uint8),
                    pos_bit - win_byte * 8,
                    end_bit - win_byte * 8,
                    tables,
                    end_bit - pos_bit,  # letters <= bits decoded
                )
                dst.write(out)
                if end_bit == total_bits:
                    pos_bit = total_bits  # tail bits are padding-safe: done
                else:
                    new_pos = resume + win_byte * 8
                    if new_pos <= pos_bit:
                        raise StreamError(
                            f"{src_path!r} stores invalid header information",
                            "InvalidHeaderInfo",
                        )
                    pos_bit = new_pos
        else:
            # no native runtime: resumable python DFA, still bounded memory
            from ..core.codec import PyDfaDecoder

            dec = PyDfaDecoder(tree)
            left_bytes = (total_bits + 7) // 8
            while left_bytes > 1:
                chunk = src.read(min(left_bytes - 1, _CHUNK))
                if not chunk:
                    break
                dst.write(dec.feed(chunk))
                left_bytes -= len(chunk)
            last = src.read(1)
            if last:
                dst.write(dec.finish(last[0], data_padding))


# ---------------------------------------------------------------------------
# .hf2 — block-indexed container
# ---------------------------------------------------------------------------
# default .hf2 block lengths (a format choice: the container records it).
# Small blocks give the device decoder many independent lanes; the host
# path favors big blocks (per-block dispatch dominates below ~64 KiB)
DEVICE_HF2_BLOCK = 256
HOST_HF2_BLOCK = 65536


def _encode_block_group(
    data: np.ndarray, block_len: int, lens_lut, codes_lut, nat,
) -> tuple[bytes, int, np.ndarray]:
    """Host-encode a chunk as independent ``block_len`` blocks.

    Returns ``(payload, total_bits, bit_lens)`` — the chunk's block streams
    bit-concatenated plus the per-block bit lengths for the ``.hf2`` table.
    With the native runtime this is ONE threaded C++ call
    (``huffc_encode_blocks``); the python fallback loops blocks.
    """
    if nat is not None:
        payload, total, bit_lens = nat.encode_blocks_host(
            data, block_len, lens_lut, codes_lut)
        return payload, total, bit_lens
    nb = -(-data.size // block_len)
    parts = []
    bit_lens = np.zeros(nb, dtype=np.uint64)
    for b in range(nb):
        blk = data[b * block_len : (b + 1) * block_len]
        p, nbits = _encode_chunk(blk, lens_lut, codes_lut, None)
        parts.append((p, nbits))
        bit_lens[b] = nbits
    value, total = 0, 0
    for p, nbits in parts:
        c = int.from_bytes(p, "big") >> (len(p) * 8 - nbits)
        value = (value << nbits) | c
        total += nbits
    pad = calc_padding_bits(total)
    payload = (value << pad).to_bytes((total + pad) // 8, "big")
    return payload, int(bit_lens.sum()), bit_lens


def _device_block_encoder(tree: HuffTree, block_len: int,
                          collect_hist: bool = False):
    """Device encoder for ``.hf2`` block groups.

    Container blocks are decoupled from kernel lanes: each ``block_len``
    block is encoded as ``block_len // lane`` independent lanes of at most
    ``DEVICE_HF2_BLOCK`` bytes (the encode shape measured on the card), and
    the lane streams are bit-concatenated in order — bit-identical to
    encoding the whole block sequentially, since prefix-code concatenation
    is associative.  Per-block bit lengths are lane sums.

    ``collect_hist`` (config 4): the chunk's exact 256-bin histogram rides
    the encode program (``hist_data``) and ``collect`` returns it as a
    fourth element — the single-pass adaptive tree refresh of
    :func:`tpuhuff.io.dataset.compress_dataset`.
    """
    from ..dist import stitch_words
    from ..dist.block import pad_to_blocks
    from ..kernels.encode import (
        encode_blocks, make_canonical_encode_tables, make_encode_tables,
    )

    import jax.numpy as jnp

    lens_t, codes_t = tree.encode_tables()
    dl, da = make_encode_tables(lens_t, codes_t)
    ml = int(lens_t.max())
    tabs = make_canonical_encode_tables(tree)
    canon_tabs = tabs[:4] if tabs is not None else None
    full_alpha = bool(tabs[5]) if tabs is not None else False
    # largest power-of-two divisor of block_len, capped at the measured shape
    lane = min(block_len & -block_len, DEVICE_HF2_BLOCK)
    L = block_len // lane if block_len % lane == 0 else 1
    if L == 1:
        lane = block_len

    def submit(data: np.ndarray, nb: int):
        """Dispatch one chunk's device encode WITHOUT syncing (JAX dispatch
        is async): H2D + kernel run while the caller stitches/writes the
        previous chunk (double-buffered file path)."""
        lanes, valid, _ = pad_to_blocks(data, lane, 1)
        want = nb * L
        if lanes.shape[0] < want:  # final block's all-padding lanes
            pad_rows = want - lanes.shape[0]
            lanes = np.concatenate(
                [lanes, np.zeros((pad_rows, lane), np.uint8)], axis=0)
            valid = np.concatenate([valid, np.zeros(pad_rows, np.int32)])
        jl, jv = jnp.asarray(lanes), jnp.asarray(valid)
        # the missing-letter guard rides the encode program instead of a
        # separate count_missing dispatch; ditto the adaptive-refresh
        # histogram (hist_data)
        out = encode_blocks(jl, dl, da, jv, max_code_len=ml,
                            canon_tables=canon_tabs,
                            full_alphabet=full_alpha,
                            with_miss=True,
                            hist_data=jl if collect_hist else None)
        words, bits, miss = out[:3]
        hist = out[3] if collect_hist else None
        pad_bytes = int(jl.size) - int(data.size)
        return words, bits, miss, nb, hist, pad_bytes

    def collect(handle):
        """Sync a submitted chunk; host stitch of the device words.

        Returns ``(payload, total_bits, bit_lens)`` — plus the chunk's
        histogram as a fourth element when built with ``collect_hist``."""
        words, bits, miss, nb, hist, pad_bytes = handle
        if int(miss):
            raise CompressError("letter not found in codes", None)
        bits_np = np.asarray(bits).astype(np.uint64)
        payload, pad = stitch_words(np.asarray(words), bits_np)
        bit_lens = bits_np.reshape(nb, L).sum(axis=1)
        if not collect_hist:
            return payload, int(bits_np.sum()), bit_lens
        h = np.asarray(hist).astype(np.int64)
        h[0] -= pad_bytes  # padding rows/lanes counted as byte 0
        return payload, int(bits_np.sum()), bit_lens, h

    def encode(data: np.ndarray, nb: int):
        return collect(submit(data, nb))

    encode.submit = submit
    encode.collect = collect
    return encode


def read_compress_write_hf2(
    src_path: str, dst_path: str, block_len: int | None = None,
    device: bool = False, canonical: bool = True,
    chunk_bytes: int | None = None, stats: dict | None = None,
    hist_sample: int = 1, check: bool = True,
    tree: HuffTree | None = None, collect_hist: bool = False,
    max_code_len: int | None = None,
) -> np.ndarray | None:
    """Compress into the block-indexed ``.hf2`` container — STREAMING.

    Two passes in bounded memory (the ``.hf2`` analogue of the reference's
    block loop, `huff/src/comp.rs:177-227`): pass 1 streams the file into
    the histogram; pass 2 reads ``chunk_bytes`` at a time, encodes the
    chunk's blocks (host C++ or the device kernels), appends the payload
    bits through the carrying :class:`_BitSink`, and patches the block
    table in place (:func:`write_hf2_table_slice`).  Peak RAM is
    O(chunk_bytes), independent of file size.

    ``canonical`` (default): assign canonical codes — same code lengths,
    hence identical compressed size, but the device codec's ladder
    lookups apply (`kernels.decode.make_decode_tables`).  Host and
    device writers canonicalize identically, so their outputs stay
    byte-equal at equal ``block_len``.

    ``hist_sample`` (r4, opt-in fast mode): count only the first
    ``1/hist_sample`` of every chunk in pass 1 and Laplace-smooth the
    counts (+1 every bin) before the tree build.  The smoothing makes the
    alphabet complete, so the encode pass can never hit a missing letter
    — the container stays exactly decodable; only the tree's optimality
    (compression ratio) degrades, typically < 1% on stationary data.
    Pass-1 cost drops ~``hist_sample``x, moving whole-file device
    compress toward the pure encode rate (config 4's fast path).

    ``check`` (r5, default on): write the per-span CRC32 integrity column
    (flags bit 1 — ``io.hff`` module docstring) so decoders detect payload
    corruption instead of emitting silently-wrong bytes like the reference
    (`comp.rs:487-519`).  The column costs < 0.01% of the size; read-side
    verification is hidden behind the decode by the verify
    pipeline on >= 4-core hosts.

    ``tree`` (r5, config 4): a pre-built shared tree — pass 1 is SKIPPED
    entirely, making this a single-pass compress at the pure encode rate
    (the whole point of shared-tree dataset compression,
    :func:`tpuhuff.io.dataset.compress_dataset`; the reference's analogue
    is one whole-file tree reused across blocks, `huff/src/comp.rs:46-66`).
    The tree must cover every byte of the file (smoothed/complete-alphabet
    trees always do) or the encode raises :class:`CompressError`; with
    ``device=True`` its code lengths must be <= 32 (``build_tree_for_device``
    guarantees this).  ``canonical`` still applies (idempotent on canonical
    trees).  ``collect_hist``: additionally return the file's exact 256-bin
    histogram, gathered DURING the encode pass (the encode program's
    ``hist_data`` operand on device, the threaded C++ histogram on host) —
    the adaptive per-shard tree refresh rides the encode instead of paying
    a separate pass.
    """
    from ..core.canonical import build_tree_for_device, canonicalize

    if block_len is None:
        block_len = DEVICE_HF2_BLOCK if device else HOST_HF2_BLOCK
    size = os.path.getsize(src_path)
    n_blocks = max(1, -(-size // block_len)) if size else 1
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    crc_every = default_crc_every(block_len) if check else 0
    span_bytes = crc_every * block_len
    # chunk step stays a whole number of blocks AND of CRC spans, so every
    # chunk starts span-aligned and per-chunk CRCs patch independently
    step_unit = span_bytes if crc_every else block_len
    step = max(1, chunk // step_unit) * step_unit
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        # pass 1: streamed histogram -> ONE whole-file tree (SKIPPED when a
        # shared `tree` arrives — config 4's single-pass path).  Device mode
        # routes chunks through the device histogram with the same
        # double-buffered submit pattern as pass 2; the accumulation stays
        # on device until one final 256-int transfer.
        samp = max(1, int(hist_sample))

        def sampled(piece: bytes) -> bytes:
            # chunk-prefix sampling: zero layout cost, one sample region
            # per `step` bytes of file
            return piece if samp == 1 else piece[: max(1, len(piece) // samp)]

        if tree is None:
            bw = ByteWeights()
            left = size
            # pass 1 needs no block alignment; clamp its read size so one
            # chunk's device histogram (int32) can never overflow even for
            # --hf2-block sizes beyond _CHUNK
            hstep = min(step, 256 << 20)
            if device:
                import jax.numpy as jnp

                from ..kernels.histogram import histogram

                # device histograms are int32; keep every device-side
                # partial sum < 2^30 by flushing the accumulator to the
                # host int64 total before 2^29 accumulated SAMPLED bytes
                # (not a fixed chunk count: step tracks --hf2-block and can
                # exceed 64 MiB),
                # while within-group accumulation stays async on device
                host_acc = np.zeros(256, dtype=np.int64)
                acc = None
                acc_bytes = 0
                pending = None
                while True:
                    piece = src.read(min(hstep, left)) if left > 0 else b""
                    left -= len(piece)
                    handle = None
                    if piece:
                        sp = sampled(piece)
                        handle = (histogram(jnp.asarray(
                            np.frombuffer(sp, dtype=np.uint8))), len(sp))
                    if pending is not None:
                        ph, pn = pending
                        acc = ph if acc is None else acc + ph
                        acc_bytes += pn
                        if acc_bytes >= (1 << 29) - hstep:
                            host_acc += np.asarray(acc).astype(np.int64)
                            acc = None
                            acc_bytes = 0
                    pending = handle
                    if pending is None and not piece:
                        break
                if acc is not None:
                    host_acc += np.asarray(acc).astype(np.int64)
                bw = ByteWeights(host_acc)
            else:
                while left > 0:
                    piece = src.read(min(hstep, left))
                    if not piece:
                        break
                    bw += ByteWeights.from_bytes(sampled(piece))
                    left -= len(piece)
            if samp > 1 and size > 0:
                # Laplace smoothing: a complete alphabet guarantees the
                # encode pass cannot hit an unsampled (code-less) byte
                bw = ByteWeights(bw.counts + 1)
            if device:
                # device codewords live in u32 lanes: length-limit deep
                # trees.  An explicit max_code_len (CLI --max-code-len)
                # trades ratio for fewer ladder levels in encode and
                # decode.
                ml_cap = 32 if max_code_len is None else min(max_code_len,
                                                             32)
                tree, _limited = build_tree_for_device(bw, max_len=ml_cap)
            elif max_code_len is not None:
                tree, _limited = build_tree_for_device(bw,
                                                       max_len=max_code_len)
            else:
                tree = HuffTree.from_weights(bw)
        if canonical:
            tree = canonicalize(tree)
        lens_lut, codes_lut = tree.encode_tables()
        ml = int(np.asarray(lens_lut).max(initial=1))
        width = hf2_table_width(block_len, ml)
        table_off, crc_off, _ = write_hf2_prelude(
            dst, tree, size, block_len, n_blocks, width, canonical,
            crc_every=crc_every,
        )
        # pass 2: chunked encode + incremental table patch
        src.seek(0)
        enc = (_device_block_encoder(tree, block_len, collect_hist)
               if device else None)
        nat = _native()
        sink = _BitSink(dst)
        bidx = 0
        left = size
        hist_acc = np.zeros(256, dtype=np.int64) if collect_hist else None
        if enc is not None:
            # double-buffered device pipeline: chunk
            # k+1's read + H2D + kernel dispatch happen while chunk k's
            # words sync back and stitch/write on host — JAX dispatch is
            # async, so the only sync point is the collect
            pending = None  # (handle, nb, crcs, submit_time)
            while True:
                handle = None
                if left > 0:
                    piece = src.read(min(step, left))
                    if piece:
                        data = np.frombuffer(piece, dtype=np.uint8)
                        left -= data.size
                        nb = -(-data.size // block_len)
                        # multi-chunk: tail padded to the body's block
                        # count so it reuses the same compiled program
                        # (padding blocks emit 0)
                        nb_enc = (max(1, step // block_len)
                                  if size > step else nb)
                        crcs = (_crc_spans(data, span_bytes, nat)
                                if crc_every else None)
                        handle = (enc.submit(data, nb_enc), nb, crcs, _now())
                    else:
                        left = 0
                if pending is not None:
                    h, nb_p, crcs_p, t0_p = pending
                    out = enc.collect(h)
                    payload, nbits, bit_lens = out[:3]
                    if collect_hist:
                        hist_acc += out[3]
                    _record_call(stats, _now() - t0_p)
                    write_hf2_table_slice(dst, table_off, width, bidx,
                                          bit_lens[:nb_p])
                    if crcs_p is not None:
                        write_hf2_crc_slice(dst, crc_off,
                                            bidx // crc_every, crcs_p)
                    sink.write(payload, nbits)
                    bidx += nb_p
                pending = handle
                if pending is None and left <= 0:
                    break
        else:
            # host pipeline (r5): chunk k encodes (+CRCs/+hist) on a worker
            # thread — the threaded C++ calls release the GIL — while the
            # main thread writes chunk k-1's payload and reads chunk k+1;
            # single worker keeps table/sink writes chunk-ordered
            import concurrent.futures as _cf

            def encode_job(piece: bytes):
                data = np.frombuffer(piece, dtype=np.uint8)
                payload, nbits, bit_lens = _encode_block_group(
                    data, block_len, lens_lut, codes_lut, nat
                )
                crcs = (_crc_spans(data, span_bytes, nat)
                        if crc_every else None)
                hist = None
                if collect_hist:
                    hist = (nat.hist(data) if nat is not None
                            else np.bincount(data, minlength=256)
                            .astype(np.int64))
                nb = -(-data.size // block_len)
                return payload, nbits, bit_lens, crcs, hist, nb

            with _cf.ThreadPoolExecutor(max_workers=1) as ex:
                pending = None
                while True:
                    fut = None
                    if left > 0:
                        piece = src.read(min(step, left))
                        if piece:
                            left -= len(piece)
                            fut = ex.submit(encode_job, piece)
                        else:
                            left = 0
                    if pending is not None:
                        payload, nbits, bit_lens, crcs, hist, nb = (
                            pending.result())
                        if hist is not None:
                            hist_acc += hist
                        write_hf2_table_slice(dst, table_off, width, bidx,
                                              bit_lens)
                        if crcs is not None:
                            write_hf2_crc_slice(dst, crc_off,
                                                bidx // crc_every, crcs)
                        sink.write(payload, nbits)
                        bidx += nb
                    pending = fut
                    if pending is None and left <= 0:
                        break
        sink.flush()
        return hist_acc


def _write_hf2_from_hff(
    dst_path: str, src: BinaryIO, header_len: int, tree: HuffTree,
    total_bits: int, boundaries: np.ndarray, in_block: int, block_len: int,
    crcs: np.ndarray | None, crc_every: int, chunk: int,
) -> None:
    """Write a ``.hf2`` wrapping a ``.hff``'s tree + verbatim payload bits,
    from an already-computed block index (and optional CRC column)."""
    orig_len = boundaries.size * block_len + in_block
    # last (partial or boundary-exact) block ends at total_bits
    if in_block or not boundaries.size:
        end_bits = np.concatenate(
            [boundaries, [np.uint64(total_bits)]]
        ).astype(np.uint64)
    else:
        # absorb trailing bits (byte padding, plus a malformed source's
        # partial final code) into the last block: <= (ml-1) + 7 extra
        # bits, which hf2_table_width's headroom accounts for
        end_bits = boundaries.copy()
        end_bits[-1] = total_bits
    n_blocks = max(end_bits.size, 1)
    lens_lut, _ = tree.encode_tables()
    ml = int(np.asarray(lens_lut).max(initial=1))
    width = hf2_table_width(block_len, ml)
    with open(dst_path, "wb") as dst:
        table_off, crc_off, _ = write_hf2_prelude(
            dst, tree, orig_len, block_len, n_blocks, width,
            canonical=False,
            crc_every=crc_every if crcs is not None else 0,
        )
        write_hf2_table_slice(
            dst, table_off, width, 0,
            np.diff(end_bits, prepend=np.uint64(0)),
        )
        if crcs is not None and crcs.size:
            write_hf2_crc_slice(dst, crc_off, 0, crcs)
        src.seek(header_len)
        left = (total_bits + 7) // 8
        while left > 0:
            piece = src.read(min(left, chunk))
            if not piece:
                break
            dst.write(piece)
            left -= len(piece)


def _hff_walk_parallel(
    src: BinaryIO, src_path: str, tree: HuffTree, total_bits: int,
    block_len: int, chunk: int, nat, on_output,
) -> tuple[np.ndarray, int]:
    """PARALLEL index+decode of a ``.hff`` payload, windowed.

    Per window: ``spec_index`` (multi-threaded DFA self-synchronization)
    finds the block boundaries, then the 4-way interleaved threaded block
    decoder materializes the bytes — ``on_output(np_u8)`` receives them in
    order.  Windows resume at the last boundary (the partial trailing
    block re-walks next window, <= one block of duplicated work per
    window).  Returns ``(boundaries_abs_bits, tail_letters)``.

    Raises RuntimeError (not StreamError) when the input shape defeats
    the parallel plan — callers fall back to the serial fused walk.
    """
    tables = nat.build_dfa(tree)
    bounds_parts = []
    pos_bit = 0
    tail_letters = 0
    window = b""
    win_byte = 0
    while pos_bit < total_bits:
        drop = pos_bit // 8 - win_byte
        if drop > 0:
            window = window[drop:]
            win_byte += drop
        want_end = min(win_byte + len(window) + chunk,
                       (total_bits + 7) // 8)
        need = want_end - (win_byte + len(window))
        if need > 0:
            window += src.read(need)
        end_bit = min((win_byte + len(window)) * 8, total_bits)
        base = win_byte * 8
        arr = np.frombuffer(window, dtype=np.uint8)
        bounds, _resume, _ib = nat.spec_index(
            arr, pos_bit - base, end_bit - base, tables, block_len, 0)
        final = end_bit == total_bits
        if bounds.size == 0 and not final:
            raise RuntimeError("block spans a whole window")
        ls = (np.concatenate([[np.uint64(pos_bit - base)], bounds[:-1]])
              if bounds.size else np.asarray([pos_bit - base], np.uint64))
        le = (bounds.copy() if bounds.size
              else np.zeros(0, np.uint64))
        if final:
            last_local = int(bounds[-1]) if bounds.size else pos_bit - base
            ls = (np.append(ls, np.uint64(last_local)) if bounds.size
                  else ls)
            le = np.append(le, np.uint64(end_bit - base))
        nb = ls.size
        caps = np.full(nb, block_len, dtype=np.uint64)
        offs = np.arange(nb, dtype=np.uint64) * np.uint64(block_len)
        out, out_lens = nat.decode_blocks(arr, ls.astype(np.uint64),
                                          le.astype(np.uint64), tables,
                                          offs, caps, None)
        n_complete = nb - (1 if final else 0)
        if not np.all(out_lens[:n_complete] == block_len):
            raise RuntimeError("boundary/letter-count disagreement")
        total_letters = int(out_lens.sum())
        on_output(out[:total_letters])
        if bounds.size:
            bounds_parts.append(bounds + np.uint64(base))
        if final:
            tail_letters = int(out_lens[-1]) if final else 0
            if nb == 1 and not bounds.size:
                tail_letters = int(out_lens[0])
            break
        new_pos = int(bounds[-1]) + base
        if new_pos <= pos_bit:
            raise StreamError(
                f"{src_path!r} stores invalid header information",
                "InvalidHeaderInfo",
            )
        pos_bit = new_pos
    boundaries = (np.concatenate(bounds_parts)
                  if bounds_parts else np.zeros(0, np.uint64))
    return boundaries, tail_letters


def decode_hff_indexed(
    src_path: str, dst_path: str, sidecar_path: str,
    block_len: int = 65536, chunk_bytes: int | None = None,
) -> bool:
    """Decode a foreign ``.hff`` AND build its block-index sidecar,
    PARALLEL (r5): ``spec_index`` splits the serial prefix-code stream
    across threads via DFA self-synchronization (SURVEY §7's "speculative
    chunk-resync"), the 4-way interleaved block decoder materializes the
    output, and the sidecar is prelude + tables + one verbatim payload
    copy.  Falls back to the serial fused ``decode_index`` walk when the
    parallel plan does not apply.  Returns True if the sidecar was
    written (a sidecar-side I/O failure is swallowed — the decoded output
    is already complete and correct without it)."""
    nat = _native()
    if nat is None:
        raise RuntimeError("decode_hff_indexed requires the native runtime")
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    size = os.path.getsize(src_path)
    crc_every = default_crc_every(block_len)
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        tree, data_padding, header_len = _read_hff_header(src, src_path)
        payload_len = size - header_len
        total_bits = max(payload_len * 8 - data_padding, 0)
        collector = _CrcCollector(crc_every * block_len, nat)

        def emit(piece) -> None:
            dst.write(piece.tobytes() if isinstance(piece, np.ndarray)
                      else piece)
            collector.feed(piece)

        try:
            boundaries, in_block = _hff_walk_parallel(
                src, src_path, tree, total_bits, block_len, chunk, nat,
                emit)
        except RuntimeError:
            # parallel plan defeated (degenerate shape): serial fused walk
            dst.seek(0)
            dst.truncate()
            src.seek(header_len)
            collector = _CrcCollector(crc_every * block_len, nat)
            boundaries, in_block = _hff_walk_serial(
                src, src_path, tree, total_bits, block_len, chunk, nat,
                emit)
        crcs = collector.finish()
        try:
            _write_hf2_from_hff(sidecar_path, src, header_len, tree,
                                total_bits, boundaries, in_block, block_len,
                                crcs, crc_every, chunk)
        except OSError:
            return False
    return True


def _hff_walk_serial(
    src: BinaryIO, src_path: str, tree: HuffTree, total_bits: int,
    block_len: int, chunk: int, nat, on_output,
) -> tuple[np.ndarray, int]:
    """Serial fused decode+index walk (``huffc_decode_index``) — the
    fallback engine behind :func:`_hff_walk_parallel`, same contract."""
    tables = nat.build_dfa(tree)
    bounds_parts = []
    pos_bit = 0
    in_block = 0
    window = b""
    win_byte = 0
    while pos_bit < total_bits:
        drop = pos_bit // 8 - win_byte
        if drop > 0:
            window = window[drop:]
            win_byte += drop
        want_end = min(win_byte + len(window) + chunk,
                       (total_bits + 7) // 8)
        need = want_end - (win_byte + len(window))
        if need > 0:
            window += src.read(need)
        end_bit = min((win_byte + len(window)) * 8, total_bits)
        out, bounds, resume, in_block = nat.decode_index(
            np.frombuffer(window, dtype=np.uint8),
            pos_bit - win_byte * 8, end_bit - win_byte * 8,
            tables, end_bit - pos_bit, block_len, in_block,
        )
        on_output(out)
        if bounds.size:
            bounds_parts.append(bounds + np.uint64(win_byte * 8))
        if end_bit == total_bits:
            pos_bit = total_bits
        else:
            new_pos = resume + win_byte * 8
            if new_pos <= pos_bit:
                raise StreamError(
                    f"{src_path!r} stores invalid header information",
                    "InvalidHeaderInfo",
                )
            pos_bit = new_pos
    boundaries = (np.concatenate(bounds_parts)
                  if bounds_parts else np.zeros(0, np.uint64))
    return boundaries, in_block


def transcode_hff_to_hf2(
    src_path: str, dst_path: str, block_len: int = 65536,
    chunk_bytes: int | None = None,
) -> None:
    """Re-index a ``.hff`` into ``.hf2`` WITHOUT recompressing.

    The reference format carries no block boundaries, forcing bit-serial
    decode; this walks the payload once with the decoding DFA (recording
    the bit offset after every ``block_len``-th letter AND the per-span
    CRCs of the decoded bytes — the output itself is discarded) and writes
    the identical tree + payload bits wrapped in the block-indexed
    container, integrity column included.  A reference-written file then
    decodes block-parallel on threads or the device (the interval search
    handles its non-canonical tree) with corruption detection the
    reference format lacks.  Streaming: O(chunk) memory + 8 bytes per
    block for the index.

    Requires the native runtime (the walker is the C++ DFA).
    """
    nat = _native()
    if nat is None:
        raise RuntimeError("transcode_hff_to_hf2 requires the native runtime")
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    size = os.path.getsize(src_path)
    crc_every = default_crc_every(block_len)
    with open(src_path, "rb") as src:
        tree, data_padding, header_len = _read_hff_header(src, src_path)
        payload_len = size - header_len
        total_bits = max(payload_len * 8 - data_padding, 0)
        collector = _CrcCollector(crc_every * block_len, nat)
        # pass 1: parallel index + decode (output feeds the CRC column,
        # then is dropped); serial fused walk as the fallback engine
        try:
            boundaries, in_block = _hff_walk_parallel(
                src, src_path, tree, total_bits, block_len, chunk, nat,
                collector.feed)
        except RuntimeError:
            src.seek(header_len)
            collector = _CrcCollector(crc_every * block_len, nat)
            boundaries, in_block = _hff_walk_serial(
                src, src_path, tree, total_bits, block_len, chunk, nat,
                collector.feed)
        # pass 2: header + index + crc column + verbatim payload copy
        _write_hf2_from_hff(dst_path, src, header_len, tree, total_bits,
                            boundaries, in_block, block_len,
                            collector.finish(), crc_every, chunk)


def read_decompress_write_hf2(
    src_path: str, dst_path: str, threads: Optional[int] = None,
    device: bool = False, chunk_bytes: int | None = None,
    stats: dict | None = None, check: bool = True,
) -> None:
    """Parallel decode of ``.hf2`` via the block index — STREAMING.

    Blocks are processed in groups of ~``chunk_bytes`` output bytes: only
    the group's payload byte range is read, decoded block-parallel
    (threaded C++ DFA, or the lane-parallel device kernels with
    ``device=True``), and written.  Peak RAM is O(chunk_bytes) plus the
    block table (8 bytes per block).

    ``check`` (r5): verify the container's per-span CRC32 column (when
    present — flags bit 1) against the decoded output, raising
    ``StreamError("...", "CorruptData")`` on payload corruption that the
    tree walk alone cannot detect.  ``check=False`` skips verification.
    """
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        try:
            hdr = read_hf2_header(src)
        except StreamError:
            raise
        except ValueError as e:
            # one typed error surface for every malformed container (the
            # reference's InvalidHeaderInfo kind, error.rs:16-19)
            raise StreamError(f"{src_path!r}: {e}",
                              "InvalidHeaderInfo") from None
        if hdr.orig_len == 0:
            return
        # header self-consistency: a corrupted orig_len/block_len/n_blocks
        # would otherwise size output buffers from attacker-controlled
        # fields (fuzz finding r5) — reject before any allocation
        if (hdr.block_len == 0 or hdr.num_blocks == 0
                or hdr.orig_len > hdr.num_blocks * hdr.block_len
                or hdr.orig_len <= (hdr.num_blocks - 1) * hdr.block_len):
            raise StreamError(
                f"{src_path!r} stores invalid header information",
                "InvalidHeaderInfo",
            )
        verifier = None
        if check and hdr.crcs is not None and hdr.crc_every:
            verifier = _CrcVerifier(hdr.crcs,
                                    hdr.crc_every * hdr.block_len,
                                    _native(), src_path)

        def emit(piece) -> None:
            dst.write(piece.tobytes() if isinstance(piece, np.ndarray)
                      else piece)
            if verifier is not None:
                verifier.feed(piece)

        if hdr.tree.is_leaf(hdr.tree.root):
            letter = bytes([int(hdr.tree.letters[hdr.tree.root])])
            left = hdr.orig_len
            while left > 0:
                n = min(left, _CHUNK)
                emit(letter * n)
                left -= n
            if verifier is not None:
                verifier.finish()
            return
        ends = hdr.end_bits.astype(np.uint64)
        # a malformed table (non-monotonic offsets) would drive negative
        # read lengths / wrapped uint64 slices below — reject up front,
        # same error surface as the reference's header validation
        if ends.size and np.any(np.diff(ends.astype(np.int64)) < 0):
            raise StreamError(
                f"{src_path!r} stores invalid header information",
                "InvalidHeaderInfo",
            )
        starts = np.concatenate([[np.uint64(0)], ends[:-1]])
        B = hdr.num_blocks
        if device and hdr.block_len > 2048:
            # big-block containers (host-written .hf2) would force a
            # block_len-step sequential scan per lane on device — the
            # threaded DFA is the right engine for those (or, without the
            # native runtime, the resumable python DFA below); device
            # decode shines at the device writer's small blocks
            device = False
        nat = None if device else _native()
        if not device and nat is None:
            # no native runtime: blocks are contiguous, so the payload is
            # one resumable serial stream (python DFA, chunked)
            from ..core.codec import PyDfaDecoder

            pad = calc_padding_bits(hdr.total_bits)
            nbytes = (hdr.total_bits + 7) // 8
            dec = PyDfaDecoder(hdr.tree)
            emitted = 0
            left = nbytes - (1 if pad else 0)
            while left > 0:
                piece = src.read(min(left, _CHUNK))
                if not piece:
                    break
                out = dec.feed(piece)
                emit(out[: hdr.orig_len - emitted])
                emitted += len(out)
                left -= len(piece)
            if pad and emitted < hdr.orig_len:
                last = src.read(1)
                if last:
                    out = dec.finish(last[0], pad)
                    emit(out[: hdr.orig_len - emitted])
            if verifier is not None:
                verifier.finish()
            return
        tables = nat.build_dfa(hdr.tree) if nat is not None else None
        # group size: power-of-two buckets from 1024 (the device kernels'
        # natural cell group) up to the chunk budget, so small files don't
        # pad to the full chunk and shapes stay reusable across files
        gcap = max(1024, chunk // max(hdr.block_len, 1))
        gsize = 1024 if device else max(1, chunk // max(hdr.block_len, 1))
        while device and gsize < min(B, gcap):
            gsize *= 2
        def read_group(g0):
            g1 = min(g0 + gsize, B)
            bit_lo = int(starts[g0])
            bit_hi = int(ends[g1 - 1])
            byte_lo = bit_lo // 8
            byte_hi = (bit_hi + 7) // 8
            src.seek(hdr.payload_offset + byte_lo)
            buf = np.frombuffer(src.read(byte_hi - byte_lo), dtype=np.uint8)
            if buf.size < byte_hi - byte_lo:
                raise StreamError(f"{src_path!r} truncated payload",
                                  "MissingHeaderInfo")
            ls = starts[g0:g1] - np.uint64(byte_lo * 8)
            le = ends[g0:g1] - np.uint64(byte_lo * 8)
            nb = g1 - g0
            caps = np.full(nb, hdr.block_len, dtype=np.uint64)
            if g1 == B:
                caps[-1] = hdr.orig_len - (B - 1) * hdr.block_len
            return buf, ls, le, nb, caps

        if device:
            from ..kernels.decode import (
                decode_rows_device, payload_to_lane_words,
            )

            def submit_group(g0):
                """Read + row-gather + async device dispatch for one group
                (r4 pipelined path: the kernel of group g runs while group
                g-1's bytes sync D2H and write out)."""
                buf, ls, le, nb, caps = read_group(g0)
                rows, bit0 = payload_to_lane_words(
                    buf, ls.astype(np.int64), le.astype(np.int64),
                    hdr.block_len)
                # bucket the shapes (group padded to gsize, word count to
                # a multiple of 8) so every group of every file reuses ONE
                # compiled program — device shapes are part of the jit key
                W8 = -(-rows.shape[1] // 8) * 8
                rows_p = np.zeros((gsize, W8), np.uint32)
                rows_p[:nb, : rows.shape[1]] = rows
                bit0_p = np.zeros(gsize, np.int32)
                bit0_p[:nb] = bit0
                nbits_p = np.zeros(gsize, np.int32)
                nbits_p[:nb] = (le - ls).astype(np.int32)
                out = decode_rows_device(rows_p, bit0_p, nbits_p,
                                         hdr.tree, hdr.block_len,
                                         as_jax=True)
                return out, nb, caps

            pending = None
            for g0 in list(range(0, B, gsize)) + [None]:
                handle = None
                if g0 is not None:
                    handle = (submit_group(g0), _now())
                if pending is not None:
                    (out_j, nb, caps), t0 = pending
                    out = np.asarray(out_j[:nb])
                    _record_call(stats, _now() - t0)
                    if caps[-1] != hdr.block_len:
                        emit(out[:-1].reshape(-1))
                        emit(out[-1, : int(caps[-1])])
                    else:
                        emit(out.reshape(-1))
                pending = handle
            if verifier is not None:
                verifier.finish()
        else:
            # CRC verification is pipelined one group deep: group k's
            # spans verify on a worker thread (ctypes releases the GIL)
            # while group k+1 decodes, so on multi-core hosts the check
            # hides behind the decode.  Each group's `out`
            # is a fresh buffer, so the worker's view stays valid.
            pool = pending_v = None
            if verifier is not None:
                import concurrent.futures as _cf

                pool = _cf.ThreadPoolExecutor(max_workers=1)
            try:
                for g0 in range(0, B, gsize):
                    buf, ls, le, nb, caps = read_group(g0)
                    offs = np.arange(nb, dtype=np.uint64) * hdr.block_len
                    try:
                        out, out_lens = nat.decode_blocks(
                            buf, ls, le, tables, offs, caps, threads
                        )
                    except RuntimeError:
                        # a corrupt payload can overflow a block's output
                        # slot inside the native decoder; same typed error
                        # surface as every other malformed-input path
                        raise StreamError(
                            f"{src_path!r} stores invalid header "
                            f"information", "InvalidHeaderInfo",
                        ) from None
                    if not np.array_equal(out_lens, caps):
                        raise StreamError(
                            f"{src_path!r} block decode length mismatch",
                            "InvalidHeaderInfo",
                        )
                    piece = out[: int(caps.sum())]
                    dst.write(piece.tobytes())
                    if pool is not None:
                        if pending_v is not None:
                            pending_v.result()  # surfaces CorruptData
                        pending_v = pool.submit(verifier.feed, piece)
                if pending_v is not None:
                    pending_v.result()
                if verifier is not None:
                    verifier.finish()
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)
