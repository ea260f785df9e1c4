"""Block codec: in-memory compress / decompress.

Capability match for `/root/reference/huff_coding/src/comp.rs` (L3 in SURVEY
§1): ``compress`` (`comp.rs:353-356`), ``compress_with_tree``
(`comp.rs:419-451`), ``decompress`` (`comp.rs:487-519`).

Data-parallel redesign: the reference's bit-serial pack loop (`comp.rs:424-447`)
and per-bit tree walk (`comp.rs:493-516`) become vectorized array programs.
This module holds the *host* (numpy) implementations — the exact same
expand/scan/pack formulation the kernels use on device
(:mod:`tpuhuff.kernels`) — plus the generic-letter slow path.  The C++ native
runtime (:mod:`tpuhuff.native`) plugs in below numpy for single-stream
latency; all three produce identical bytes.
"""

from __future__ import annotations

from typing import Hashable, List, Union

import numpy as np

from .bits import calc_padding_bits
from .format import CompressData, CompressError
from .letters import U8, LetterType
from .tree import HuffTree
from .weights import ByteWeights, build_weights_map

__all__ = [
    "compress",
    "compress_with_tree",
    "decompress",
    "pack_codes_u8",
    "unpack_codes_u8",
    "PyDfaDecoder",
]

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]

# chunk size for the numpy bit-expansion (bounds temp memory to ~35 MB/chunk)
_PACK_CHUNK = 1 << 20


def _native():
    """The C++ runtime if it built successfully, else None (numpy fallback)."""
    try:
        from .. import native

        return native if native.available() else None
    except Exception:
        return None


def _is_u8_data(letters) -> bool:
    return isinstance(letters, (bytes, bytearray, memoryview)) or (
        isinstance(letters, np.ndarray) and letters.dtype == np.uint8
    )


def _as_u8(letters) -> np.ndarray:
    if isinstance(letters, np.ndarray):
        return letters.ravel()
    return np.frombuffer(bytes(letters), dtype=np.uint8)


# ---------------------------------------------------------------------------
# u8 fast path: vectorized pack / unpack (numpy form of the device kernels)
# ---------------------------------------------------------------------------
def pack_codes_u8(
    data: np.ndarray, lens_lut: np.ndarray, codes_lut: np.ndarray
) -> tuple[bytes, int]:
    """Pack ``data`` bytes into a MSB-first bitstream via dense LUTs.

    The vectorized analogue of the reference's shift/or loop
    (`comp.rs:424-447`): gather code lengths, exclusive-scan bit offsets,
    expand each code to its bit positions, and ``packbits``.  Returns
    ``(payload_bytes, padding_bits)``.

    Raises :class:`CompressError` on a byte with no code (LUT len 0),
    matching `comp.rs:427-432`.
    """
    data = _as_u8(data)
    lens = lens_lut[data].astype(np.int64)
    if lens.size and int(lens.min()) == 0:
        missing = int(data[int(np.argmin(lens))])
        raise CompressError("letter not found in codes", missing)
    total_bits = int(lens.sum())
    if total_bits == 0:
        return b"", 0
    bits = np.empty(total_bits, dtype=np.uint8)
    # chunk the expansion to bound temp memory; bit offsets carry across chunks
    bit_base = 0
    for start in range(0, data.size, _PACK_CHUNK):
        chunk = data[start : start + _PACK_CHUNK]
        clens = lens[start : start + _PACK_CHUNK]
        ctotal = int(clens.sum())
        offsets = np.cumsum(clens) - clens  # exclusive scan
        rep_codes = np.repeat(codes_lut[chunk], clens)
        rep_lens = np.repeat(clens, clens)
        pos_in_code = np.arange(ctotal, dtype=np.int64) - np.repeat(offsets, clens)
        shift = (rep_lens - 1 - pos_in_code).astype(np.uint64)
        bits[bit_base : bit_base + ctotal] = (
            (rep_codes >> shift) & np.uint64(1)
        ).astype(np.uint8)
        bit_base += ctotal
    payload = np.packbits(bits).tobytes()  # MSB-first, zero-padded
    return payload, calc_padding_bits(total_bits)


def unpack_codes_u8(
    payload: BytesLike, padding_bits: int, tree: HuffTree
) -> bytes:
    """Decode a MSB-first bitstream with the byte-driven DFA.

    Table-driven replacement for the reference's per-bit pointer chase
    (`comp.rs:493-519`): one table lookup consumes 8 compressed bits and emits
    0..8 letters.  The final byte honors ``padding_bits`` (`comp.rs:516`).
    """
    payload = bytes(payload)
    if not payload:
        return b""
    nbits = len(payload) * 8 - padding_bits
    if tree.is_leaf(tree.root):
        # degenerate single-letter tree: every payload bit emits the letter
        # (`comp.rs:506-509` — walker is at a leaf already for every bit)
        return bytes([int(tree.letters[tree.root])]) * nbits
    nat = _native()
    if nat is not None:
        arr = np.frombuffer(payload, dtype=np.uint8)
        tables = nat.build_dfa(tree)
        # letters <= payload bits (every code >= 1 bit): nbits is a hard cap.
        # Try a typical-ratio buffer first to avoid a huge allocation, retry
        # at the hard cap if the stream expands more than 4x.
        guess = min(nbits, max(4 * len(payload), 1 << 20))
        try:
            return nat.decode(arr, 0, nbits, tables, guess)
        except RuntimeError:
            return nat.decode(arr, 0, nbits, tables, nbits)
    dec = PyDfaDecoder(tree)
    out = bytearray(dec.feed(payload[:-1] if padding_bits else payload))
    if padding_bits:
        out += dec.finish(payload[-1], padding_bits)
    return bytes(out)


class PyDfaDecoder:
    """Resumable pure-python byte-driven DFA decoder (correctness baseline).

    Carries the walker state across :meth:`feed` calls so streaming callers
    decode in bounded memory — the python analogue of the reference's
    persistent ``current_branch`` across read blocks
    (`huff/src/comp.rs:240`).  The C++ and device paths own the hot decode;
    this exists so a host without a compiler still streams correctly.
    """

    def __init__(self, tree: HuffTree):
        self.tree = tree
        (self.next_state, self.emit_count, self.emit_syms,
         state_of_node) = tree.decode_dfa()
        # invert the DFA's own state numbering once — finish() resumes the
        # tree walk from node_of_state[state] (review r4: the previous
        # _state_to_node re-derived the ordering by duplicating
        # decode_dfa's sort rule, a silent-desync hazard)
        self.node_of_state = np.zeros(self.next_state.shape[0],
                                      dtype=np.int64)
        for node, st in enumerate(state_of_node):
            if st >= 0:
                self.node_of_state[st] = node
        self.state = 0

    def feed(self, data: BytesLike) -> bytes:
        """Decode whole bytes (8 bits each); returns the emitted letters."""
        next_state, emit_count, emit_syms = (
            self.next_state, self.emit_count, self.emit_syms,
        )
        out = bytearray()
        state = self.state
        for byte in np.frombuffer(bytes(data), dtype=np.uint8):
            b = int(byte)
            cnt = int(emit_count[state, b])
            if cnt:
                out += emit_syms[state, b, :cnt].tobytes()
            state = int(next_state[state, b])
        self.state = state
        return bytes(out)

    def finish(self, last_byte: int, padding_bits: int) -> bytes:
        """Decode the final byte honoring its padding (`comp.rs:516`)."""
        if padding_bits == 0:
            return self.feed(bytes([last_byte]))
        tree = self.tree
        out = bytearray()
        left, right, letters = tree.left, tree.right, tree.letters
        node = int(self.node_of_state[self.state])
        for bit_i in range(7, padding_bits - 1, -1):
            bit = (last_byte >> bit_i) & 1
            node = int(right[node] if bit else left[node])
            if left[node] < 0:
                out.append(int(letters[node]))
                node = tree.root
        return bytes(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def compress(letters, ltype: LetterType | str | None = None) -> CompressData:
    """Count weights, build a tree, and compress (`comp.rs:353-356`)."""
    if _is_u8_data(letters):
        tree = HuffTree.from_weights(ByteWeights.from_bytes(_as_u8(letters)))
        return compress_with_tree(letters, tree, ltype or U8)
    weights = build_weights_map(letters)
    tree = HuffTree.from_weights(weights)
    return compress_with_tree(letters, tree, ltype)


def compress_with_tree(
    letters, huff_tree: HuffTree, ltype: LetterType | str | None = None
) -> CompressData:
    """Compress with a pre-built tree (`comp.rs:419-451`)."""
    if _is_u8_data(letters):
        data = _as_u8(letters)
        lens_lut, codes_lut = huff_tree.encode_tables()
        nat = _native()
        if nat is not None:
            try:
                payload, padding = nat.encode(data, lens_lut, codes_lut)
            except CompressError:
                # re-raise via the numpy path, which names the missing letter
                payload, padding = pack_codes_u8(data, lens_lut, codes_lut)
        else:
            payload, padding = pack_codes_u8(data, lens_lut, codes_lut)
        if not payload:
            # reference panics via CompressData::new on empty comp_bytes
            raise ValueError("provided comp_bytes are empty")
        return CompressData(payload, padding, huff_tree, ltype or U8)
    # generic-letter slow path: python bit append (mirrors comp.rs:424-447)
    codes = huff_tree.read_codes()
    value = 0
    nbits = 0
    for letter in letters:
        code = codes.get(letter)
        if code is None:
            raise CompressError("letter not found in codes", letter)
        value = (value << code.length) | code.value
        nbits += code.length
    padding = calc_padding_bits(nbits)
    if nbits == 0:
        raise ValueError("provided comp_bytes are empty")
    payload = (value << padding).to_bytes((nbits + padding) // 8, "big")
    return CompressData(payload, padding, huff_tree, ltype or _infer_ltype(letters))


def _infer_ltype(letters) -> LetterType:
    """Smallest registered integer width covering every letter.

    The reference's codec is statically typed over ``L``
    (`comp.rs:353`, `letter.rs:57-60`); the runtime analogue is width
    inference: unsigned letters pick u8/u16/u32/u64/u128, any negative
    letter switches to the signed ladder.  Non-integer letters (char/str —
    tree-only in the reference, `letter.rs:33-37`) keep the U8 default;
    serializing such a tree raises the letter type's own ``TypeError``.
    """
    from .letters import I8, I16, I32, I64, I128, U16, U32, U64, U128

    lo = hi = 0
    for l in letters:
        if isinstance(l, bool) or not isinstance(l, (int, np.integer)):
            return U8  # no integer wire form; as_be_bytes raises if serialized
        v = int(l)
        lo = min(lo, v)
        hi = max(hi, v)
    ladder = (
        (I8, I16, I32, I64, I128) if lo < 0 else (U8, U16, U32, U64, U128)
    )
    for lt in ladder:
        lo_ok = lo >= (-(1 << (lt.size_bits - 1)) if lt.signed else 0)
        hi_ok = hi < (1 << (lt.size_bits - 1) if lt.signed else 1 << lt.size_bits)
        if lo_ok and hi_ok:
            return lt
    raise OverflowError(
        f"letters span [{lo}, {hi}], wider than any registered letter type"
    )


def decompress(comp_data: CompressData) -> Union[bytes, List[Hashable]]:
    """Decompress (`comp.rs:487-519`).

    Returns ``bytes`` when all letters are u8 ints, else a list of letters.
    """
    tree = comp_data.huff_tree
    all_u8 = all(
        l is None or (isinstance(l, (int, np.integer)) and 0 <= l < 256)
        for l in tree.letters
    )
    if all_u8:
        return unpack_codes_u8(
            comp_data.comp_bytes, comp_data.padding_bits, tree
        )
    # generic path: per-bit tree walk
    out: List[Hashable] = []
    left, right, letters = tree.left, tree.right, tree.letters
    root = tree.root
    node = root
    payload = comp_data.comp_bytes
    total_bits = len(payload) * 8 - comp_data.padding_bits
    root_is_leaf = tree.is_leaf(root)
    for i in range(total_bits):
        if not root_is_leaf:
            bit = (payload[i >> 3] >> (7 - (i & 7))) & 1
            node = int(right[node] if bit else left[node])
        if left[node] < 0:
            out.append(letters[node])
            node = root
    return out
