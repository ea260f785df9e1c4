"""Device encode: vectorized Huffman bit-packing in JAX/XLA.

The data-parallel replacement for the reference's bit-serial shift/or loop
(`huff_coding/src/comp.rs:424-451`).  No scatters and no
data-dependent control flow — the pack is a **doubling bit-merge**:

1.  Lookup: each byte maps to ``(acode, len)`` where ``acode`` is the
    codeword left-aligned in a u32 (``code << (32 - len)``).  Canonical
    trees use the rank ladder (:func:`lut_canonical`); any other tree a
    ``jnp.take`` from the dense tables of `HuffTree.encode_tables`.  On the
    H100 the ladder measured 3.9 ms and the take 6.2 ms per 64 MiB
    (PERF.md), so the ladder is used wherever the tree allows it.
2.  Treat every symbol as a bit-string ``(value_words, bit_len)``.
    Concatenation of two bit-strings is ``A | (B >> len_A)`` — associative.
    ``log2(N)`` pairwise-merge levels turn N symbols into one packed block.
3.  The per-row dynamic right-shift by ``len_A`` bits decomposes into a
    word-granularity shift (select tree over the bits of ``len_A >> 5``,
    static slices only) and an elementwise bit shift with carry
    (``(x >> r) | (x_prev << (32 - r))``, per-row shift amounts
    broadcast).

Everything is (B, ...) batched over blocks, so the same function runs
per-chip under ``shard_map`` (SURVEY §2 parallelism table: the CLI's
sequential block loop becomes a data-parallel grid).

Output: ``(words, bit_lens)`` — per block a u32 word array (MSB-first bit
order, big-endian byte order) and the exact bit length.  Host stitches
blocks with the correct bit-carry (`tpuhuff.native`/`core.bits`), or the
``.hf2`` container records the offsets for parallel decode.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "encode_blocks",
    "make_encode_tables",
    "words_to_payload",
    "block_bit_lengths",
    "count_missing",
    "make_canonical_encode_tables",
    "lut_canonical",
]


def make_encode_tables(lens_lut: np.ndarray, codes_lut: np.ndarray):
    """Dense device LUTs from ``HuffTree.encode_tables`` output.

    Returns ``(lens i32[256], acodes u32[256])`` with codes left-aligned to
    bit 31.  Codes longer than 32 bits are rejected (the host C++ path
    handles those pathological trees; > 32-bit codes require ~fib(32) ≈ 2M
    adversarial symbol counts).
    """
    lens = np.asarray(lens_lut, dtype=np.int64)
    codes = np.asarray(codes_lut, dtype=np.uint64)
    if lens.max(initial=0) > 32:
        raise OverflowError("device encoder supports code lengths <= 32 bits")
    acodes = (codes << (32 - lens).astype(np.uint64))[lens > 0]
    full = np.zeros(256, dtype=np.uint64)
    full[lens > 0] = acodes
    return (
        jnp.asarray(lens.astype(np.int32)),
        jnp.asarray((full & 0xFFFFFFFF).astype(np.uint32)),
    )


def _select_tree(bits, table: jnp.ndarray, lo: int, size: int) -> jnp.ndarray:
    """Small-table lookup as a balanced binary select tree.

    ``bits[k]`` is the boolean array "bit k of the index is set" (any common
    shape); ``table`` is a traced 1-D array of ``size`` power-of-two length.
    Returns ``table[index]`` elementwise using only static slices and
    ``where`` — XLA fuses the whole tree into the ladder's elementwise pass.
    """
    if size == 1:
        return table[lo]
    half = size // 2
    level = half.bit_length() - 1  # bit index that splits [lo, lo+size)
    lo_v = _select_tree(bits, table, lo, half)
    hi_v = _select_tree(bits, table, lo + half, half)
    return jnp.where(bits[level], hi_v, lo_v)


def make_canonical_encode_tables(tree):
    """Fast-path encode tables for CANONICAL codes, or None otherwise.

    With canonical codes the per-symbol (len, left-aligned code) lookup is
    ``rank = invperm[byte]`` (packed 4-per-word, 63 selects), then a
    ladder of ``max_len-1`` compares on the rank recovers the length and
    folds the code-base offset, and one variable shift left-aligns —
    ``code = (rank + d[len]) << (32 - len)`` (the exact inverse of the
    decode ladder, :func:`tpuhuff.kernels.decode.make_canonical_decode_tables`).

    Returns ``(invperm4 u32[64], present u32[8], cumle i32[32], dd i32[32],
    max_len, full_alphabet)``; bytes outside the alphabet get length 0 (no
    bits), matching the sentinel semantics of the dense-LUT path.
    ``full_alphabet`` (static bool) lets the kernels skip the membership
    select tree entirely when every byte has a code.
    """
    from ..core.canonical import canonical_codes_from_lengths

    codes = tree.read_codes()
    lengths = [(letter, code.length) for letter, code in codes.items()]
    if not lengths or any(l > 32 for _, l in lengths):
        return None
    try:
        want = canonical_codes_from_lengths(lengths)
    except (ValueError, TypeError):
        return None
    for letter, code in codes.items():
        if want[letter] != (code.value, code.length):
            return None
    items = sorted(codes.items(), key=lambda kv: (kv[1].length, kv[0]))
    ml = max(l for _, l in lengths)
    count = np.zeros(ml + 1, dtype=np.int64)
    for _, l in lengths:
        count[l] += 1
    first = np.zeros(ml + 1, dtype=np.int64)
    code_v = 0
    for L in range(1, ml + 1):
        code_v = (code_v + count[L - 1]) << 1
        first[L] = code_v
    cum_before = np.concatenate([[0], np.cumsum(count[1:])])[:-1]
    cumle = np.full(32, 1 << 30, dtype=np.int32)  # rank cum count of len<=L
    for L in range(1, ml):
        cumle[L - 1] = int(cum_before[L - 1] + count[L])
    dval = [int(first[L] - cum_before[L - 1]) for L in range(1, ml + 1)]
    dd = np.zeros(32, dtype=np.int32)
    dd[0] = dval[0]
    for j in range(1, ml):
        dd[j] = dval[j] - dval[j - 1]
    invperm = np.zeros(256, dtype=np.uint8)
    present = np.zeros(256, dtype=bool)
    for rank, (letter, _) in enumerate(items):
        invperm[int(letter)] = rank
        present[int(letter)] = True
    pbits = np.zeros(8, dtype=np.uint32)
    for b in range(256):
        if present[b]:
            pbits[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    inv = invperm.astype(np.uint32)
    inv4 = inv[0::4] | (inv[1::4] << 8) | (inv[2::4] << 16) | (inv[3::4] << 24)
    return (
        jnp.asarray(inv4),
        jnp.asarray(pbits),
        jnp.asarray(cumle),
        jnp.asarray(dd),
        ml,
        bool(present.all()),
    )


def lut_canonical(
    data_i32: jnp.ndarray, invperm4, present, cumle, dd, max_len: int,
    full_alphabet: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(lens, left-aligned acodes) for canonical codes, ladder-style."""
    # rank via packed 4-per-word inverse permutation
    bits = [((data_i32 >> (k + 2)) & 1) == 1 for k in range(6)]
    word = _select_tree(bits, invperm4, 0, 64)
    sh = ((data_i32 & 3).astype(jnp.uint32) * 8)
    rank = ((word >> sh) & jnp.uint32(0xFF)).astype(jnp.int32)
    # length + folded code base from the rank ladder
    ln = jnp.ones_like(rank)
    dlt = dd[0] + jnp.zeros_like(rank)
    for L in range(1, max_len):
        ind = (rank >= cumle[L - 1]).astype(jnp.int32)
        ln = ln + ind
        dlt = dlt + ind * dd[L]
    if not full_alphabet:
        # alphabet membership: bytes without a code emit nothing (len 0)
        wbits = [((data_i32 >> (k + 5)) & 1) == 1 for k in range(3)]
        pword = _select_tree(wbits, present, 0, 8)
        member = ((pword >> (data_i32.astype(jnp.uint32) & 31)) & 1) == 1
        ln = jnp.where(member, ln, 0)
    val = (rank + dlt).astype(jnp.uint32)
    acode = jnp.where(
        ln == 0, jnp.uint32(0),
        val << ((jnp.uint32(32) - ln.astype(jnp.uint32)) & 31),
    )
    return ln, acode


def _shift_right_bits(
    vals: jnp.ndarray, shift: jnp.ndarray, out_w: int,
    max_shift: int | None = None,
) -> jnp.ndarray:
    """Shift bit-strings right (toward later stream positions).

    ``vals``: (..., W) u32 word arrays, MSB-first bit semantics.
    ``shift``: (...,) i32 bit counts in [0, 32*W] (or [0, max_shift] when
    given — a tighter static bound shrinks the word-shift select tree; with
    ``max_shift < 32`` it vanishes entirely).
    Returns (..., out_w) with each row's bits moved ``shift`` later.
    """
    W = vals.shape[-1]
    pad = [(0, 0)] * (vals.ndim - 1) + [(0, out_w - W)]
    x = jnp.pad(vals, pad)
    q = (shift >> 5).astype(jnp.int32)
    r = (shift & 31).astype(jnp.uint32)
    # word-granularity shift: select tree over the bits of q (static slices)
    maxq = max_shift >> 5 if max_shift is not None else W
    step = 1
    while step <= maxq:
        rolled = jnp.concatenate(
            [jnp.zeros(x.shape[:-1] + (step,), x.dtype), x[..., :-step]], axis=-1
        )
        x = jnp.where(((q >> int(np.log2(step))) & 1)[..., None] == 1, rolled, x)
        step *= 2
    # bit-granularity shift with cross-word carry
    rr = r[..., None]
    prev = jnp.concatenate(
        [jnp.zeros(x.shape[:-1] + (1,), x.dtype), x[..., :-1]], axis=-1
    )
    lo = jnp.where(rr == 0, jnp.uint32(0), prev << ((jnp.uint32(32) - rr) & 31))
    return (x >> rr) | lo


def _merge_level(
    vals: jnp.ndarray, lens: jnp.ndarray, max_bits: int | None = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One doubling level: concat adjacent bit-string pairs.

    ``max_bits`` is a static upper bound on each input string's bit length.
    The merged strings then need only ``ceil(2*max_bits/32)`` words instead
    of ``2*W`` — for short codes (text trees: max ~12-16 bits) this shrinks
    every temporary and the shift select trees by 2-3x, the dominant HBM
    cost of the whole pack.
    """
    n, W = vals.shape[-2], vals.shape[-1]
    A = vals[..., 0::2, :]
    Bv = vals[..., 1::2, :]
    la = lens[..., 0::2]
    lb = lens[..., 1::2]
    if max_bits is None:
        out_w, max_shift = 2 * W, None
    else:
        assert max_bits <= 32 * W
        out_w = min(2 * W, -(-(2 * max_bits) // 32))
        max_shift = max_bits
    shifted = _shift_right_bits(Bv, la, out_w, max_shift)
    A_ext = jnp.pad(A, [(0, 0)] * (vals.ndim - 2) + [(0, 0), (0, out_w - W)])
    return A_ext | shifted, la + lb


@functools.partial(
    jax.jit,
    static_argnames=("block_len", "max_code_len", "full_alphabet",
                     "with_miss"),
)
def encode_blocks(
    data: jnp.ndarray, lens_lut: jnp.ndarray, acodes_lut: jnp.ndarray,
    valid_lens: jnp.ndarray | None = None,
    block_len: int | None = None,
    max_code_len: int | None = None,
    canon_tables=None,
    full_alphabet: bool = False,
    with_miss: bool = False,
    hist_data: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, ...]:
    """Pack blocks of bytes into Huffman bitstreams.

    ``data``: (B, N) uint8 with N a power of two.  ``valid_lens`` (B,) marks
    the real prefix of each block — bytes past it are padding and contribute
    no bits (ragged tails of a stream reshaped to fixed blocks).  Returns
    ``(words (B, W) uint32, bit_lens (B,))``.  Symbols with LUT length 0
    also contribute nothing (the "missing letter" case is checked on host).

    ``max_code_len`` is a static bound on code lengths (pass
    ``int(lens.max())`` from concrete tables) — it shrinks merge temporaries
    and the output word count to what the bound allows.
    ``canon_tables`` (from :func:`make_canonical_encode_tables`, requires
    ``max_code_len``) switches the symbol lookup from ``jnp.take`` to the
    canonical ladder; the packed bits are identical.
    ``with_miss=True`` additionally returns the total count of valid bytes
    with no code as a third array — one more lookup pass *inside the same
    program* (one dispatch, unlike a separate :func:`count_missing` call).
    ``hist_data`` (config 4's fused histogram+encode pipeline,
    :func:`tpuhuff.io.dataset.compress_dataset`): a uint8 array whose
    exact (256,) int32 histogram is appended to the returned tuple, traced
    into the same program.  Typically the chunk being encoded (adaptive tree
    refresh) or the next chunk.
    """
    if data.ndim == 1:
        data = data[None, :]
    B, N = data.shape
    if block_len is not None:
        assert N == block_len
    assert N & (N - 1) == 0, "block length must be a power of two"
    mb = None if max_code_len is None else int(max_code_len)

    if canon_tables is not None:
        assert mb is not None, "canon_tables requires max_code_len"
        inv4, present, cumle, dd = canon_tables
        lens, acodes = lut_canonical(data.astype(jnp.int32), inv4, present,
                                     cumle, dd, mb, full_alphabet)
    else:
        idx = data.astype(jnp.int32)
        lens = jnp.take(lens_lut, idx, axis=0)
        acodes = jnp.take(acodes_lut, idx, axis=0)
    if valid_lens is not None:
        mask = jnp.arange(N, dtype=jnp.int32)[None, :] < valid_lens[:, None]
        lens = jnp.where(mask, lens, 0)
        acodes = jnp.where(mask, acodes, jnp.uint32(0))
    vals = acodes[..., None]  # (B, N, 1)
    cur = lens
    while vals.shape[-2] > 1:
        vals, cur = _merge_level(vals, cur, mb)
        if mb is not None:
            mb = min(2 * mb, 32 * vals.shape[-1])
    res = [vals[..., 0, :], cur[..., 0]]
    if with_miss:
        res.append(_count_missing(data, lens_lut, valid_lens))
    if hist_data is not None:
        from .histogram import histogram

        res.append(histogram(hist_data))
    return tuple(res)


def _count_missing(data, lens_lut, valid_lens):
    """Valid bytes of ``data`` with no code (LUT length 0)."""
    miss = (jnp.take(lens_lut, data.astype(jnp.int32), axis=0) == 0
            ).astype(jnp.int32)
    if valid_lens is not None:
        N = data.shape[-1]
        miss = jnp.where(
            jnp.arange(N, dtype=jnp.int32)[None, :] < valid_lens[:, None],
            miss, 0,
        )
    return jnp.sum(miss)


def count_missing(
    data: jnp.ndarray, lens_lut: jnp.ndarray,
    valid_lens: jnp.ndarray | None = None,
) -> int:
    """Number of (valid) input bytes with no code in the LUT.

    The device-side guard matching the reference's per-letter
    ``CompressError`` (`comp.rs:427-432`): the encode kernels emit 0 bits
    for an out-of-alphabet byte (possible only with a stale or foreign
    tree), which would corrupt the stream silently — callers check this
    count on host and raise :class:`CompressError` instead.  One cheap
    LUT+compare+sum pass (~the cost of :func:`block_bit_lengths`).
    """
    if data.ndim == 1:
        data = data[None, :]
    return int(jax.jit(_count_missing)(data, lens_lut, valid_lens))


def block_bit_lengths(data: jnp.ndarray, lens_lut: jnp.ndarray) -> jnp.ndarray:
    """Exact per-block bit lengths (cheap pre-pass for allocation/offsets)."""
    lens = jnp.take(lens_lut, data.astype(jnp.int32), axis=0)
    return jnp.sum(lens, axis=-1)


def words_to_payload(words: np.ndarray, bit_len: int) -> bytes:
    """Convert one block's u32 words (MSB-first) to the byte payload."""
    nbytes = (int(bit_len) + 7) // 8
    raw = np.asarray(words).astype(">u4").tobytes()
    return raw[:nbytes]
