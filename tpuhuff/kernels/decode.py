"""Device decode: lane-parallel prefix-code decoding.

The parallel replacement for the reference's bit-serial tree walk
(`/root/reference/huff_coding/src/comp.rs:487-519`).  A serial prefix-code
stream cannot be split mid-stream, so parallelism comes from **blocks**: the
``.hf2`` container records per-block bit offsets (SURVEY §7 hard part 2),
and every block becomes a *lane* that decodes independently.

Each lane reads the next 32 bits of its stream as an MSB-aligned window and
maps it to ``(symbol, code length)`` with one of two leaf searches, chosen by
the tree's shape in :func:`make_decode_tables`:

* canonical codes (what the ``.hf2`` writers emit): canonical length classes
  occupy nested value ranges, so a ladder of ``max_len - 1`` compares
  against the class bounds gives the length and the index offset, and one
  table gather gives the symbol;
* any other prefix tree (a reference-built ``.hff``): left-to-right leaves
  have ascending left-aligned code values partitioning [0, 2^32), so a
  binary search over the 256 thresholds finds the leaf.

Every device runs the same program, :func:`decode_blocks_device`: an XLA
scan that gathers each lane's next two words at its bit cursor and emits
one symbol per lane per step.  A hand-written kernel was faster on the
H100's device clock but slower end to end on the file paths (PERF.md).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.tree import HuffTree

__all__ = [
    "make_decode_tables",
    "make_canonical_decode_tables",
    "decode_blocks_device",
    "decode_rows_device",
    "decode_hf2_device",
    "payload_to_lane_words",
]


def make_canonical_decode_tables(tree: HuffTree):
    """Ladder tables for CANONICAL codes, or None if the tree's codes are
    not canonical (sorted by (length, letter), numerically increasing —
    ``core.canonical.canonicalize`` output, flagged in ``.hf2``).

    * ``ub[L-1]`` (u32, left-aligned): exclusive upper bound of all codes of
      length <= L; ``len(window) = 1 + count over L of (window >= ub)``.
    * ``dd`` (i32): ladder deltas folding the index offset into the same
      compares: ``idx = (window >> (32-len)) + dd[0] + sum ind_L * dd[L]``.
    * ``perm`` (i32[256]): canonical index -> byte.

    Returns numpy ``(ub, dd, perm, max_len)``.
    """
    from ..core.canonical import canonical_codes_from_lengths

    codes = tree.read_codes()
    lengths = [(letter, code.length) for letter, code in codes.items()]
    if any(l > 32 for _, l in lengths):
        return None
    want = canonical_codes_from_lengths(lengths)
    for letter, code in codes.items():
        if want[letter] != (code.value, code.length):
            return None
    items = sorted(codes.items(), key=lambda kv: (kv[1].length, kv[0]))
    ml = max(l for _, l in lengths)
    count = np.zeros(ml + 1, dtype=np.int64)
    for _, l in lengths:
        count[l] += 1
    # canonical first-code per length (RFC1951-style) + cumulative index
    first = np.zeros(ml + 1, dtype=np.int64)
    code_v = 0
    for L in range(1, ml + 1):
        code_v = (code_v + count[L - 1]) << 1
        first[L] = code_v
    cum_before = np.concatenate([[0], np.cumsum(count[1:])])[:-1]  # idx of
    # first length-L code within the sorted symbol order, index L-1
    delta = [int(cum_before[L - 1] - first[L]) for L in range(1, ml + 1)]
    ub = np.zeros(max(ml - 1, 1), dtype=np.uint32)
    for L in range(1, ml):
        v = (first[L] + count[L]) << (32 - L)
        ub[L - 1] = min(v, (1 << 32) - 1)
    dd = np.zeros(ml, dtype=np.int32)
    dd[0] = delta[0]
    for j in range(1, ml):
        dd[j] = delta[j] - delta[j - 1]
    perm = np.zeros(256, dtype=np.int32)
    K = len(items)
    perm[:K] = [int(letter) for letter, _ in items]
    if K < 256:
        perm[K:] = perm[K - 1]
    return ub, dd, perm, ml


def make_decode_tables(tree: HuffTree):
    """Tables for :func:`decode_blocks_device`, one set per leaf search.

    Returns ``(tables, statics)``: three device arrays and the static
    keyword arguments that select the leaf search.  Canonical trees get
    ``(ub u32[32], dd i32[32], perm i32[256])``; any other tree gets
    ``(thr u32[256], symlen i32[256], unused i32[1])``, where ``thr[k]`` is
    leaf k's left-aligned code in left-to-right order and ``symlen[k]`` is
    ``symbol | length << 8``.  Entries past the real leaf count repeat the
    last leaf, so the search still resolves to a correct pair.
    """
    canon = make_canonical_decode_tables(tree)
    if canon is not None:
        ub, dd, perm, ml = canon
        ub32 = np.zeros(32, np.uint32)
        ub32[: ub.size] = ub
        dd32 = np.zeros(32, np.int32)
        dd32[: dd.size] = dd
        return ((jnp.asarray(ub32), jnp.asarray(dd32), jnp.asarray(perm)),
                dict(canonical=True, max_len=int(ml), levels=0))
    items = []
    for letter, code in tree.read_codes().items():
        if code.length > 32:
            raise OverflowError("device decoder supports code lengths <= 32")
        items.append((code.value << (32 - code.length), int(letter),
                      code.length))
    items.sort()
    K = len(items)
    thr = np.zeros(256, dtype=np.uint32)
    symlen = np.zeros(256, dtype=np.int32)
    thr[:K] = [a for a, _, _ in items]
    symlen[:K] = [s | (l << 8) for _, s, l in items]
    thr[K:] = thr[K - 1]
    symlen[K:] = symlen[K - 1]
    levels = max(1, (max(K, 2) - 1).bit_length())
    return ((jnp.asarray(thr), jnp.asarray(symlen), jnp.zeros(1, jnp.int32)),
            dict(canonical=False, max_len=0, levels=levels))


def payload_to_lane_words(
    payload: bytes | np.ndarray,
    start_bits: np.ndarray,
    end_bits: np.ndarray,
    block_len: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Slice a stitched payload into per-lane u32 word rows.

    Lane k's words start at the u32 word containing ``start_bits[k]``;
    returns ``(rows (B, Wmax) uint32, bit0 (B,) int32)`` where ``bit0`` is
    the start bit offset within each row.  Wmax covers the worst block plus
    a slack word so the 2-word window never reads past the row.
    """
    raw = np.frombuffer(bytes(payload), dtype=np.uint8) if not isinstance(
        payload, np.ndarray
    ) else payload.view(np.uint8)
    # pad to whole u32 words + 1 slack word for window overreach
    nwords = (raw.size + 3) // 4 + 2
    buf = np.zeros(nwords * 4, dtype=np.uint8)
    buf[: raw.size] = raw
    words = buf.view(">u4").astype(np.uint32)
    B = start_bits.size
    start_w = (start_bits // 32).astype(np.int64)
    end_w = ((end_bits + 31) // 32).astype(np.int64)
    Wmax = int(np.max(end_w - start_w + 1, initial=1)) + 1
    try:
        from .. import native

        nat = native if native.available() else None
    except Exception:
        nat = None
    if nat is not None:
        # threaded memcpy gather — the numpy fancy index below materializes
        # a (B, Wmax) int64 index array larger than the payload itself
        rows = nat.extract_rows(words, start_w.astype(np.uint64), Wmax)
    else:
        idx = np.minimum(start_w[:, None] + np.arange(Wmax)[None, :],
                         words.size - 1)
        rows = words[idx]
    # the slack tail beyond each lane's own payload words needs no zeroing:
    # the active mask stops the cursor at nbits exactly.
    bit0 = (start_bits - start_w * 32).astype(np.int32)
    return rows, bit0


@functools.partial(
    jax.jit, static_argnames=("block_len", "canonical", "max_len", "levels"))
def decode_blocks_device(
    rows, bit0, nbits, t0, t1, t2, *, block_len: int, canonical: bool,
    max_len: int, levels: int,
) -> jnp.ndarray:
    """XLA scan: decode B lanes of up to ``block_len`` symbols each.

    ``rows``: (B, W) u32 per-lane word rows (MSB-first bit order);
    ``bit0``/``nbits``: per-lane start offset within the row and payload bit
    count; ``t0..t2`` and the static keywords from :func:`make_decode_tables`.
    Each scan step gathers two words at every lane's cursor and emits one
    symbol per lane.  Returns (B, block_len) uint8, zero past each lane's
    symbol count.
    """
    B, W = rows.shape
    rows = rows.astype(jnp.uint32)
    lane = jnp.arange(B)

    def leaf(window):
        if canonical:
            ln = jnp.ones_like(window, jnp.int32)
            delta = jnp.full_like(ln, t1[0])
            for L in range(1, max_len):
                ind = (window >= t0[L - 1]).astype(jnp.int32)
                ln = ln + ind
                delta = delta + ind * t1[L]
            v = (window >> (32 - ln).astype(jnp.uint32)).astype(jnp.int32)
            return t2[(v + delta) & 255], ln
        pos = jnp.zeros_like(window, jnp.int32)
        for k in reversed(range(levels)):
            pos = jnp.where(t0[pos + (1 << k)] <= window, pos + (1 << k), pos)
        t = t1[pos]
        return t & 255, t >> 8

    def step(state, _):
        pos, consumed = state
        q = pos >> 5
        r = (pos & 31).astype(jnp.uint32)
        w0 = rows[lane, jnp.minimum(q, W - 1)]
        w1 = rows[lane, jnp.minimum(q + 1, W - 1)]
        lo = jnp.where(r == 0, jnp.uint32(0), w1 >> ((32 - r) & 31))
        sym, ln = leaf((w0 << r) | lo)
        active = consumed + ln <= nbits
        ln = jnp.where(active, ln, 0)
        sym = jnp.where(active, sym, 0).astype(jnp.uint8)
        return (pos + ln, consumed + ln), sym

    bit0 = bit0.astype(jnp.int32)
    _, out = jax.lax.scan(step, (bit0, jnp.zeros_like(bit0)), None,
                          length=block_len)
    return out.T


def decode_rows_device(
    rows, bit0, nbits, tree: HuffTree, block_len: int, as_jax: bool = False,
) -> np.ndarray:
    """Decode per-lane word rows through :func:`decode_blocks_device`.

    Returns (B, block_len) uint8 (numpy) — or, with ``as_jax``, the
    not-yet-synced device array (JAX dispatch is async, so the caller can
    overlap the D2H of one group with the kernel of the next).
    """
    tables, statics = make_decode_tables(tree)
    out = decode_blocks_device(jnp.asarray(rows), jnp.asarray(bit0),
                               jnp.asarray(nbits), *tables,
                               block_len=block_len, **statics)
    return out if as_jax else np.asarray(out)


def decode_hf2_device(header, payload: bytes) -> bytes:
    """Decode a whole .hf2 payload on device; returns the original bytes.

    The leaf search follows the header tree's shape (detected from the tree
    itself, not the flag — foreign files may flag incorrectly).
    """
    ends = header.end_bits.astype(np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    rows, bit0 = payload_to_lane_words(payload, starts, ends, header.block_len)
    nbits = (ends - starts).astype(np.int32)
    out = decode_rows_device(rows, bit0, nbits, header.tree, header.block_len)
    # rows are block_len apart in the original stream, so the flat view is
    # the stream itself (padding symbols land past orig_len and are cut)
    return out.reshape(-1)[: header.orig_len].tobytes()
