"""Block-parallel encode pipeline under ``shard_map``.

The data-parallel version of the reference CLI's two-pass streaming compress
(`/root/reference/huff/src/comp.rs:32-74`):

* pass 1 — per-device histograms of the local blocks, merged with a single
  ``psum`` over the mesh, replacing the thread-join+add merge
  (`weights.rs:306-318`).  The tree itself is built on host from the 256
  counts (O(k log k), k<=256 — microseconds, `tree_inner.rs:289-303`).
* pass 2 — every device packs its blocks with the broadcast LUTs
  (:func:`tpuhuff.kernels.encode_blocks`); per-block bit lengths come back
  with the words, and the host (or the ``.hf2`` writer) does the ordered
  bit-carry concatenation — correctly, unlike the reference's seek-back
  stitch (`huff/src/comp.rs:196-201`, SURVEY §2 quirk).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels import encode_blocks, make_encode_tables
from ..kernels.histogram import histogram
from .mesh import BLOCK_AXIS, make_mesh

__all__ = [
    "sharded_histogram",
    "sharded_encode",
    "sharded_count_missing",
    "sharded_decode_blocks",
    "encode_pipeline",
    "encode_pipeline_arrays",
    "pad_to_blocks",
]


def pad_to_blocks(
    data: np.ndarray, block_len: int, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Reshape a byte stream to (B, block_len), B a multiple of n_shards.

    Returns ``(blocks, valid_lens, orig_len)``; ``valid_lens[b]`` is the
    number of real bytes in block b (padding bytes beyond it are masked out
    by the encode kernel, so they emit no bits and no histogram counts are
    taken from them).
    """
    n = data.size
    blocks = max(1, -(-n // block_len))
    blocks = -(-blocks // n_shards) * n_shards
    padded = np.zeros(blocks * block_len, dtype=np.uint8)
    padded[:n] = data
    valid = np.clip(n - np.arange(blocks, dtype=np.int64) * block_len, 0, block_len)
    return padded.reshape(blocks, block_len), valid.astype(np.int32), n


def _hist_shard(local: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    h = histogram(local)
    # padding bytes are 0-valued; subtract their count so the tree sees only
    # real data (the analogue of hashing only what was read,
    # huff/src/comp.rs:167-169)
    pad = jnp.sum(jnp.int32(local.shape[-1]) - valid)
    h = h.at[0].add(-pad)
    return jax.lax.psum(h, BLOCK_AXIS)


# Each sharded program is built once per mesh and static configuration: a
# fresh ``jax.jit(shard_map(...))`` per call would trace, lower and compile
# anew on every call.


@functools.lru_cache(maxsize=None)
def _hist_program(mesh: Mesh):
    return jax.jit(jax.shard_map(
        _hist_shard, mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS)), out_specs=P(),
    ))


def sharded_histogram(
    blocks: jnp.ndarray, valid_lens: jnp.ndarray, mesh: Mesh
) -> np.ndarray:
    """Global 256-bin histogram of (B, N) blocks sharded over the mesh."""
    return np.asarray(_hist_program(mesh)(blocks, valid_lens))


def sharded_count_missing(
    blocks: jnp.ndarray, valid_lens: jnp.ndarray, lens_lut, mesh: Mesh,
) -> int:
    """Global count of valid bytes with no code (LUT len 0) over the mesh.

    The sharded twin of :func:`tpuhuff.kernels.encode.count_missing` — the
    guard for the silent missing-letter case (`comp.rs:427-432`)."""
    return int(_missing_program(mesh)(blocks, valid_lens, lens_lut))


@functools.lru_cache(maxsize=None)
def _missing_program(mesh: Mesh):
    from ..kernels.encode import _count_missing

    def shard(local, valid, ll):
        return jax.lax.psum(_count_missing(local, ll, valid), BLOCK_AXIS)

    return jax.jit(jax.shard_map(
        shard, mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P()), out_specs=P(),
    ))


def sharded_encode(
    blocks: jnp.ndarray, valid_lens: jnp.ndarray, lens_lut, acodes_lut,
    mesh: Mesh, max_code_len: int | None = None, canon_tables=None,
    check_missing: bool = True, full_alphabet: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pack (B, N) blocks data-parallel; returns (words (B, W), bits (B,)).

    ``check_missing`` (default on): counts valid bytes with no code and
    raises :class:`CompressError` instead of silently dropping them
    (reference `comp.rs:427-432`).  The count rides the encode program
    (``with_miss`` — one more lookup pass in the same program) with a
    ``psum`` across the mesh; no separate dispatch.
    :func:`encode_pipeline` passes False — its histogram-vs-LUT host
    check already guarantees coverage.
    """
    canon = tuple(canon_tables) if canon_tables is not None else ()
    fn = _encode_program(mesh, max_code_len, len(canon), check_missing,
                         full_alphabet)
    out = fn(blocks, valid_lens, lens_lut, acodes_lut, *canon)
    if check_missing:
        words, bits, miss = out
        if int(miss):
            from ..core.format import CompressError

            raise CompressError(
                f"letter not found in codes ({int(miss)} bytes)", None
            )
        return words, bits
    return out


@functools.lru_cache(maxsize=None)
def _encode_program(mesh: Mesh, max_code_len: int | None, n_canon: int,
                    check_missing: bool, full_alphabet: bool):
    def shard(local, valid, ll, al, *canon):
        kw = {"full_alphabet": full_alphabet}
        if max_code_len is not None:
            kw["max_code_len"] = max_code_len
        if canon:
            kw["canon_tables"] = canon
        if check_missing:
            words, bits, miss = encode_blocks(local, ll, al, valid,
                                              with_miss=True, **kw)
            return words, bits, jax.lax.psum(miss, BLOCK_AXIS)
        return encode_blocks(local, ll, al, valid, **kw)

    out_specs = ((P(BLOCK_AXIS), P(BLOCK_AXIS), P()) if check_missing
                 else (P(BLOCK_AXIS), P(BLOCK_AXIS)))
    return jax.jit(jax.shard_map(
        shard,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(), P()) + (P(),) * n_canon,
        out_specs=out_specs,
    ))


def sharded_decode_blocks(
    rows: jnp.ndarray, bit0: jnp.ndarray, nbits: jnp.ndarray, tree,
    block_len: int, mesh: Mesh,
) -> jnp.ndarray:
    """Block-parallel decode across the mesh (config-3's decode side).

    ``rows`` (B, W) u32 per-block word rows (``payload_to_lane_words``
    layout), sharded over ``BLOCK_AXIS``; decode tables replicate.  Every
    device decodes its blocks with the one-device program
    (:func:`tpuhuff.kernels.decode.decode_blocks_device`), for canonical and
    foreign (e.g. reference-built, ``tree_inner.rs:422-440``) trees alike;
    returns (B, block_len) uint8 with the same sharding.
    """
    from ..kernels.decode import make_decode_tables

    tables, statics = make_decode_tables(tree)
    fn = _decode_program(mesh, block_len, **statics)
    return fn(rows, bit0, nbits, *tables)


@functools.lru_cache(maxsize=None)
def _decode_program(mesh: Mesh, block_len: int, canonical: bool,
                    max_len: int, levels: int):
    from ..kernels.decode import decode_blocks_device

    def shard(r, b0, nb, a1, a2, a3):
        return decode_blocks_device(r, b0, nb, a1, a2, a3,
                                    block_len=block_len, canonical=canonical,
                                    max_len=max_len, levels=levels)

    return jax.jit(jax.shard_map(
        shard, mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS),
                  P(), P(), P()),
        out_specs=P(BLOCK_AXIS),
    ))


def encode_pipeline(
    data: np.ndarray,
    block_len: int = 65536,
    mesh: Mesh | None = None,
    max_code_len: int = 32,
    canonical: bool = False,
) -> Tuple[np.ndarray, np.ndarray, "object", int]:
    """Full two-pass pipeline: psum histogram -> host tree -> sharded pack.

    Returns ``(words (B, N) u32, bit_lens (B,), tree, orig_len)``.
    """
    if mesh is None:
        mesh = make_mesh()
    n_shards = mesh.devices.size
    blocks, valid, orig_len = pad_to_blocks(
        np.asarray(data, dtype=np.uint8).ravel(), block_len, n_shards
    )
    words, bits, tree = encode_pipeline_arrays(
        jnp.asarray(blocks), jnp.asarray(valid), mesh, max_code_len, canonical
    )
    return np.asarray(words), np.asarray(bits), tree, orig_len


def encode_pipeline_arrays(
    jblocks: jnp.ndarray,
    jvalid: jnp.ndarray,
    mesh: Mesh,
    max_code_len: int = 32,
    canonical: bool = False,
):
    """Device-array core of the pipeline: psum histogram -> host tree ->
    sharded pack.  ``jblocks``/``jvalid`` may be global (multi-process)
    arrays sharded over ``mesh``; the returned ``(words, bits)`` carry the
    same block sharding and ``tree`` is identical on every process (the
    histogram is a global psum).  ``canonical`` re-assigns canonical codes
    (same lengths/size; enables the fast ladder decoder)."""
    from ..core.canonical import build_tree_for_device, canonicalize
    from ..core.weights import ByteWeights

    counts = sharded_histogram(jblocks, jvalid, mesh).astype(np.int64)
    # device codewords live in u32 lanes; on (pathological) trees deeper
    # than 32 the pipeline switches to the optimal length-limited code —
    # still a valid .hff tree, marginally larger output (PARITY.md)
    tree, _limited = build_tree_for_device(ByteWeights(counts), max_len=max_code_len)
    canon_tabs = None
    full_alpha = False
    if canonical:
        from ..kernels.encode import make_canonical_encode_tables

        tree = canonicalize(tree)
        tabs = make_canonical_encode_tables(tree)
        if tabs is not None:
            canon_tabs = tabs[:4]  # arrays; max_len rides max_code_len below
            full_alpha = tabs[5]
    lens, codes = tree.encode_tables()
    # coverage guard (reference `comp.rs:427-432`): every byte seen by the
    # histogram must have a code, or the kernels would silently emit 0 bits
    # for it.  Free on host; can only trip if the tree builder misbehaves.
    uncovered = np.flatnonzero((counts > 0) & (np.asarray(lens) == 0))
    if uncovered.size:
        from ..core.format import CompressError

        raise CompressError("letter not found in codes", int(uncovered[0]))
    dl, da = make_encode_tables(lens, codes)
    words, bits = sharded_encode(jblocks, jvalid, dl, da, mesh,
                                 max_code_len=int(lens.max()),
                                 canon_tables=canon_tabs,
                                 check_missing=False,
                                 full_alphabet=full_alpha)
    return words, bits, tree
