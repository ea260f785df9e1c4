"""Device histogram: 256-bin byte counts as one small matrix product.

The data-parallel replacement for the reference's thread-per-chunk
histogram (`huff_coding/src/weights.rs:293-319`), in the
**nibble outer-product** form:

    byte = hi4 * 16 + lo4
    hist[hi, lo] = sum_i onehot16(hi_i)[hi] * onehot16(lo_i)[lo]
    =>  hist(16,16) = onehot16(hi).T @ onehot16(lo)

One contraction over the data axis produces the whole 256-bin table from
2x16 compares per byte.  On the H100 it counts 64 MiB in 2.5 ms against
16.7 ms for ``jnp.bincount``, whose scatter-add serializes on 256 hot
addresses (PERF.md), so it is the only route.

Exactness: the one-hot operands are 0/1 in bfloat16 (exact), the product
accumulates in float32 (``preferred_element_type``), and every matrix
product covers at most ``_CHUNK`` = 2^22 < 2^24 bytes, so each partial
count is an integer float32 holds exactly; chunks are summed in int32.
bfloat16 operands also keep the product off TF32.

Cross-device merge is a plain ``psum`` over the mesh axis
(:mod:`tpuhuff.dist`) — the collective analogue of the reference's
``add_byte_weights`` join (`weights.rs:308-318`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["histogram"]

# keep per-matmul counts < 2^24 for exact f32 accumulation
_CHUNK = 1 << 22


def _hist_chunk(chunk: jnp.ndarray) -> jnp.ndarray:
    """(n,) uint8, n <= ``_CHUNK`` -> (256,) int32 via the nibble product."""
    hi = (chunk >> 4).astype(jnp.int32)
    lo = (chunk & 15).astype(jnp.int32)
    iota = jnp.arange(16, dtype=jnp.int32)
    oh_hi = (hi[:, None] == iota[None, :]).astype(jnp.bfloat16)
    oh_lo = (lo[:, None] == iota[None, :]).astype(jnp.bfloat16)
    h = jnp.dot(oh_hi.T, oh_lo, preferred_element_type=jnp.float32)
    return h.reshape(256).astype(jnp.int32)


@jax.jit
def histogram(data: jnp.ndarray) -> jnp.ndarray:
    """(..., n) uint8 -> (256,) int32 histogram over all elements."""
    flat = data.reshape(-1)
    n = flat.shape[0]
    if n <= _CHUNK:
        return _hist_chunk(flat)
    # pad to a whole number of chunks with byte 0, then subtract the padding
    n_chunks = (n + _CHUNK - 1) // _CHUNK
    padded = jnp.pad(flat, (0, n_chunks * _CHUNK - n))
    hists = jax.vmap(_hist_chunk)(padded.reshape(n_chunks, _CHUNK))
    total = jnp.sum(hists, axis=0)
    return total.at[0].add(-(n_chunks * _CHUNK - n))
