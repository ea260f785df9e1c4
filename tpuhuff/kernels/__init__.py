"""Device kernels: histogram, bit-pack encode, decode.

Each operation has one device route, picked from H100 measurements
(PERF.md): the nibble one-hot matrix product for the histogram, the XLA
doubling merge for encode (canonical rank ladder or ``jnp.take`` lookup by
the tree's shape), and the XLA gather-window scan for decode (canonical
ladder or interval search by the tree's shape).  The same program runs on
every platform.
"""

from .encode import (
    block_bit_lengths,
    count_missing,
    encode_blocks,
    make_encode_tables,
    words_to_payload,
)
from .histogram import histogram

__all__ = [
    "block_bit_lengths",
    "count_missing",
    "encode_blocks",
    "make_encode_tables",
    "words_to_payload",
    "histogram",
]
