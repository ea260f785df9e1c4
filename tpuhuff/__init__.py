"""tpuhuff — a Huffman codec framework for accelerators, in JAX.

A from-scratch JAX/XLA/Pallas + C++ re-design with the full capabilities of
the reference Rust workspace `k-xlsx/huff-encoding` (see SURVEY.md):

* :mod:`tpuhuff.core`    — letters, histograms, Huffman trees (flat arrays,
  reference-faithful construction), the bit-exact ``.hff`` container, and the
  vectorized host codec (L1-L3).
* :mod:`tpuhuff.kernels` — device kernels: histogram, bit-pack encode, and
  lane-parallel decode.
* :mod:`tpuhuff.dist`    — mesh/shard_map block-parallel pipelines, psum
  histogram merge, ordered gather (multi-device / multi-host).
* :mod:`tpuhuff.io`      — streaming two-pass file codec (`.hff` compatible),
  block-offset ``.hf2`` container for parallel decode.
* :mod:`tpuhuff.native`  — C++ runtime (threaded histogram, scalar encoder,
  DFA decoder) via ctypes, for single-stream latency and golden checks.
* :mod:`tpuhuff.cli`     — ``huff``-flag-compatible command line.

Everything in :mod:`tpuhuff.core` is importable from the top level, in the
spirit of the reference's ``prelude`` (`huff_coding/src/prelude.rs:1-23`).
"""

from .core import (  # noqa: F401
    BitString,
    ByteWeights,
    Code,
    CompressData,
    CompressError,
    CompressedDataFromBytesError,
    EmptyWeightsError,
    FromBinError,
    HuffTree,
    LetterType,
    U8, U16, U32, U64, U128, I8, I16, I32, I64, I128,
    build_weights_map,
    calc_padding_bits,
    compress,
    compress_with_tree,
    decompress,
    letter_type,
    offset_bytes,
    pack_codes_u8,
    unpack_codes_u8,
)

__version__ = "0.1.0"
