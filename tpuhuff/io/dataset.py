"""Shared-tree dataset compression — BASELINE config 4 as a product path.

The reference's unit of scale is one file with one whole-file tree reused
across its blocks (`/root/reference/huff/src/comp.rs:46-66`).  Config 4
("10 GB sharded dataset: shared frequency table broadcast, fused
histogram+encode pipeline") generalizes that to MANY files/shards:

* **Shared mode** (default): build ONE frequency table — from a sampled
  streaming pass over the dataset (or a designated ``tree_from`` file) —
  Laplace-smooth it so the alphabet is complete, broadcast the resulting
  tree, and compress every shard in a SINGLE pass at the pure encode rate.
  The per-file two-pass cost (pass 1 ~= pass 2 on device, PERF_NOTES r4)
  disappears: pass 1 is paid once per dataset, not once per file.
* **Adaptive mode** (``adaptive=True``): shard ``k``'s exact histogram is
  gathered DURING its encode — on device by the encode program's
  ``hist_data`` operand, on host by the threaded C++ count over the
  already-loaded chunk — and becomes shard ``k+1``'s
  tree.  Still single-pass per shard; the table tracks drifting data at
  zero extra passes.  Every container carries its own tree, so shards stay
  independently decodable.

Each shard becomes a standalone ``.hf2`` (or ``.hff``) file; decode side
is the ordinary per-file path (block-parallel for ``.hf2``), so a dataset
decodes shard-parallel across processes with no extra machinery.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from ..core.tree import HuffTree
from ..core.weights import ByteWeights
from .stream import _CHUNK, read_compress_write, read_compress_write_hf2

__all__ = ["build_shared_tree", "compress_dataset", "tree_from_counts"]


def tree_from_counts(counts: np.ndarray, device: bool = True,
                     canonical: bool = True, smooth: bool = True,
                     max_len: int | None = None) -> HuffTree:
    """Tree from a 256-bin count table: Laplace-smoothed (complete alphabet
    — any shard encodes exactly, the missing-letter guard can never fire),
    length-limited for the device kernels, canonical for the fast decode
    ladder.

    Device trees are limited to **16** bits by default (not the u32-lane
    32): smoothing gives rare bytes count 1, whose unconstrained codes on
    a ~100 MB shard run ~26 bits, widening the encode and decode ladders.
    Package-merge under the 16 cap costs ~nothing on those
    near-zero-probability symbols."""
    from ..core.canonical import build_tree_for_device, canonicalize

    c = np.asarray(counts, dtype=np.int64)
    if smooth:
        c = c + 1
    if device:
        ml = 16 if max_len is None else max_len
        tree, _limited = build_tree_for_device(ByteWeights(c), max_len=ml)
    else:
        tree = HuffTree.from_weights(ByteWeights(c))
    return canonicalize(tree) if canonical else tree


def build_shared_tree(
    paths: Sequence[str] | str,
    hist_sample: int = 8,
    device: bool = True,
    canonical: bool = True,
    max_bytes_per_file: int | None = None,
) -> HuffTree:
    """ONE tree for a whole dataset: streamed (sampled) histogram over
    ``paths``, smoothed so every byte value has a code.

    ``hist_sample``: count only the first ``1/hist_sample`` of each chunk
    (the same prefix-sampling fast mode as the single-file writers) —
    the table converges long before the full pass on stationary data.
    ``max_bytes_per_file`` caps the scan per file (e.g. probe only the
    first 64 MiB of each shard).  ``device=True`` length-limits codes to
    32 bits so the device kernels apply (identical trees off-device unless
    the data is pathological, PARITY.md)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    samp = max(1, int(hist_sample))
    counts = np.zeros(256, dtype=np.int64)
    for path in paths:
        left = os.path.getsize(path)
        if max_bytes_per_file is not None:
            left = min(left, max_bytes_per_file)
        with open(path, "rb") as fp:
            while left > 0:
                piece = fp.read(min(_CHUNK, left))
                if not piece:
                    break
                left -= len(piece)
                sp = piece if samp == 1 else piece[
                    : max(1, len(piece) // samp)]
                counts += np.asarray(ByteWeights.from_bytes(sp).counts,
                                     dtype=np.int64)
    return tree_from_counts(counts, device=device, canonical=canonical)


def _dst_paths(srcs: Sequence[str], dsts, out_dir, ext: str) -> list:
    if dsts is not None:
        if len(dsts) != len(srcs):
            raise ValueError(
                f"dsts has {len(dsts)} entries for {len(srcs)} sources")
        return list(dsts)
    base = out_dir if out_dir is not None else "."
    os.makedirs(base, exist_ok=True)
    return [os.path.join(base, os.path.basename(s) + "." + ext)
            for s in srcs]


def compress_dataset(
    srcs: Iterable[str],
    out_dir: str | None = None,
    dsts: Sequence[str] | None = None,
    tree: HuffTree | None = None,
    tree_from: Sequence[str] | str | None = None,
    hist_sample: int = 8,
    adaptive: bool = False,
    device: bool = False,
    hf2: bool = True,
    block_len: int | None = None,
    check: bool = True,
    canonical: bool = True,
    stats: dict | None = None,
) -> list:
    """Compress many files/shards under ONE broadcast frequency table
    (config 4).  Returns the list of output paths.

    Tree resolution order: ``tree`` (explicit) > ``tree_from`` (build the
    table from those files) > a sampled pass over ``srcs`` themselves.
    Shared mode then single-pass-encodes every shard with that tree
    (``read_compress_write_hf2(tree=...)``); ``adaptive=True`` instead
    refreshes the table per shard from the histogram gathered DURING the
    previous shard's encode (the encode program's ``hist_data`` operand).

    ``stats`` (optional dict) receives ``tree_builds`` (how many trees
    were constructed), ``bytes`` and ``ratio``.
    """
    srcs = [os.fspath(s) for s in srcs]
    if not srcs:
        return []
    if adaptive and not hf2:
        raise ValueError("adaptive refresh requires the .hf2 writer "
                         "(the .hff path gathers no encode-time histogram)")
    ext = "hf2" if hf2 else "hff"
    outs = _dst_paths(srcs, dsts, out_dir, ext)
    tree_builds = 0
    if tree is None:
        seed = tree_from if tree_from is not None else (
            # adaptive needs only a seed table for shard 0: sample it
            # rather than scanning the whole dataset
            srcs[:1] if adaptive else srcs)
        tree = build_shared_tree(seed, hist_sample=hist_sample,
                                 device=device, canonical=canonical)
        tree_builds += 1
    total_in = total_out = 0
    for k, (src, dst) in enumerate(zip(srcs, outs)):
        if hf2:
            # the last shard's histogram would build a tree nothing uses
            refresh = adaptive and k + 1 < len(srcs)
            hist = read_compress_write_hf2(
                src, dst, block_len=block_len, device=device,
                canonical=canonical, check=check, tree=tree,
                collect_hist=refresh,
            )
            if refresh and hist is not None:
                tree = tree_from_counts(hist, device=device,
                                        canonical=canonical)
                tree_builds += 1
        else:
            read_compress_write(src, dst, tree=tree, device=device)
        total_in += os.path.getsize(src)
        total_out += os.path.getsize(dst)
    if stats is not None:
        stats["tree_builds"] = tree_builds
        stats["bytes"] = total_in
        stats["ratio"] = total_out / max(total_in, 1)
    return outs


def decompress_dataset(
    srcs: Iterable[str],
    out_dir: str | None = None,
    dsts: Sequence[str] | None = None,
    device: bool = False,
    threads: int | None = None,
    check: bool = True,
) -> list:
    """Decode a dataset's shards (the inverse of :func:`compress_dataset`).

    Each shard is independent — every container carries its own tree and
    block index — so this is a plain ordered map of the per-file decoder;
    across processes, shard-parallelism is just "each process takes its
    slice of the list" (no collective state).  Output names strip the
    container extension (``x.bin.hf2 -> x.bin``)."""
    from .stream import read_decompress_write, read_decompress_write_hf2

    srcs = [os.fspath(s) for s in srcs]
    if dsts is None:
        base = out_dir if out_dir is not None else "."
        os.makedirs(base, exist_ok=True)
        dsts = []
        for s in srcs:
            name = os.path.basename(s)
            root, ext = os.path.splitext(name)
            dsts.append(os.path.join(base,
                                     root if ext in (".hf2", ".hff")
                                     else name + ".dec"))
    elif len(list(dsts)) != len(srcs):
        raise ValueError(
            f"dsts has {len(list(dsts))} entries for {len(srcs)} sources")
    for src, dst in zip(srcs, dsts):
        if src.endswith(".hff"):
            read_decompress_write(src, dst)
        else:
            read_decompress_write_hf2(src, dst, threads=threads,
                                      device=device, check=check)
    return list(dsts)
