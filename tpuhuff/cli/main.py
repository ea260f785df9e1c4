"""CLI: compress/decompress SRC_FILE into DST_FILE.hff (compress by default).

Flag-for-flag compatible with the reference ``huff`` binary
(`/root/reference/huff/res/cli.yml:1-39`, `huff/src/cli.rs:132-162`):

* ``-d/--decompress`` ``-t/--time`` ``-r/--replace`` ``-n/--noask``
* ``-b/--block-size SIZE`` with K/M/G and Ki/Mi/Gi suffixes (default 2G)
* ``SRC_FILE`` positional; ``DST_FILE`` defaults to ``./SRC_FILE.hff``
* path rules: compress appends ``.hff`` to the destination
  (`cli.rs:40-54`); decompress requires the ``.hff`` extension and strips
  it when no destination is given (`cli.rs:55-76`)
* interactive overwrite prompt unless ``-n`` (`cli.rs:116-130`)

tpuhuff extensions: ``--hf2`` (block-indexed container, parallel decode),
``--device`` (route packing through the JAX device kernels), ``--stats``
(ratio/GB/s/block count — SURVEY §5 observability), ``--threads``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

__all__ = ["main", "parse_block_size", "CliError"]

EXTENSION = "hff"
EXTENSION2 = "hf2"


class CliError(ValueError):
    def __init__(self, message: str, kind: str = "InvalidInput"):
        super().__init__(message)
        self.kind = kind


def parse_block_size(text: str) -> int:
    """K/M/G + Ki/Mi/Gi suffix parser (`huff/src/cli.rs:79-114`)."""
    lowered = text.lower()
    num = ""
    i = 0
    while i < len(lowered) and lowered[i].isdigit():
        num += lowered[i]
        i += 1
    mult_str = lowered[i:]
    try:
        value = int(num)
    except ValueError:
        raise CliError("Invalid block size")
    if value == 0:
        raise CliError("Invalid block size")
    mults = {
        "": 1,
        "k": 1_000, "m": 1_000_000, "g": 1_000_000_000,
        "ki": 1024, "mi": 1_048_576, "gi": 1_073_741_824,
    }
    if mult_str not in mults:
        raise CliError("Invalid block size")
    return value * mults[mult_str]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="huff",
        description="Compress/decompress SRC_FILE into DST_FILE.hff "
        "(compress by default)",
    )
    p.add_argument("-d", "--decompress", action="store_true",
                   help="Decompresses the hff SRC_FILE into DST_FILE")
    p.add_argument("-t", "--time", action="store_true",
                   help="Prints how long it took to finish")
    p.add_argument("-r", "--replace", action="store_true",
                   help="Deletes SRC_FILE upon completion")
    p.add_argument("-n", "--noask", action="store_true",
                   help="Omits asking if existing DST_FILE should be replaced")
    p.add_argument("-b", "--block-size", default="2G", metavar="SIZE",
                   help="Set how many bytes can be loaded from the file at "
                   "one time (units: K/Ki M/Mi G/Gi; default 2G)")
    p.add_argument("--hf2", action="store_true",
                   help="Use the block-indexed .hf2 container "
                   "(enables parallel/device decode)")
    p.add_argument("--hf2-block", default=None, metavar="SIZE",
                   help="Input bytes per .hf2 block (units as -b; default: "
                   "256 with --device, 64Ki on host)")
    p.add_argument("--max-code-len", type=int, default=None, metavar="L",
                   help="Length-limit codes to L bits (optimal "
                   "package-merge).  L=12 on text-like data costs ~0.6%% "
                   "ratio and buys ~4%% device encode + tighter decode "
                   "scan bounds")
    p.add_argument("--hist-sample", type=int, default=1, metavar="N",
                   help="Fast mode: histogram only 1/N of each chunk in "
                   "pass 1 (Laplace-smoothed tree; output stays exactly "
                   "decodable, ratio typically <1%% worse)")
    p.add_argument("--device", action="store_true",
                   help="Route block packing and .hf2 decode through the "
                   "JAX device kernels")
    p.add_argument("--reindex", action="store_true",
                   help="Re-index an existing .hff into .hf2 without "
                   "recompressing (enables parallel/device decode)")
    p.add_argument("--no-auto-index", action="store_true",
                   help="Disable the automatic block-index sidecar for "
                   "large .hff decodes (see io.stream.AUTO_INDEX_MIN)")
    p.add_argument("--no-check", action="store_true",
                   help="Skip the .hf2 per-block CRC32 integrity column "
                   "(write) / its verification (read)")
    p.add_argument("--tree-from", default=None, metavar="FILE",
                   help="Build the frequency table from FILE (sampled) and "
                   "compress SRC single-pass with that shared tree "
                   "(config 4)")
    p.add_argument("--dataset", nargs="+", default=None, metavar="SRC",
                   help="Compress many files under ONE shared frequency "
                   "table (single-pass each; see --tree-from/--adaptive/"
                   "--out-dir)")
    p.add_argument("--out-dir", default=None, metavar="DIR",
                   help="Output directory for --dataset (default: .)")
    p.add_argument("--adaptive", action="store_true",
                   help="With --dataset: refresh the table per shard from "
                   "the histogram gathered during the previous shard's "
                   "encode (fused histogram+encode pipeline)")
    p.add_argument("--threads", type=int, default=None,
                   help="Host decode/stitch threads (default: all cores)")
    p.add_argument("--stats", action="store_true",
                   help="Print ratio / throughput / block count")
    p.add_argument("--profile", nargs="?", const="", default=None,
                   metavar="TRACE_DIR",
                   help="Print per-stage timings; with TRACE_DIR also write "
                   "a jax profiler trace there")
    p.add_argument("--warmup", action="store_true",
                   help="One-time device warmup: build the native library "
                   "and compile the device programs at the default shapes "
                   "into the persistent cache (later --device runs skip "
                   "the compile)")
    p.add_argument("SRC_FILE", nargs="?", default=None)
    p.add_argument("DST_FILE", nargs="?", default="./SRC_FILE.hff")
    return p


def _warmup() -> int:
    """``python -m tpuhuff --warmup``: build the native library and compile
    the device programs at their default shapes into the persistent cache,
    once, up front.  Any failing step fails the command."""
    import numpy as np

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"  {label}: ok ({time.perf_counter() - t0:.1f}s)")
        return out

    print("tpuhuff warmup:")
    from .. import native

    def build():
        if not native.available():
            raise RuntimeError("native library build failed (g++ missing?)")

    step("native library build", build)
    from ..cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    print(f"  backend: {jax.default_backend()}")

    def roundtrip():
        import tempfile

        from ..io.stream import (
            read_compress_write_hf2, read_decompress_write_hf2,
        )

        rng = np.random.default_rng(42)
        text = (b"warmup corpus for the default device program shapes " * 4096)
        data = bytearray((text * (((8 << 20) // len(text)) + 1))[: 8 << 20])
        idx = rng.integers(0, len(data), len(data) // 64)
        for i in idx:
            data[int(i)] = int(rng.integers(0, 256))
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "w.bin")
            with open(src, "wb") as f:
                f.write(bytes(data))
            read_compress_write_hf2(src, os.path.join(td, "w.hf2"),
                                    device=True)
            read_decompress_write_hf2(os.path.join(td, "w.hf2"),
                                      os.path.join(td, "w.out"),
                                      device=True)
            with open(os.path.join(td, "w.out"), "rb") as f:
                if f.read() != bytes(data):
                    raise RuntimeError("device .hf2 roundtrip mismatch")

    step("device .hf2 roundtrip (8 MiB, real writer/reader programs)",
         roundtrip)

    def big_shapes():
        # the multi-chunk writers pad every chunk to the full 64 MiB step
        # shape; compile that program WITHOUT uploading 64 MiB (AOT lower)
        from ..core.canonical import canonicalize
        from ..core.tree import HuffTree
        from ..core.weights import ByteWeights
        from ..io.stream import DEVICE_HF2_BLOCK, _CHUNK
        from ..kernels.encode import (
            encode_blocks, make_canonical_encode_tables, make_encode_tables,
        )

        text = (b"warmup corpus for the default device program shapes " * 1024)
        tree = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(
            bytes(text))))
        lens_t, codes_t = tree.encode_tables()
        dl, da = make_encode_tables(lens_t, codes_t)
        tabs = make_canonical_encode_tables(tree)
        rows = _CHUNK // DEVICE_HF2_BLOCK
        a = jax.ShapeDtypeStruct((rows, DEVICE_HF2_BLOCK), jnp.uint8)
        v = jax.ShapeDtypeStruct((rows,), jnp.int32)
        encode_blocks.lower(
            a, dl, da, v, max_code_len=int(lens_t.max()),
            canon_tables=tabs[:4], full_alphabet=bool(tabs[5]),
            with_miss=True).compile()

    step("64 MiB-chunk encode program (AOT, no upload)", big_shapes)
    print("warmup complete — cached programs persist in the compile cache; "
          "a different tree's max code length still costs one small "
          "program compile")
    return 0


def _resolve_paths(args, ext: str):
    """Path munging per `huff/src/cli.rs:24-77`."""
    src = args.SRC_FILE
    dst = args.DST_FILE
    if dst == "./SRC_FILE.hff":  # the literal default marker (cli.yml:39)
        dst = os.path.join(".", os.path.basename(src))
    if os.path.isdir(src):
        raise CliError(f"{src!r} is a directory", "NotFile")
    if args.decompress:
        src_ext = os.path.splitext(src)[1].lstrip(".")
        if src_ext != ext:
            raise CliError(
                f"Unrecognized file format, expected {ext}", "UnrecognizedFormat"
            )
        if os.path.abspath(dst) == os.path.abspath(os.path.join(".", src)):
            dst = os.path.splitext(dst)[0]
        if os.path.isdir(dst):
            raise CliError(f"Destination {dst!r} is a directory", "NotFile")
    else:
        dst = dst + "." + ext
    return src, dst


def _ask_replace(path: str, noask: bool) -> bool:
    """Overwrite prompt (`huff/src/cli.rs:116-130`); True = proceed."""
    if os.path.exists(path) and not noask:
        sys.stdout.write(
            f"{path!r} already exists, do you want to replace it? [Y/N]: "
        )
        sys.stdout.flush()
        answer = sys.stdin.readline()
        if not answer.lower().startswith("y"):
            return False
        print()
    return True


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    start = time.perf_counter()
    try:
        block_size = parse_block_size(args.block_size)
        if args.warmup:
            try:
                return _warmup()
            except Exception as e:  # noqa: BLE001 — report, then fail
                print(f"Error: warmup failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
                return 1
        if args.dataset is not None:
            # config 4: shared-tree (or adaptive) dataset compression
            if args.decompress:
                raise CliError("--dataset is a compression mode; decode "
                               "each shard with -d", "InvalidInput")
            for s in args.dataset:
                if not os.path.exists(s):
                    raise CliError(f"{s!r}: no such file", "Io")
                if os.path.isdir(s):
                    raise CliError(f"{s!r} is a directory", "NotFile")
            if args.device:
                from ..cache import enable_compile_cache

                enable_compile_cache()
            from ..io.dataset import compress_dataset

            hf2_block = (parse_block_size(args.hf2_block)
                         if args.hf2_block else None)
            dstats: dict = {}
            # table-build sampling defaults to 8 for datasets (the tree
            # converges long before a full pass; --hist-sample overrides)
            samp = args.hist_sample if args.hist_sample != 1 else 8
            outs = compress_dataset(
                args.dataset, out_dir=args.out_dir,
                tree_from=args.tree_from, hist_sample=samp,
                adaptive=args.adaptive, device=args.device,
                hf2=True,  # dataset shards always get the indexed container
                block_len=hf2_block, check=not args.no_check,
                stats=dstats,
            )
            if args.replace:
                for s in args.dataset:
                    os.remove(s)
            if args.stats:
                print(f"{len(outs)} shards, {dstats['bytes']} bytes, "
                      f"ratio {dstats['ratio']:.4f}, "
                      f"{dstats['tree_builds']} tree build(s), "
                      f"{dstats['bytes'] / max(time.perf_counter() - start, 1e-9) / 1e9:.3f} GB/s")
            if args.time:
                print(f"{time.perf_counter() - start:.6f}s")
            return 0
        if args.SRC_FILE is None:
            raise CliError("SRC_FILE is required", "InvalidInput")
        if args.reindex:
            src = args.SRC_FILE
            if os.path.splitext(src)[1].lstrip(".") != EXTENSION:
                raise CliError(
                    f"Unrecognized file format, expected {EXTENSION}",
                    "UnrecognizedFormat",
                )
            dst = args.DST_FILE
            if dst == "./SRC_FILE.hff":
                dst = os.path.splitext(os.path.join(
                    ".", os.path.basename(src)))[0] + "." + EXTENSION2
            if not os.path.exists(src):
                raise CliError(f"{src!r}: no such file", "Io")
            if not _ask_replace(dst, args.noask):
                return 0
            from ..io import transcode_hff_to_hf2

            hf2_block = (parse_block_size(args.hf2_block)
                         if args.hf2_block else 65536)
            transcode_hff_to_hf2(src, dst, block_len=hf2_block)
            if args.replace:
                os.remove(src)
            if args.time:
                print(f"{time.perf_counter() - start:.6f}s")
            return 0
        ext = EXTENSION2 if args.hf2 else EXTENSION
        src, dst = _resolve_paths(args, ext)
        if not os.path.exists(src):
            raise CliError(f"{src!r}: no such file", "Io")
        src_size = os.path.getsize(src)
        if not _ask_replace(dst, args.noask):
            return 0
        if args.device:
            from ..cache import enable_compile_cache

            enable_compile_cache()
        from ..io import stream
        from ..profiling import StageTimer, device_trace

        timer = StageTimer() if args.profile is not None else None
        stats: dict = {}
        with device_trace(args.profile or None):
            if args.decompress:
                if args.hf2:
                    stream.read_decompress_write_hf2(src, dst,
                                                     threads=args.threads,
                                                     device=args.device,
                                                     stats=stats,
                                                     check=not args.no_check)
                else:
                    stream.read_decompress_write(
                        src, dst, block_size,
                        auto_index=False if args.no_auto_index else None,
                        stats=stats)
                    act = stats.get("auto_index")
                    if act == "created":
                        print(f"indexed {src!r} -> sidecar "
                              f"'{src}.hf2x' (block-parallel decode; "
                              f"reused on later decodes)")
                    elif act == "reused":
                        print(f"using block-index sidecar '{src}.hf2x'")
            else:
                tree = None
                if args.tree_from:
                    # config 4 single-file form: shared table from another
                    # file -> pass 1 skipped, single-pass compress
                    from ..io.dataset import build_shared_tree

                    tree = build_shared_tree(
                        args.tree_from, device=args.device,
                        hist_sample=(args.hist_sample
                                     if args.hist_sample != 1 else 8))
                if args.hf2:
                    hf2_block = (parse_block_size(args.hf2_block)
                                 if args.hf2_block else None)
                    stream.read_compress_write_hf2(
                        src, dst, block_len=hf2_block, device=args.device,
                        stats=stats, hist_sample=args.hist_sample,
                        check=not args.no_check, tree=tree,
                        max_code_len=args.max_code_len)
                else:
                    stream.read_compress_write(src, dst, block_size,
                                               device=args.device,
                                               timer=timer, stats=stats,
                                               hist_sample=args.hist_sample,
                                               tree=tree,
                                               max_code_len=args.max_code_len)
        if timer is not None:
            print(timer.report())
        if args.device:
            # first-use compile stall remedy: estimate the
            # JIT share of the first device call and point at --warmup
            calls = stats.get("device_call_s", [])
            jit_s = 0.0
            if len(calls) >= 2:
                rest = sorted(calls[1:])
                jit_s = max(0.0, calls[0] - rest[len(rest) // 2])
            elif len(calls) == 1:
                jit_s = calls[0]
            if jit_s > 5.0:
                print(f"hint: ~{jit_s:.0f}s of this run was one-time kernel "
                      "compilation; run `python -m tpuhuff --warmup` once "
                      "to pre-compile into the persistent cache",
                      file=sys.stderr)
        if args.replace:
            os.remove(src)
    except (CliError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - start
    if args.stats:
        # src_size was captured before -r/--replace deleted the source
        in_size = src_size
        out_size = os.path.getsize(dst)
        big = max(in_size, out_size)
        line = (
            f"{in_size} -> {out_size} bytes "
            f"(ratio {out_size / max(in_size, 1):.4f}), "
            f"{big / max(elapsed, 1e-9) / 1e9:.3f} GB/s, "
            f"block size {block_size}"
        )
        # cold --device runs spend most of the wall clock in one-time JIT
        # compilation; estimate it from the first device call's excess over
        # the steady-state calls and report throughput excluding it
        calls = stats.get("device_call_s", []) if args.device else []
        if len(calls) >= 2:
            rest = sorted(calls[1:])
            steady = rest[len(rest) // 2]
            compile_s = max(0.0, calls[0] - steady)
            if compile_s > 0.5:
                warm = big / max(elapsed - compile_s, 1e-9) / 1e9
                line += (f" [{warm:.3f} GB/s excl ~{compile_s:.1f}s JIT "
                         f"compile]")
        elif len(calls) == 1 and elapsed > 1.0:
            line += (" [single device call: figure includes any JIT compile;"
                     " repeat runs hit the persistent cache]")
        print(line)
    if args.time:
        print(f"{elapsed:.6f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
