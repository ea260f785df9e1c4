"""Benchmark: device encode and decode through the product dispatch, plus the
file-to-file paths, on the attached GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}.
``device`` names the platform, device kind, count and the card's name and
power limit; a number is never reported without it.  Every row checks its
output bit-exactly (SHA-256 against the host C++ encoder, decoded bytes
against the input); a row that cannot run fails the whole run.

Rows (config 2 of BASELINE.md: text-like data, 64 KiB container blocks):

* encode — ``encode_blocks`` over device-resident 256-byte lanes, as the
  ``.hf2`` writer calls it (canonical ladder, valid lengths, missing-letter
  count in the same program); block bit lengths are lane sums, so this is
  the 64 KiB-block encode;
* two-pass — the device histogram plus the encode;
* dataset shared / adaptive — the shared-tree single pass, and the same with
  the next table's histogram riding the encode (``hist_data``);
* decode — ``decode_blocks_device`` (the one decode route) on
  device-resident word rows at the ``.hf2`` device block (256 B), canonical
  and foreign trees;
* files — the ``.hf2``/``.hff`` writers and readers, host and device.

Device times are medians of ``BENCH_REPS`` calls, each ending in
``block_until_ready``, after one warm-up call that compiles.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

DATA_MB = int(os.environ.get("BENCH_MB", "100"))  # config-2 spec size
CONTAINER_BLOCK = 64 << 10  # config 2
LANE = 256  # encode lane (the .hf2 device block)
DEC_BLOCK = 256  # .hf2 device default block
REPS = int(os.environ.get("BENCH_REPS", "5"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_textlike(n: int, seed: int = 42) -> np.ndarray:
    """Config-2 text-like bytes: repeated English/XML text with 1/64 of the
    bytes replaced by uniform random bytes (full 256-letter alphabet)."""
    rng = np.random.default_rng(seed)
    text = (
        b"the of and to in a is that it was for on are as with his they at "
        b"<page><title>Benchmark</title><revision><text xml:space=\"preserve\">"
        b"In information theory, a Huffman code is a particular type of optimal "
        b"prefix code that is commonly used for lossless data compression. "
    )
    base = np.frombuffer(text * (n // len(text) + 1), dtype=np.uint8)[:n].copy()
    idx = rng.integers(0, n, n // 64)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


def card_name_and_power() -> str:
    """``name, power.limit`` of the first card, read by ``nvidia-smi``."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def timed(fn, *args):
    """(first-call seconds, median seconds of REPS calls)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def main() -> None:
    from tpuhuff.cache import cache_dir, enable_compile_cache

    cdir = cache_dir()
    n_cached = len(os.listdir(cdir)) if os.path.isdir(cdir) else 0
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_name_and_power()}
    log(f"device: {device}")

    from tpuhuff import native
    from tpuhuff.core.canonical import build_tree_for_device, canonicalize
    from tpuhuff.core.tree import HuffTree
    from tpuhuff.core.weights import ByteWeights
    from tpuhuff.dist import stitch_words
    from tpuhuff.io.dataset import tree_from_counts
    from tpuhuff.kernels.decode import (
        decode_blocks_device, make_decode_tables, payload_to_lane_words,
    )
    from tpuhuff.kernels.encode import (
        encode_blocks, make_canonical_encode_tables, make_encode_tables,
    )
    from tpuhuff.kernels.histogram import histogram

    if not native.available():
        raise RuntimeError("native library unavailable (needs g++)")
    n = DATA_MB << 20
    data = make_textlike(n)
    counts = np.bincount(data, minlength=256)
    B = n // LANE
    jlanes = jax.device_put(jnp.asarray(data.reshape(B, LANE)), dev)
    jvalid = jnp.full(B, LANE, jnp.int32)
    extra = {"workload": f"{DATA_MB} MiB textlike, block {CONTAINER_BLOCK}, "
                         f"lane {LANE}",
             "cache_state": f"warm({n_cached})" if n_cached else "cold"}

    def encoder(tree, with_hist=False, two_pass=False):
        lens, codes = tree.encode_tables()
        dl, da = make_encode_tables(lens, codes)
        tabs = make_canonical_encode_tables(tree)
        assert tabs is not None, "writers canonicalize their trees"

        @jax.jit
        def run(lanes, valid):
            out = encode_blocks(lanes, dl, da, valid,
                                max_code_len=int(lens.max()),
                                canon_tables=tabs[:4],
                                full_alphabet=bool(tabs[5]), with_miss=True,
                                hist_data=lanes if with_hist else None)
            if two_pass:
                out = out + (histogram(lanes),)
            return out
        return run, lens, codes

    def check_encode(out, lens, codes, label):
        words, bits, miss = out[:3]
        if int(miss):
            raise AssertionError(f"{label}: missing letters")
        payload, _ = stitch_words(np.asarray(words),
                                  np.asarray(bits).astype(np.uint64))
        ref, _ = native.encode(data, lens, codes)
        if hashlib.sha256(payload).digest() != hashlib.sha256(ref).digest():
            raise AssertionError(f"{label}: payload SHA differs from host C++")

    def encode_row(label, tree, **kw):
        run, lens, codes = encoder(tree, **kw)
        first, med = timed(run, jlanes, jvalid)
        out = run(jlanes, jvalid)
        check_encode(out, lens, codes, label)
        if len(out) > 3 and not np.array_equal(np.asarray(out[3]), counts):
            raise AssertionError(f"{label}: histogram differs from bincount")
        gbps = n / med / 1e9
        log(f"{label}: {med * 1e3:.3f} ms -> {gbps:.3f} GB/s "
            f"(first call {first:.2f} s)")
        extra[f"{label}_gbps"] = gbps
        extra[f"{label}_first_s"] = first
        return gbps

    tree, _ = build_tree_for_device(ByteWeights(counts), max_len=32)
    tree = canonicalize(tree)
    enc_gbps = encode_row("encode", tree)
    encode_row("two_pass", tree, two_pass=True)
    stree = tree_from_counts(counts, device=True)
    encode_row("dataset_shared", stree)
    encode_row("dataset_adaptive", stree, with_hist=True)
    extra["max_code_len"] = int(tree.encode_tables()[0].max())

    def decode_row(label, dtree):
        lens, codes = dtree.encode_tables()
        payload, _, bit_lens = native.encode_blocks_host(data, DEC_BLOCK,
                                                         lens, codes)
        ends = np.cumsum(bit_lens.astype(np.int64))
        starts = ends - bit_lens.astype(np.int64)
        rows, bit0 = payload_to_lane_words(payload, starts, ends, DEC_BLOCK)
        tables, statics = make_decode_tables(dtree)
        args = [jax.device_put(jnp.asarray(a), dev) for a in
                (rows, bit0, (ends - starts).astype(np.int32))]
        run = jax.jit(lambda r, b, nb: decode_blocks_device(
            r, b, nb, *tables, block_len=DEC_BLOCK, **statics))
        first, med = timed(run, *args)
        if not np.array_equal(np.asarray(run(*args)).reshape(-1)[:n], data):
            raise AssertionError(f"{label}: decoded bytes differ from input")
        gbps = n / med / 1e9
        log(f"{label}: {med * 1e3:.3f} ms -> {gbps:.3f} GB/s "
            f"(first call {first:.2f} s, canonical {statics['canonical']})")
        extra[f"{label}_gbps"] = gbps
        extra[f"{label}_first_s"] = first

    decode_row("decode", tree)
    decode_row("decode_foreign", HuffTree.from_weights(ByteWeights(counts)))

    bench_files(extra)

    print(json.dumps({
        "metric": "encode_throughput_1card",
        "value": enc_gbps,
        "unit": "GB/s",
        "device": device,
        "extra": extra,
    }))


def bench_files(extra: dict) -> None:
    """File-to-file GB/s on the product paths, each checked byte-exactly:
    host and device ``.hf2``, host ``.hff`` (first decode builds the block
    index sidecar, the second reuses it), and a 4-shard shared-tree dataset.
    """
    from tpuhuff.io.dataset import compress_dataset
    from tpuhuff.io.stream import (
        read_compress_write, read_compress_write_hf2,
        read_decompress_write, read_decompress_write_hf2,
    )

    fmb = int(os.environ.get("BENCH_FILE_MB", "128"))
    n = fmb << 20
    data = make_textlike(n)
    raw = data.tobytes()

    def rate(label, fn, *a, check=None, **kw):
        t0 = time.perf_counter()
        fn(*a, **kw)
        dt = time.perf_counter() - t0
        if check is not None:
            with open(check, "rb") as f:
                if f.read() != raw:
                    raise AssertionError(f"{label}: roundtrip mismatch")
        extra[label] = n / dt / 1e9
        log(f"{label}: {extra[label]:.3f} GB/s ({fmb} MiB)")

    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "src.bin")
        with open(src, "wb") as f:
            f.write(raw)
        hf2, out = os.path.join(td, "a.hf2"), os.path.join(td, "a.out")
        rate("file_compress_gbps", read_compress_write_hf2, src, hf2)
        extra["file_ratio"] = os.path.getsize(hf2) / n
        rate("file_decompress_gbps", read_decompress_write_hf2, hf2, out,
             check=out)
        dhf2 = os.path.join(td, "d.hf2")
        # the first device run compiles; the second is the steady state
        rate("file_device_compress_first_gbps", read_compress_write_hf2,
             src, dhf2, device=True)
        rate("file_device_compress_gbps", read_compress_write_hf2, src, dhf2,
             device=True)
        rate("file_device_decompress_first_gbps", read_decompress_write_hf2,
             dhf2, out, device=True, check=out)
        rate("file_device_decompress_gbps", read_decompress_write_hf2, dhf2,
             out, device=True, check=out)
        hff, out1 = os.path.join(td, "a.hff"), os.path.join(td, "b.out")
        rate("file_compress_hff_gbps", read_compress_write, src, hff)
        rate("file_decompress_hff_gbps", read_decompress_write, hff, out1,
             check=out1)
        rate("file_decompress_hff_indexed_gbps", read_decompress_write, hff,
             out1, check=out1)
        shard_mb = max(fmb // 4, 1)
        shards = []
        for k in range(4):
            p = os.path.join(td, f"shard{k}.bin")
            with open(p, "wb") as f:
                f.write(raw[k * (shard_mb << 20):(k + 1) * (shard_mb << 20)])
            shards.append(p)
        dstats: dict = {}
        t0 = time.perf_counter()
        outs = compress_dataset(shards, out_dir=os.path.join(td, "ds"),
                                stats=dstats)
        extra["file_dataset_gbps"] = (dstats["bytes"]
                                      / (time.perf_counter() - t0) / 1e9)
        extra["file_dataset_ratio"] = dstats["ratio"]
        ver = os.path.join(td, "ds.ver")
        read_decompress_write_hf2(outs[2], ver)
        with open(ver, "rb") as f, open(shards[2], "rb") as g:
            if f.read() != g.read():
                raise AssertionError("dataset shard roundtrip mismatch")


if __name__ == "__main__":
    main()
