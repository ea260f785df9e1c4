#!/usr/bin/env python3
"""Smoke test of tpuhuff on an NVIDIA GPU: the main paths, end to end.

    python chip_smoke.py [--seed S] [--mib 256]     # one card
    python chip_smoke.py --cards 4 [--seed S]       # the 4-card dist/ path

One process drives the card.  The default run:

1. checks that JAX's first device is a GPU (no CPU fallback) and prints the
   card's name and power limit, read by ``nvidia-smi`` in a child process;
2. compiles the encode program for a 64 MiB chunk, the decode program and the
   histogram at real widths, prints ``memory_analysis()`` for each, and runs
   each once against its plain reference (host C++ encode by SHA-256, the
   input bytes, ``np.bincount``);
3. builds a config-2 text file of ``--mib`` MiB + 12,345 bytes from
   ``--seed``, with one 16 MiB high-entropy region;
4. ``.hf2``: ``--hf2 --device`` must be byte-identical to the host ``.hf2``
   at the same block length, and ``-d --hf2 --device`` must restore the input;
5. ``.hff``: ``--device`` must be byte-identical to the host ``.hff``, and
   decode to the input;
6. a host ``.hff`` (non-canonical, reference-shaped tree) is ``--reindex``ed
   and decoded with ``--device`` (the interval-search decode);
7. ``--dataset --device --adaptive`` over three 64 MiB shards, each decoded
   back and compared;
8. the library golden ``compress(b"abbccc")``.

The CLI runs in-process (``tpuhuff.cli.main.main``).  Every check is exact;
a failing phase raises and the script exits non-zero.  Each timed step
prints its wall time and GB/s, labelled cold (first run, compiles) or warm,
with the card.  These are smoke numbers, not benchmark results.  The last
line of standard output is one JSON object naming the device.

``--cards 4`` runs only the multi-card path over a 4-device mesh: a 1 GiB
mixed corpus (BASELINE config 3) through ``tpuhuff.dist`` — psum histogram
against ``np.bincount``, stitched payload against the host C++ encoder by
SHA-256, sharded decode against the input.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np

MIB = 1 << 20
CHUNK_ROWS = (64 * MIB) // 256  # the writers' 64 MiB chunk at block 256
GOLDEN = "370000000498e61310bc00"  # reference doctest, comp.rs:218-262


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def card_name_and_power() -> str:
    """``name, power.limit`` of the first card, from a child process that
    does not import JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(16 * MIB), b""):
            h.update(piece)
    return h.hexdigest()


class Smoke:
    """Runs and times the steps of one smoke run."""

    def __init__(self, workdir: str, card: str):
        self.workdir = workdir
        self.card = card

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def report(self, phase: str, label: str, seconds: float,
               nbytes: int) -> None:
        print(f"[{phase}] {label}: {seconds:.3f} s, "
              f"{nbytes / max(seconds, 1e-9) / 1e9:.3f} GB/s "
              f"({nbytes} bytes; {self.card})", flush=True)

    def cli(self, phase: str, label: str, argv: list, nbytes: int) -> None:
        """One in-process CLI call; non-zero exit fails the phase."""
        from tpuhuff.cli.main import main as cli_main

        t0 = time.perf_counter()
        rc = cli_main(argv)
        dt = time.perf_counter() - t0
        check(rc == 0, f"{phase}: `huff {' '.join(argv)}` exited {rc}")
        self.report(phase, label, dt, nbytes)


def make_input(path: str, nbytes: int, seed: int) -> str:
    """Config-2 text from ``seed`` with one high-entropy region of 16 MiB
    (less for small inputs); writes ``path`` and returns its SHA-256."""
    from bench import make_textlike

    data = make_textlike(nbytes, seed)
    region = min(16 * MIB, nbytes // 4)
    at = min(100 * MIB, nbytes // 3)
    rng = np.random.default_rng(seed + 1)
    data[at:at + region] = rng.integers(0, 256, region, dtype=np.uint8)
    data.tofile(path)
    return hashlib.sha256(data.tobytes()).hexdigest()


def phase_compile(smoke: Smoke, seed: int, rows: int = CHUNK_ROWS) -> None:
    """Compile encode, decode and histogram at the 64 MiB chunk shape, print
    their memory analysis, and check each against its plain reference."""
    import jax
    import jax.numpy as jnp

    from bench import make_textlike
    from tpuhuff import native
    from tpuhuff.core.canonical import build_tree_for_device, canonicalize
    from tpuhuff.core.tree import HuffTree
    from tpuhuff.core.weights import ByteWeights
    from tpuhuff.dist import stitch_words
    from tpuhuff.kernels.decode import (
        decode_blocks_device, make_decode_tables, payload_to_lane_words,
    )
    from tpuhuff.kernels.encode import (
        encode_blocks, make_canonical_encode_tables, make_encode_tables,
    )
    from tpuhuff.kernels.histogram import histogram

    phase = "2 compile"
    check(native.available(), "native library unavailable (needs g++)")
    data = make_textlike(rows * 256, seed + 2)
    n = data.size
    counts = np.bincount(data, minlength=256)
    tree = canonicalize(build_tree_for_device(ByteWeights(counts),
                                              max_len=32)[0])
    lens, codes = tree.encode_tables()
    dl, da = make_encode_tables(lens, codes)
    tabs = make_canonical_encode_tables(tree)
    jd = jnp.asarray(data.reshape(rows, 256))
    jv = jnp.full(rows, 256, jnp.int32)

    def compiled(label, fn, *args):
        t0 = time.perf_counter()
        exe = jax.jit(fn).lower(*args).compile()
        print(f"[{phase}] {label}: compiled in "
              f"{time.perf_counter() - t0:.2f} s; memory "
              f"{exe.memory_analysis()}", flush=True)
        return exe

    def run(label, exe, *args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(exe(*args))
        smoke.report(phase, f"{label} (warm, device-resident)",
                     time.perf_counter() - t0, n)
        return out

    enc = compiled(
        "encode (64 MiB chunk, block 256)",
        lambda d, v: encode_blocks(
            d, dl, da, v, max_code_len=int(lens.max()), canon_tables=tabs[:4],
            full_alphabet=bool(tabs[5]), with_miss=True), jd, jv)
    words, bits, miss = run("encode", enc, jd, jv)
    check(int(miss) == 0, "encode: missing letters")
    payload, _ = stitch_words(np.asarray(words),
                              np.asarray(bits).astype(np.uint64))
    ref, _, ref_bits = native.encode_blocks_host(data, 256, lens, codes)
    check(hashlib.sha256(payload).digest() == hashlib.sha256(ref).digest(),
          "encode: payload SHA differs from the host C++ encoder")
    check(np.array_equal(np.asarray(bits), ref_bits.astype(np.int64)),
          "encode: block bit lengths differ from the host C++ encoder")

    hist = compiled("histogram (64 MiB)", histogram, jd)
    check(np.array_equal(np.asarray(run("histogram", hist, jd)), counts),
          "histogram differs from np.bincount")

    for label, dtree in (("canonical", tree),
                         ("foreign", HuffTree.from_weights(
                             ByteWeights(counts)))):
        dl_, dc_ = dtree.encode_tables()
        pay, _, blens = native.encode_blocks_host(data, 256, dl_, dc_)
        ends = np.cumsum(blens.astype(np.int64))
        starts = ends - blens.astype(np.int64)
        r, b0 = payload_to_lane_words(pay, starts, ends, 256)
        args = (jnp.asarray(r), jnp.asarray(b0),
                jnp.asarray((ends - starts).astype(np.int32)))
        tables, statics = make_decode_tables(dtree)
        check(statics["canonical"] == (label == "canonical"),
              f"decode: {label} tree took the other leaf search")
        dec = compiled(
            f"decode ({label} tree, {rows} blocks)",
            lambda r_, b_, n_: decode_blocks_device(
                r_, b_, n_, *tables, block_len=256, **statics), *args)
        out = np.asarray(run(f"decode {label}", dec, *args))
        check(np.array_equal(out.reshape(-1), data),
              f"decode {label}: bytes differ from the input")


def phase_hf2(smoke: Smoke, src: str, want: str, n: int) -> None:
    phase = "4 .hf2"
    host, dev, back = (smoke.path("host256"), smoke.path("dev"),
                       smoke.path("back.bin"))
    smoke.cli(phase, "host writer, block 256",
              ["--hf2", "--hf2-block", "256", "-n", src, host], n)
    for temp in ("cold", "warm"):
        smoke.cli(phase, f"--hf2 --device ({temp})",
                  ["--hf2", "--device", "-n", src, dev], n)
        check(sha256_file(dev + ".hf2") == sha256_file(host + ".hf2"),
              f"{phase}: device .hf2 differs from the host .hf2 ({temp})")
    for temp in ("cold", "warm"):
        smoke.cli(phase, f"-d --hf2 --device ({temp})",
                  ["-d", "--hf2", "--device", "-n", dev + ".hf2", back], n)
        check(sha256_file(back) == want,
              f"{phase}: device decode differs from the input ({temp})")
    for p in (host + ".hf2", dev + ".hf2", back):
        os.remove(p)


def phase_hff(smoke: Smoke, src: str, want: str, n: int) -> str:
    """Returns the host ``.hff`` path (kept for the foreign-tree phase)."""
    phase = "5 .hff"
    host, dev, back = (smoke.path("host"), smoke.path("devhff"),
                       smoke.path("back.bin"))
    smoke.cli(phase, "host writer", ["-n", src, host], n)
    for temp in ("cold", "warm"):
        smoke.cli(phase, f"--device ({temp})", ["--device", "-n", src, dev], n)
        check(sha256_file(dev + ".hff") == sha256_file(host + ".hff"),
              f"{phase}: device .hff differs from the host .hff ({temp})")
    smoke.cli(phase, "-d (host reader)", ["-d", "-n", dev + ".hff", back], n)
    check(sha256_file(back) == want, f"{phase}: decode differs from input")
    for p in (dev + ".hff", dev + ".hff.hf2x", back):
        if os.path.exists(p):
            os.remove(p)
    return host + ".hff"


def phase_foreign(smoke: Smoke, hff: str, want: str, n: int) -> None:
    from tpuhuff.io.stream import _read_hff_header
    from tpuhuff.kernels.decode import make_canonical_decode_tables

    phase = "6 foreign tree"
    with open(hff, "rb") as f:
        tree = _read_hff_header(f, hff)[0]
    check(make_canonical_decode_tables(tree) is None,
          f"{phase}: the host .hff tree is canonical; nothing foreign to test")
    hf2, back = smoke.path("foreign.hf2"), smoke.path("back.bin")
    smoke.cli(phase, "--reindex, block 256",
              ["--reindex", "--hf2-block", "256", "-n", hff, hf2], n)
    for temp in ("cold", "warm"):
        smoke.cli(phase, f"-d --hf2 --device ({temp})",
                  ["-d", "--hf2", "--device", "-n", hf2, back], n)
        check(sha256_file(back) == want,
              f"{phase}: device decode differs from the input ({temp})")
    for p in (hf2, back, hff):
        os.remove(p)


def phase_dataset(smoke: Smoke, src: str, shard_bytes: int) -> None:
    phase = "7 dataset"
    shards, wants = [], []
    with open(src, "rb") as f:
        for k in range(3):
            piece = f.read(shard_bytes)
            check(len(piece) == shard_bytes, f"{phase}: input too short")
            shards.append(smoke.path(f"shard{k}.bin"))
            with open(shards[-1], "wb") as g:
                g.write(piece)
            wants.append(hashlib.sha256(piece).hexdigest())
    out_dir = smoke.path("ds")
    for temp in ("cold", "warm"):
        smoke.cli(phase, f"--dataset --device --adaptive ({temp})",
                  ["--dataset", *shards, "--device", "--adaptive",
                   "--out-dir", out_dir], 3 * shard_bytes)
    back = smoke.path("back.bin")
    for shard, want in zip(shards, wants):
        out = os.path.join(out_dir, os.path.basename(shard) + ".hf2")
        smoke.cli(phase, f"-d --hf2 --device {os.path.basename(out)}",
                  ["-d", "--hf2", "--device", "-n", out, back], shard_bytes)
        check(sha256_file(back) == want,
              f"{phase}: {os.path.basename(out)} decodes to other bytes")
    shutil.rmtree(out_dir)
    for p in shards + [back]:
        os.remove(p)


def phase_golden() -> None:
    import tpuhuff

    got = tpuhuff.compress(b"abbccc").to_bytes().hex()
    check(got == GOLDEN, f"8 golden: compress(b'abbccc') = {got}")
    print("[8 golden] compress(b'abbccc') matches the reference", flush=True)


def make_mixed(nbytes: int, seed: int) -> np.ndarray:
    """BASELINE config 3: low- and high-entropy regions of 16 MiB (smaller
    for small inputs) in an order drawn from ``seed``."""
    from bench import make_textlike

    rng = np.random.default_rng(seed)
    region = max(4096, min(16 * MIB, nbytes // 64))
    out = np.empty(nbytes, np.uint8)
    for k, at in enumerate(range(0, nbytes, region)):
        m = min(region, nbytes - at)
        kind = int(rng.integers(0, 4))
        if kind == 0:  # text
            out[at:at + m] = make_textlike(m, seed + k)
        elif kind == 1:  # high entropy (compressed or encrypted data)
            out[at:at + m] = rng.integers(0, 256, m, dtype=np.uint8)
        elif kind == 2:  # small integers (tables, binaries)
            out[at:at + m] = np.minimum(rng.geometric(0.08, m), 255)
        else:  # sparse: mostly zeros
            out[at:at + m] = np.where(rng.random(m) < 0.9, 0,
                                      rng.integers(0, 256, m))
    return out


def phase_four_cards(smoke: Smoke, nbytes: int, seed: int, devices) -> None:
    """The dist/ path over a mesh of ``devices``: psum histogram, sharded
    encode, host stitch, sharded decode — each checked exactly."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpuhuff import native
    from tpuhuff.dist import (
        pad_to_blocks, sharded_decode_blocks, sharded_histogram, stitch_words,
    )
    from tpuhuff.dist.block import encode_pipeline_arrays
    from tpuhuff.dist.mesh import BLOCK_AXIS, block_sharding
    from tpuhuff.kernels.decode import payload_to_lane_words

    phase = f"{len(devices)}-card dist"
    check(native.available(), "native library unavailable (needs g++)")
    mesh = Mesh(np.asarray(devices), (BLOCK_AXIS,))
    data = make_mixed(nbytes, seed)
    block = 256
    blocks, valid, _ = pad_to_blocks(data, block, len(devices))
    shard = block_sharding(mesh)
    t0 = time.perf_counter()
    import jax

    jb = jax.device_put(blocks, shard)
    jv = jax.device_put(valid, shard)
    counts = sharded_histogram(jb, jv, mesh)
    smoke.report(phase, "H2D + psum histogram (cold)",
                 time.perf_counter() - t0, nbytes)
    check(np.array_equal(counts.astype(np.int64),
                         np.bincount(data, minlength=256)),
          f"{phase}: psum histogram differs from np.bincount")
    for temp in ("cold", "warm"):
        t0 = time.perf_counter()
        words, bits, tree = encode_pipeline_arrays(jb, jv, mesh,
                                                   canonical=True)
        payload, _ = stitch_words(np.asarray(words),
                                  np.asarray(bits).astype(np.uint64))
        smoke.report(phase, f"histogram + sharded encode + stitch ({temp})",
                     time.perf_counter() - t0, nbytes)
    lens, codes = tree.encode_tables()
    ref, _ = native.encode(data, lens, codes)
    check(hashlib.sha256(payload).digest() == hashlib.sha256(ref).digest(),
          f"{phase}: stitched payload SHA differs from the host C++ encoder")
    b = np.asarray(bits).astype(np.int64)
    ends = np.cumsum(b)
    starts = ends - b
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block)
    for temp in ("cold", "warm"):
        t0 = time.perf_counter()
        out = sharded_decode_blocks(
            jax.device_put(rows, shard), jax.device_put(bit0, shard),
            jax.device_put((ends - starts).astype(np.int32), shard),
            tree, block, mesh)
        out = np.asarray(out).reshape(-1)[:nbytes]
        smoke.report(phase, f"H2D + sharded decode + D2H ({temp})",
                     time.perf_counter() - t0, nbytes)
        check(np.array_equal(out, data),
              f"{phase}: sharded decode differs from the input")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=256,
                    help="input size in MiB (plus 12,345 bytes)")
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card dist/ path")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform}", file=sys.stderr)
        return 2
    card = card_name_and_power()
    print(card, flush=True)
    print(f"[1 device] {devices[0].device_kind} x{len(devices)}", flush=True)
    from tpuhuff.cache import enable_compile_cache

    enable_compile_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    smoke = Smoke(workdir, card)
    try:
        if args.cards == 4:
            check(len(devices) >= 4, f"--cards 4 needs 4 GPUs, found "
                  f"{len(devices)}")
            devices = devices[:4]
            phase_four_cards(smoke, 1 << 30, args.seed, devices)
        else:
            devices = devices[:1]
            phase_compile(smoke, args.seed)
            n = args.mib * MIB + 12_345
            src = smoke.path("input.bin")
            t0 = time.perf_counter()
            want = make_input(src, n, args.seed)
            smoke.report("3 input", "generate + write", time.perf_counter()
                         - t0, n)
            phase_hf2(smoke, src, want, n)
            hff = phase_hff(smoke, src, want, n)
            phase_foreign(smoke, hff, want, n)
            phase_dataset(smoke, src, min(64 * MIB, n // 3))
            phase_golden()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
