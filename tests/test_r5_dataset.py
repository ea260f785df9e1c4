"""Config-4 product path: shared-tree dataset compression (VERDICT r4 #1).

The reference's analogue is one whole-file tree reused across all blocks
(`/root/reference/huff/src/comp.rs:46-66`); ``compress_dataset`` broadcasts
one table across FILES, single-pass-encoding each shard, with an adaptive
per-shard refresh riding the encode pass (the fused ``hist_data`` kernel
operand — its first product consumer).
"""

import os

import numpy as np
import pytest

from tpuhuff.io.dataset import (
    build_shared_tree,
    compress_dataset,
    tree_from_counts,
)
from tpuhuff.io.hff import read_hf2_header
from tpuhuff.io.stream import (
    read_compress_write_hf2,
    read_decompress_write,
    read_decompress_write_hf2,
)


def _mk_shards(tmp_path, n=3, size=200_000, drift=False):
    rng = np.random.default_rng(5)
    paths = []
    for k in range(n):
        if drift:
            # per-shard distribution drift: the adaptive mode's use case
            lo, hi = 32 + 40 * k, 128 + 40 * k
            data = rng.integers(lo, hi, size, dtype=np.uint8)
        else:
            text = (b"shared frequency table over shards %d " % k) * 6000
            data = np.frombuffer(text[:size], dtype=np.uint8)
        p = tmp_path / f"shard{k}.bin"
        p.write_bytes(data.tobytes())
        paths.append(str(p))
    return paths


def test_shared_tree_single_pass_roundtrip(tmp_path):
    srcs = _mk_shards(tmp_path)
    stats: dict = {}
    outs = compress_dataset(srcs, out_dir=str(tmp_path / "out"),
                            stats=stats)
    assert stats["tree_builds"] == 1  # ONE table for the whole dataset
    trees = []
    for src, dst in zip(srcs, outs):
        out = dst + ".dec"
        read_decompress_write_hf2(dst, out)
        assert open(out, "rb").read() == open(src, "rb").read()
        with open(dst, "rb") as fp:
            hdr = read_hf2_header(fp)
        trees.append(hdr.tree.as_bin().to_bytes())
        assert hdr.crcs is not None  # integrity column rides along
    # shared mode: every shard carries the IDENTICAL broadcast tree
    assert len(set(trees)) == 1


def test_shared_tree_covers_unseen_bytes(tmp_path):
    """Smoothing makes the alphabet complete: a shard containing bytes the
    table-build pass never saw still encodes exactly (no missing-letter
    CompressError, reference `comp.rs:427-432`)."""
    a = tmp_path / "a.bin"
    b = tmp_path / "b.bin"
    a.write_bytes(b"aaaabbbbcccc" * 1000)
    b.write_bytes(bytes(range(256)) * 100)  # full alphabet, unseen in a
    outs = compress_dataset([str(a), str(b)], out_dir=str(tmp_path),
                            tree_from=str(a))
    for src, dst in zip([a, b], outs):
        out = dst + ".dec"
        read_decompress_write_hf2(dst, out)
        assert open(out, "rb").read() == src.read_bytes()


def test_adaptive_refresh_tracks_drift(tmp_path):
    """Adaptive vs a STALE table: both modes avoid the full dataset
    pre-scan (adaptive seeds from shard 0 only), but adaptive's lag-one
    refresh tracks drifting data where the frozen seed table cannot."""
    srcs = _mk_shards(tmp_path, n=4, drift=True)
    sstats: dict = {}
    astats: dict = {}
    stale = compress_dataset(srcs, out_dir=str(tmp_path / "s"),
                             tree_from=srcs[0], stats=sstats)
    adaptive = compress_dataset(srcs, out_dir=str(tmp_path / "a"),
                                adaptive=True, stats=astats)
    assert astats["tree_builds"] == len(srcs)  # seed + one per later shard
    trees = set()
    for src, dst in zip(srcs, adaptive):
        out = dst + ".dec"
        read_decompress_write_hf2(dst, out)
        assert open(out, "rb").read() == open(src, "rb").read()
        with open(dst, "rb") as fp:
            trees.add(read_hf2_header(fp).tree.as_bin().to_bytes())
    assert len(trees) > 1  # the table actually refreshed
    assert astats["ratio"] < sstats["ratio"]
    assert stale and adaptive


def test_collect_hist_is_exact(tmp_path):
    """The histogram gathered during the encode pass must be EXACT — it
    becomes the next shard's tree."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 123_457, dtype=np.uint8)
    src = tmp_path / "x.bin"
    src.write_bytes(data.tobytes())
    tree = tree_from_counts(np.bincount(data, minlength=256), device=False)
    hist = read_compress_write_hf2(
        str(src), str(tmp_path / "x.hf2"), tree=tree, collect_hist=True)
    assert hist is not None
    assert np.array_equal(hist, np.bincount(data, minlength=256))


def test_collect_hist_device_route_exact(tmp_path):
    """Same exactness through the device writer (the encode program's
    hist_data operand)."""
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, 70_000, dtype=np.uint8)
    src = tmp_path / "y.bin"
    src.write_bytes(data.tobytes())
    tree = tree_from_counts(np.bincount(data, minlength=256))
    hist = read_compress_write_hf2(
        str(src), str(tmp_path / "y.hf2"), tree=tree, collect_hist=True,
        device=True, block_len=512)
    assert np.array_equal(hist, np.bincount(data, minlength=256))
    out = tmp_path / "y.dec"
    read_decompress_write_hf2(str(tmp_path / "y.hf2"), str(out))
    assert out.read_bytes() == data.tobytes()


def test_shared_tree_hff_output(tmp_path):
    srcs = _mk_shards(tmp_path, n=2)
    outs = compress_dataset(srcs, out_dir=str(tmp_path / "h"), hf2=False)
    for src, dst in zip(srcs, outs):
        assert dst.endswith(".hff")
        out = dst + ".dec"
        read_decompress_write(dst, out, auto_index=False)
        assert open(out, "rb").read() == open(src, "rb").read()


def test_adaptive_requires_hf2(tmp_path):
    srcs = _mk_shards(tmp_path, n=2)
    with pytest.raises(ValueError):
        compress_dataset(srcs, out_dir=str(tmp_path), adaptive=True,
                         hf2=False)


def test_build_shared_tree_samples_and_caps(tmp_path):
    srcs = _mk_shards(tmp_path, n=2)
    t1 = build_shared_tree(srcs, hist_sample=8)
    t2 = build_shared_tree(srcs, hist_sample=8, max_bytes_per_file=50_000)
    # both usable trees with complete alphabets
    for t in (t1, t2):
        lens, _ = t.encode_tables()
        assert int((np.asarray(lens) > 0).sum()) == 256


def test_cli_dataset(tmp_path):
    from tpuhuff.cli.main import main

    srcs = _mk_shards(tmp_path, n=3)
    rc = main(["--dataset", *srcs, "--out-dir", str(tmp_path / "cli"),
               "-n"])
    assert rc == 0
    for s in srcs:
        dst = str(tmp_path / "cli" / (os.path.basename(s) + ".hf2"))
        out = dst + ".dec"
        read_decompress_write_hf2(dst, out)
        assert open(out, "rb").read() == open(s, "rb").read()


def test_cli_tree_from_single_file(tmp_path):
    from tpuhuff.cli.main import main

    srcs = _mk_shards(tmp_path, n=2)
    dst = str(tmp_path / "one.hf2")
    rc = main(["--hf2", "--tree-from", srcs[0], "-n", srcs[1],
               str(tmp_path / "one")])
    assert rc == 0
    out = dst + ".dec"
    read_decompress_write_hf2(dst, out)
    assert open(out, "rb").read() == open(srcs[1], "rb").read()


def test_decompress_dataset_roundtrip(tmp_path):
    from tpuhuff.io.dataset import decompress_dataset

    srcs = _mk_shards(tmp_path, n=3)
    outs = compress_dataset(srcs, out_dir=str(tmp_path / "c"))
    decs = decompress_dataset(outs, out_dir=str(tmp_path / "d"))
    for src, dec in zip(srcs, decs):
        assert os.path.basename(dec) == os.path.basename(src)
        assert open(dec, "rb").read() == open(src, "rb").read()
