"""chip_smoke.py on the CPU: its phases at a tiny size, and its refusal to
run without a GPU or without the rest of the repository."""

import hashlib
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

N = 300_000 + 12_345


@pytest.fixture
def smoke(tmp_path):
    return chip_smoke.Smoke(str(tmp_path), "cpu rehearsal, 0 W")


@pytest.fixture
def src(smoke):
    path = smoke.path("input.bin")
    want = chip_smoke.make_input(path, N, seed=5)
    return path, want


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_make_input_is_seeded(tmp_path):
    a, b, c = (str(tmp_path / x) for x in "abc")
    wa = chip_smoke.make_input(a, N, seed=1)
    assert chip_smoke.make_input(b, N, seed=1) == wa
    assert chip_smoke.make_input(c, N, seed=2) != wa
    assert os.path.getsize(a) == N
    assert hashlib.sha256(open(a, "rb").read()).hexdigest() == wa


def test_phase_compile(smoke):
    chip_smoke.phase_compile(smoke, seed=3, rows=512)


def test_phase_hf2(smoke, src):
    chip_smoke.phase_hf2(smoke, *src, N)


def test_phase_hff_and_foreign_tree(smoke, src):
    hff = chip_smoke.phase_hff(smoke, *src, N)
    chip_smoke.phase_foreign(smoke, hff, src[1], N)


def test_phase_dataset(smoke, src):
    chip_smoke.phase_dataset(smoke, src[0], N // 3)


def test_phase_golden():
    chip_smoke.phase_golden()


def test_phase_four_cards(smoke):
    chip_smoke.phase_four_cards(smoke, 1 << 20, seed=7,
                                devices=jax.devices()[:4])


def test_check_raises():
    with pytest.raises(chip_smoke.SmokeError, match="boom"):
        chip_smoke.check(False, "boom")
