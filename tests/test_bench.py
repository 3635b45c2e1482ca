"""The measurement entry points refuse to report without a GPU: bench.py
and chip_smoke.py exit nonzero on the CPU and print no result."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_timed_reps_is_median_of_three():
    durations = iter([3.0, 1.0, 2.0])
    clock = {"t": 0.0}

    def fake_perf_counter():
        return clock["t"]

    def run():
        clock["t"] += next(durations)

    orig = bench.time.perf_counter
    bench.time.perf_counter = fake_perf_counter
    try:
        med, reps = bench._timed_reps(run)
    finally:
        bench.time.perf_counter = orig
    assert med == 2.0 and reps == [3.0, 1.0, 2.0]


def test_bench_fails_without_gpu(capsys):
    assert bench.main() == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "no GPU" in out["error"] and out["value"] == 0.0


def test_chip_smoke_fails_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the package, it cannot run."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert bench.card_info() == (None, None)


def test_chip_smoke_image_check_tolerates_flips_not_faults():
    """chip_smoke's kernel-vs-jnp bound: a few flipped grazing samples pass,
    a pervasive difference fails."""
    import numpy as np
    import pytest

    import chip_smoke

    rng = np.random.default_rng(0)
    ref = rng.uniform(0.0, 4.0, (1000, 3)).astype(np.float32)
    flipped = ref.copy()
    flipped[:5, 0] += 0.4                  # 0.5% of pixels, one sample each
    chip_smoke.compare_images(flipped, ref, 4, "flips")
    with pytest.raises(AssertionError, match="disagree"):
        chip_smoke.compare_images(ref * 1.05, ref, 4, "fault")
