"""Smoke test: bench.py runs end-to-end on CPU and emits one JSON line."""
import json
import os
import subprocess
import sys


def test_bench_quick_json():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "bench.py", "--quick", "--system", "diamond",
         "--ke", "30", "--c0", "8"],
        env=env, capture_output=True, text=True, timeout=1200,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    data = json.loads(line)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in data
    assert data["value"] > 0
    # every line names the device; a CPU rehearsal writes no device metric
    assert data["device"]["platform"] == "cpu"
    assert data["device"]["count"] >= 1 and data["device"]["kind"]
    for key in ("jk_tflops", "jk_mfu", "build_tflops", "build_mfu",
                "build_hbm_bw_util"):
        assert data[key] is None, key


def test_peak_table_resolves_h100_and_skips_cpu():
    import bench

    peaks = bench.device_peaks("gpu", "NVIDIA H100 80GB HBM3")
    assert peaks["f32_flops"] == 67e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    assert bench.device_peaks("cpu", "cpu") is None


def test_peak_table_unknown_device_raises():
    import bench
    import pytest

    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("gpu", "NVIDIA Imaginary 1GB")
