"""chip_smoke.py: its phases at toy size on CPU, its refusal to run without
a GPU, and (marker ``gpu``) the same phases on the card."""
import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TOY = chip_smoke.Config(system="diamond", basis="gth-szv", ke_cutoff=30.0,
                        kmesh=(1, 1, 2), c0=10.0, m0=(7, 7, 7))


def test_production_phase_toy():
    out = chip_smoke.production(TOY)
    assert out["nip"] > 0 and out["nchunks"] >= 1
    assert len(out["energies"]) == TOY.scf_cycles + 1


def test_accuracy_phase_toy():
    out = chip_smoke.accuracy(TOY)
    # f64 on CPU: the host complex128 serve agrees to rounding
    assert out["vj_vs_host"] < 1e-10 and out["vk_vs_host"] < 1e-10
    assert out["vj_vs_exact"] < 1e-3 and out["vk_vs_exact"] < 1e-3


def test_four_phase_toy():
    """The sharded build over four virtual CPU devices vs one device."""
    out = chip_smoke.four(dataclasses.replace(TOY, kmesh=(1, 2, 2)))
    assert out["vj"] < 1e-8 and out["vk"] < 1e-8


def test_host_serve_matches_device_serve():
    """host_serve is the phase-matrix algebra of isdf.jk, in numpy."""
    import numpy as np
    from bench import trs_test_density
    from fftisdf_tpu.isdf import FFTISDF

    cell = chip_smoke.make_cell(TOY)
    kpts = cell.get_kpts([1, 2, 2])
    df = FFTISDF(cell, kpts, c0=6.0, m0=(5, 5, 5), verbose=0).build()
    dm = trs_test_density(cell, kpts)
    vj, vk = df.get_jk(dm)
    vj_h, vk_h = chip_smoke.host_serve(df.x_k, df.wq, dm, df.kmesh)
    np.testing.assert_allclose(np.asarray(vj), vj_h, atol=1e-10)
    np.testing.assert_allclose(np.asarray(vk), vk_h, atol=1e-10)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """On CPU, and as a lone file without the package, the script fails and
    prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU found" in r.stderr


@pytest.mark.gpu
def test_phases_toy_on_gpu(gpu_env):
    """The production and accuracy phases at toy size, compiled for the
    card (f32, matmul precision 'highest')."""
    code = ("import chip_smoke as cs\n"
            "from fftisdf_tpu.utils.device import ensure_f32_matmul_precision\n"
            "ensure_f32_matmul_precision()\n"
            f"cfg = cs.{TOY!r}\n"
            "cs.production(cfg)\n"
            "cs.accuracy(cfg)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=gpu_env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
