"""Test configuration: run everything on CPU with 8 virtual devices and f64.

Mirrors the reference's accuracy regime (complex128 everywhere) so the 1e-10
identity gates are meaningful; sharding tests use the 8-device virtual mesh
(SURVEY.md section 4 item 5).

The platform is pinned through jax.config (backends are not yet
instantiated at conftest time), so the tests run on CPU even where a GPU is
visible; XLA_FLAGS is read at CPU-client creation, so setting it here still
works.  Tests marked ``gpu`` need the card: they take the ``gpu_env``
fixture, run their work in a child process on the GPU, and skip where JAX
finds none (``python -m pytest tests/ -m gpu`` on the card runs them).
"""
import os
import subprocess
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# ---------------------------------------------------------------------------
# Test tiers (auto-marked by file, so `pytest -m core` / `-m extended` work
# without touching every test module):
#
#   core      — the ISDF-product gates (SURVEY.md section 4): lattice/basis/
#               linalg foundations, the k-point ISDF build and its oracles,
#               J/K serving, SCF, sharding, f32-regime numerics.  The
#               pre-commit tier; runs in well under 10 min on the 1-core
#               host.
#   extended  — the beyond-reference physics (CC/EOM, GW/BSE, TDDFT, DMET,
#               derivatives: forces/stress/hessian/phonon/elastic/EOS/MD,
#               KS-DFT functionals/+U, spectroscopy/IO) — the long tail
#               (~35 min).  Run before shipping physics changes.
#
# Full suite = both tiers; `python -m pytest tests/ -q` is unchanged.
# ---------------------------------------------------------------------------
_EXTENDED_FILES = {
    "test_analysis.py", "test_atom.py", "test_becke.py", "test_bse.py",
    "test_cc.py", "test_cube.py",
    "test_dmet.py", "test_dos.py", "test_elastic.py", "test_eos.py",
    "test_exxdiv_grad.py", "test_forces.py", "test_gw.py",
    "test_hessian.py", "test_hse.py", "test_hubbard.py", "test_ks.py",
    "test_md.py", "test_mp2.py", "test_optimize.py", "test_phonon.py",
    "test_relax_cell.py", "test_rpa.py", "test_stress.py",
    "test_tddft.py", "test_trunc_scf.py",
}


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process that runs on the GPU; skips the test
    where JAX finds none.  This process stays pinned to CPU, so work that
    needs the card runs in a child.  Decided here, at run time, never at
    import or collection time."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not any(p in platforms for p in ("gpu", "cuda")):
        pytest.skip(f"needs an NVIDIA GPU (JAX_PLATFORMS={platforms})")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0 or probe.stdout.split()[-1:] != ["gpu"]:
        pytest.skip("needs an NVIDIA GPU (none visible to JAX)")
    return env


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = os.path.basename(str(item.fspath))
        tier = "extended" if fname in _EXTENDED_FILES else "core"
        item.add_marker(getattr(pytest.mark, tier))
