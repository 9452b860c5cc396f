import json

import numpy as np
import jax.numpy as jnp

from fftisdf_tpu.utils.config import ISDFConfig
from fftisdf_tpu.utils.device import to_device, to_host, jit_take
from fftisdf_tpu.utils.logging import Logger
from fftisdf_tpu.utils import profiling


def test_config_roundtrip():
    cfg = ISDFConfig(c0=30.0, m0=(9, 9, 9), solver="svd", kmesh=(2, 2, 2))
    cfg2 = ISDFConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    kw = cfg.isdf_kwargs()
    assert kw["c0"] == 30.0 and kw["solver"] == "svd"


def test_device_transfer_roundtrip():
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal((4, 5)),
                rng.standard_normal((4, 5)) + 1j * rng.standard_normal((4, 5))):
        dev = to_device(arr)
        back = to_host(dev)
        np.testing.assert_allclose(back, arr, atol=1e-12)


def test_jit_take():
    x = to_device(np.arange(24).reshape(4, 6).astype(complex))
    np.testing.assert_allclose(to_host(jit_take(x, 2)),
                               np.arange(12, 18))


def test_logger_levels(capsys):
    import io

    buf = io.StringIO()
    log = Logger(verbose=3, stream=buf)
    log.info("visible %d", 1)
    log.debug("hidden")
    out = buf.getvalue()
    assert "visible 1" in out and "hidden" not in out


def test_profiling_phase_scope():
    with profiling.phase("unit-test-phase"):
        x = jnp.ones(4).sum()
    assert float(x) == 4.0


_CACHE_PROBE = """
import os, sys, jax, jax.numpy as jnp
from fftisdf_tpu.utils.device import enable_persistent_cache
path = enable_persistent_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.jit(lambda a: jnp.sin(a) * 3.0 + 1.0)(jnp.ones(7)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


def _run_cache_probe(tmp_path, cache_env):
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp_path / "home"),
               TMPDIR=str(tmp_path))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(cache_env)
    (tmp_path / "home").mkdir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                       cwd=repo, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return repo, r.stdout.split()[-2:]


def test_compile_cache_uses_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache is written there and
    nowhere under HOME."""
    cache = tmp_path / "cache"
    _, (path, cfg_dir) = _run_cache_probe(
        tmp_path, {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert path == cfg_dir == str(cache)
    assert any(cache.iterdir())
    assert not any((tmp_path / "home").iterdir())


def test_compile_cache_defaults_to_repo(tmp_path):
    """Unset, the cache lives in <repo>/.jax_cache (git-ignored)."""
    import os

    repo, (path, cfg_dir) = _run_cache_probe(tmp_path, {})
    assert path == cfg_dir == os.path.join(repo, ".jax_cache")
    assert any(os.scandir(path))
    assert not any((tmp_path / "home").iterdir())
