"""Host<->device transfer helpers and device-wide JAX settings.

The transfer half (``to_device``, ``to_host``, ``czeros``, ``jit_take``)
moves complex arrays as real/imaginary parts, recombined under ``jax.jit``,
and keeps complex indexing and allocation under jit.  Plain
``jnp.asarray`` / ``np.asarray`` do the same job on every backend this
package runs on; the helpers stay until their callers are moved over.

Real arrays pass straight through.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("cdtype",))
def _combine(re, im, cdtype):
    return (re + 1j * im).astype(cdtype)


@partial(jax.jit, static_argnames=("shape", "dtype"))
def czeros(shape, dtype):
    """Complex (or any-dtype) zeros allocated ON DEVICE under jit."""
    return jnp.zeros(shape, dtype=dtype)


@jax.jit
def _real(x):
    return jnp.real(x)


@jax.jit
def _imag(x):
    return jnp.imag(x)


@jax.jit
def jit_take(a, i):
    """a[i] along the leading axis, compiled once (traced index)."""
    return jax.lax.dynamic_index_in_dim(a, i, 0, keepdims=False)


def to_device(x, dtype=None):
    """np/jnp array -> device array; complex inputs are shipped as two real
    transfers and recombined on device under jit."""
    if isinstance(x, jnp.ndarray):
        return x if dtype is None else x.astype(dtype)
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        out = jnp.asarray(x)
        return out if dtype is None else out.astype(dtype)
    cdtype = jnp.complex128 if (dtype in (None, jnp.complex128)
                                and x.dtype == np.complex128) else jnp.complex64
    if dtype is not None:
        cdtype = dtype
    if cdtype == jnp.complex128 and not jax.config.jax_enable_x64:
        cdtype = jnp.complex64   # silently truncated anyway; skip the warn
    rdtype = jnp.float64 if cdtype == jnp.complex128 else jnp.float32
    re = jnp.asarray(np.ascontiguousarray(x.real), dtype=rdtype)
    im = jnp.asarray(np.ascontiguousarray(x.imag), dtype=rdtype)
    return _combine(re, im, cdtype)


def to_host(x):
    """Device array -> numpy; complex arrays come back as two real pulls."""
    if np.iscomplexobj(x):
        return (np.asarray(_real(x)).astype(np.float64)
                + 1j * np.asarray(_imag(x)).astype(np.float64))
    return np.asarray(x)


def ensure_f32_matmul_precision():
    """On non-CPU backends, set jax_default_matmul_precision='highest' if
    the user has not chosen one.  This is what keeps f32 products in full
    f32: at the default precision a GPU runs f32 matmuls as TF32 (10-bit
    mantissa), which costs orders of magnitude in J/K accuracy and NaNs
    the near-singular pair-gram factorizations.

    Called lazily from compute entry points (FFTISDF / KRHF construction) —
    NOT at package import: ``jax.default_backend()`` instantiates the
    backend, and an import must never grab the device before user code can
    switch platforms."""
    import jax

    if jax.config.jax_default_matmul_precision is None and \
            jax.default_backend() != "cpu":
        jax.config.update("jax_default_matmul_precision", "highest")


def enable_persistent_cache():
    """Persistent XLA compilation cache, so compiled executables are reused
    across processes: in ``JAX_COMPILATION_CACHE_DIR`` when it is set, else
    in ``<repo>/.jax_cache``.  Returns the directory."""
    import os
    from pathlib import Path
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(Path(__file__).resolve().parents[2] / ".jax_cache"))
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
