"""ctypes bindings for the native host-side lattice engine.

Builds ``native/lattice_engine.cpp`` on demand with g++ (cached next to the
package, named after a hash of the source, so a library built from other
source is never loaded); every entry point has a pure-Python fallback so the framework works
without a toolchain.  Set ``FFTISDF_TPU_NO_NATIVE=1`` to force the fallbacks.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False


def _source_path() -> Path:
    return Path(__file__).resolve().parents[2] / "native" / "lattice_engine.cpp"


def _lib_path() -> Path:
    digest = hashlib.sha256(_source_path().read_bytes()).hexdigest()[:16]
    return Path(__file__).resolve().parent / f"_liblattice_engine_{digest}.so"


def load():
    """Return the loaded library or None (after one build attempt)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FFTISDF_TPU_NO_NATIVE"):
        return None
    try:
        src, lib = _source_path(), _lib_path()
        if not lib.exists():
            # build under a private name and rename: concurrent importers
            # never load a half-written library
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", str(src), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        _LIB = ctypes.CDLL(str(lib))
        _declare(_LIB)
    except Exception as exc:  # toolchain missing, build failure, ...
        print(f"fftisdf_tpu.native: falling back to Python ({exc})",
              file=sys.stderr)
        _LIB = None
    return _LIB


def _declare(lib):
    d = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.enumerate_images.restype = ctypes.c_int64
    lib.enumerate_images.argtypes = [d, d, d, ctypes.c_double, i64, d,
                                     ctypes.c_int64]
    lib.build_kconserv.restype = ctypes.c_int32
    lib.build_kconserv.argtypes = [d, ctypes.c_int64, i64, i64]
    lib.ewald_real.restype = ctypes.c_double
    lib.ewald_real.argtypes = [d, d, ctypes.c_int64, d, ctypes.c_int64,
                               ctypes.c_double]
    lib.eval_ao_group.restype = ctypes.c_int64
    lib.eval_ao_group.argtypes = [
        d, ctypes.c_int64,            # coords, ng
        d, ctypes.c_int64,            # centers, nimg
        d, d, ctypes.c_int64,         # cosk, sink, nk
        ctypes.c_int64, i64, i64, i64, i64,  # nspec, ls, rpows, nprims, nctrs
        d, d, d,                      # exps, coeffs, rcut2
        d, d]                         # out_re, out_im


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def enumerate_images(a, center, cell_center, reach, nmax):
    """Native image enumeration; returns (n, 3) float64 or None if no lib."""
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.float64)
    center = np.ascontiguousarray(center, dtype=np.float64)
    cc = np.ascontiguousarray(cell_center, dtype=np.float64)
    nmax = np.ascontiguousarray(nmax, dtype=np.int64)
    cap = int(np.prod(2 * nmax + 1))
    out = np.empty((cap, 3), dtype=np.float64)
    n = lib.enumerate_images(_dptr(a), _dptr(center), _dptr(cc),
                             ctypes.c_double(float(reach)), _iptr(nmax),
                             _dptr(out), ctypes.c_int64(cap))
    return out[:n].copy()


def build_kconserv(skpts):
    """Native (kconserv2, kconserv3) tables or None."""
    lib = load()
    if lib is None:
        return None
    s = np.ascontiguousarray(skpts, dtype=np.float64)
    nk = len(s)
    k2 = np.empty((nk, nk), dtype=np.int64)
    k3 = np.empty((nk, nk, nk), dtype=np.int64)
    rc = lib.build_kconserv(_dptr(s), ctypes.c_int64(nk), _iptr(k2), _iptr(k3))
    if rc != 0:
        return None
    return k2, k3


def eval_ao_group(coords, centers, cosk, sink, specs, screen_precision):
    """Native screened Bloch-AO evaluation for one center group.

    ``specs`` is the group's list of ShellSpec-like objects (attributes
    l, rpow, exps, coeffs, rcut).  Returns (nk, ng, nf) complex128 or
    None if the native library is unavailable / a shell is unsupported.
    Screening radii use each shell's decay radius re-derived at
    ``screen_precision`` (tighter than the shell's own precision by the
    caller's margin, so skipped image contributions stay far below the
    evaluator's accuracy contract).
    """
    lib = load()
    if lib is None:
        return None
    from fftisdf_tpu.basis.gto import shell_rcut

    coords = np.ascontiguousarray(coords, dtype=np.float64)
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    cosk = np.ascontiguousarray(cosk, dtype=np.float64)
    sink = np.ascontiguousarray(sink, dtype=np.float64)
    ng, nimg, nk = len(coords), len(centers), cosk.shape[1]
    ls = np.array([s.l for s in specs], dtype=np.int64)
    if (ls > 4).any():
        return None
    rpows = np.array([s.rpow for s in specs], dtype=np.int64)
    nprims = np.array([len(s.exps) for s in specs], dtype=np.int64)
    nctrs = np.array([s.coeffs.shape[1] for s in specs], dtype=np.int64)
    exps = np.ascontiguousarray(
        np.concatenate([np.asarray(s.exps, dtype=np.float64)
                        for s in specs]))
    coeffs = np.ascontiguousarray(
        np.concatenate([np.asarray(s.coeffs, dtype=np.float64).ravel()
                        for s in specs]))
    rcut2 = np.array([shell_rcut(s.l + 2 * s.rpow, s.exps,
                                 s.coeffs, screen_precision) ** 2
                     for s in specs], dtype=np.float64)
    nf = int(np.sum((2 * ls + 1) * nctrs))
    out_re = np.empty((nk, ng, nf))
    out_im = np.empty((nk, ng, nf))
    rc = lib.eval_ao_group(
        _dptr(coords), ctypes.c_int64(ng), _dptr(centers),
        ctypes.c_int64(nimg), _dptr(cosk), _dptr(sink), ctypes.c_int64(nk),
        ctypes.c_int64(len(specs)), _iptr(ls), _iptr(rpows), _iptr(nprims),
        _iptr(nctrs), _dptr(exps), _dptr(coeffs), _dptr(rcut2),
        _dptr(out_re), _dptr(out_im))
    if rc != nf:
        return None
    return out_re + 1j * out_im


def ewald_real(coords, charges, ts, eta):
    """Native real-space Ewald sum or None."""
    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    charges = np.ascontiguousarray(charges, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    return float(lib.ewald_real(_dptr(coords), _dptr(charges),
                                ctypes.c_int64(len(charges)), _dptr(ts),
                                ctypes.c_int64(len(ts)),
                                ctypes.c_double(float(eta))))
