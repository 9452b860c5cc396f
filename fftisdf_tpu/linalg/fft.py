"""Batched 3D FFT helpers on flat grid layout.

Native replacement for ``pyscf.pbc.tools.fft/ifft`` (used at
``/root/reference/fftisdf.py:113,118``): arrays carry a flat grid axis of
size prod(mesh) laid out C-order (last mesh axis fastest, matching
``Cell.gen_uniform_grids``); transforms run over that axis as a 3D FFT.
XLA lowers these to the backend FFT (cuFFT on GPU); the batch (leading) axes are where
sharding happens (SURVEY.md section 2b).
"""
from __future__ import annotations

import jax.numpy as jnp


def fft3(f, mesh):
    """FFT over the last (flat grid) axis: f[..., ngrid] -> f~[..., ngrid]."""
    mesh = tuple(int(m) for m in mesh)
    shape = f.shape
    g = f.reshape(shape[:-1] + mesh)
    g = jnp.fft.fftn(g, axes=(-3, -2, -1))
    return g.reshape(shape)


def ifft3(f, mesh):
    """Inverse FFT (includes the 1/ngrid normalization, numpy convention)."""
    mesh = tuple(int(m) for m in mesh)
    shape = f.shape
    g = f.reshape(shape[:-1] + mesh)
    g = jnp.fft.ifftn(g, axes=(-3, -2, -1))
    return g.reshape(shape)
