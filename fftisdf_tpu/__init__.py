"""fftisdf_tpu — accelerator-native FFT-accelerated Interpolative Separable Density Fitting.

A from-scratch JAX/XLA framework for compressing periodic electron
repulsion integrals (ERIs) of Gaussian-basis crystals with k-point sampling,
with the capabilities of the reference research code
``yangjunjie0320/fft-isdf-scratch`` (see /root/reference), re-designed
for accelerators (the package name is historical; it runs on GPU and CPU):

- ``lattice``  — crystal cells, uniform FFT grids, k-point meshes, phase
  matrices, momentum-conservation tables (ref: pyscf Cell / k2gamma usage in
  ``fftisdf.py:28,317-322``).
- ``basis``    — embedded GTH / STO-3G basis data and a native periodic GTO
  evaluator (ref: ``pbc_eval_gto`` calls, ``fftisdf.py:367``).
- ``pseudo``   — GTH pseudopotentials (local + nonlocal) for the GPW-style SCF.
- ``linalg``   — pivoted Cholesky, batched 3D FFT helpers, reciprocal-space
  Coulomb kernel, least-squares/pinv/SVD solver variants.
- ``isdf``     — the ISDF core: interpolation-point selection, fitting-function
  solve, FFT Coulomb kernel -> w_q, J/K builders, ERI assembly, THC variant
  (ref: ``fftisdf.py``, ``fftdf-with-k*.py``, ``isdf.py``, ``k_least_square.py``).
- ``scf``      — KRHF/KUHF self-consistent field with DIIS on top of ISDF J/K.
- ``pw``       — exact plane-wave (FFTDF-equivalent) reference path used as the
  in-repo oracle (ref: pyscf ``FFTDF.get_eri`` / ``get_jk`` comparisons).
- ``parallel`` — device-mesh sharding of the build and serve paths.
- ``utils``    — config, logging/timers, serialization.
"""

__version__ = "0.1.0"

from fftisdf_tpu.lattice.cell import Cell  # noqa: F401
