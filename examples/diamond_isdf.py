"""Diamond FFT-ISDF driver: build, validate ERIs/J/K against the exact
plane-wave path, run KRHF both ways.

Native analog of the reference drivers (``fftisdf.py:412-473`` and
``fftdf-with-k.py:173-257``).  Runs on CPU (f64) by default; pass --gpu to
use the default backend in f32.

Usage: python examples/diamond_isdf.py [--ke 50] [--kmesh 2 2 2] [--c0 25]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[1, 1, 2])
    p.add_argument("--c0", type=float, default=25.0)
    p.add_argument("--gpu", action="store_true")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf import KRHF

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)
    print(f"diamond: nao={cell.nao_nr()} nelec={cell.nelectron} "
          f"mesh={cell.mesh} nk={len(kpts)}")

    t0 = time.time()
    mf0 = KRHF(cell, kpts, verbose=0, conv_tol=1e-9)
    e0 = mf0.kernel()
    print(f"-> exact-PW KRHF  E = {e0:.8f} Ha  ({time.time()-t0:.1f}s, "
          f"conv={mf0.converged})")

    t0 = time.time()
    df = FFTISDF(cell, kpts, c0=args.c0, m0=(9, 9, 9), verbose=0).build()
    t_build = time.time() - t0
    mf1 = KRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-9)
    e1 = mf1.kernel()
    print(f"-> ISDF KRHF      E = {e1:.8f} Ha  (build {t_build:.1f}s, "
          f"conv={mf1.converged}, nip={df.nip})")
    print(f"-> ISDF c0={args.c0}: dE/atom = {abs(e1-e0)/cell.natm:.2e} Ha")


if __name__ == "__main__":
    main()
