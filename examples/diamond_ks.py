"""Diamond KS-DFT driver: LDA / PBE / PBE0 with ISDF-served two-electron
terms.

Capability beyond the reference (its drivers are HF-only,
``/root/reference/fftisdf.py:437-466``).  Pure functionals only need the
Hartree term — each SCF cycle serves J from (x_k, w0) and never builds K;
hybrids (PBE0) add ISDF exact exchange at the hybrid fraction, which is
the flagship ISDF acceleration: exact exchange is what makes hybrid DFT
for solids expensive.

Usage: python examples/diamond_ks.py [--xc lda|pbe|pbe0] [--ke 50]
       [--kmesh 1 1 2] [--c0 25] [--gpu] [--device]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--xc", default="pbe")
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[1, 1, 2])
    p.add_argument("--c0", type=float, default=25.0)
    p.add_argument("--gpu", action="store_true")
    p.add_argument("--device", action="store_true",
                   help="device-resident SCF loop (one fetch per cycle)")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf.ks import KRKS, DeviceKRKS

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)
    print(f"diamond: xc={args.xc} nao={cell.nao_nr()} "
          f"nelec={cell.nelectron} mesh={cell.mesh} nk={len(kpts)}")

    t0 = time.time()
    df = FFTISDF(cell, kpts, c0=args.c0, m0=(9, 9, 9), verbose=0).build()
    print(f"-> ISDF build: nip={df.nip} ({time.time()-t0:.1f}s)")

    cls = DeviceKRKS if args.device else KRKS
    t0 = time.time()
    mf = cls(cell, kpts, xc=args.xc, with_df=df, verbose=4, conv_tol=1e-8)
    e = mf.kernel()
    print(f"-> {'device ' if args.device else ''}KRKS/{args.xc}  "
          f"E = {e:.8f} Ha  ({time.time()-t0:.1f}s, conv={mf.converged})")

    # exact-PW Hartree cross-check (pure functionals: J is the only
    # two-electron term, so this isolates the ISDF compression error)
    if not args.device:
        t0 = time.time()
        mf0 = KRKS(cell, kpts, xc=args.xc, verbose=0, conv_tol=1e-8)
        e0 = mf0.kernel()
        print(f"-> exact-PW KRKS  E = {e0:.8f} Ha  ({time.time()-t0:.1f}s)"
              f"  |dE|/atom = {abs(e - e0)/cell.natm:.2e}")


if __name__ == "__main__":
    main()
