"""Exciton dispersion of diamond from k-point TDA on the ISDF state.

Converges an ISDF-driven KRHF (or KRKS) on a k-mesh, then solves the TDA
response at EVERY momentum-transfer sector q of the mesh — the lowest
singlet/triplet excitation as a function of exciton momentum, plus
velocity-gauge oscillator strengths at q = 0.  A linear-response
capability far beyond the reference (it stops at ground-state HF,
``/root/reference/fftisdf.py:437-466``).

Usage: python examples/exciton_dispersion.py [--gpu] [--ke 50]
       [--kmesh 2 2 2] [--c0 40] [--xc pbe] [--nroots 3] [--eels]

--eels additionally prints the macroscopic dielectric function
eps_M(q, omega) and the EELS loss function -Im 1/eps_M at every finite-q
sector (dielectric_tda).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gpu", action="store_true")
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[2, 2, 2])
    p.add_argument("--c0", type=float, default=40.0)
    p.add_argument("--xc", default=None,
                   help="None = KRHF (CIS); else a scf.xc functional")
    p.add_argument("--nroots", type=int, default=3)
    p.add_argument("--eels", action="store_true",
                   help="print eps_M(q, omega) / loss at finite q")
    args = p.parse_args()

    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf import KRHF
    from fftisdf_tpu.scf.ks import KRKS
    from fftisdf_tpu.scf.tddft import (tda, oscillator_strengths,
                                       dielectric_tda)

    dtype = jnp.float32 if args.gpu else jnp.float64
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)
    nk = len(kpts)

    df = FFTISDF(cell, kpts, c0=args.c0, dtype=dtype, verbose=4).build()
    if args.xc:
        mf = KRKS(cell, kpts, xc=args.xc, with_df=df, dtype=dtype,
                  verbose=4)
    else:
        mf = KRHF(cell, kpts, with_df=df, dtype=dtype, verbose=4)
    mf.kernel()
    print(f"SCF converged={mf.converged}  E={mf.e_tot:.8f} Ha")

    print(f"\n{'q':>3s} {'|q| (1/bohr)':>14s} "
          + " ".join(f"{'S' + str(n):>9s}" for n in range(args.nroots))
          + " " + " ".join(f"{'T' + str(n):>9s}"
                           for n in range(args.nroots)))
    scaled = cell.get_scaled_kpts(kpts)
    for q in range(nk):
        ws, info_s = tda(mf, df, q=q, nroots=args.nroots)
        wt, _ = tda(mf, df, q=q, nroots=args.nroots, singlet=False)
        qn = float(np.linalg.norm(kpts[q]))
        print(f"{q:3d} {qn:14.6f} "
              + " ".join(f"{w:9.5f}" for w in ws)
              + " " + " ".join(f"{w:9.5f}" for w in wt))
        if q == 0 and info_s.get("x") is not None:
            f = oscillator_strengths(mf, ws, np.asarray(info_s["x"]))
            print("    q=0 velocity-gauge oscillator strengths:",
                  " ".join(f"{v:.4f}" for v in f))
        elif args.eels and qn > 1e-10:
            om = np.linspace(0.0, float(ws[-1]) + 0.3, 13)
            eps, d = dielectric_tda(mf, df, q=q, omegas=om)
            print("    eps_M(0) = %.4f; EELS loss peak %.4f at w = %.3f"
                  % (eps[0].real, d["loss"].max(),
                     om[int(np.argmax(d["loss"]))]))


if __name__ == "__main__":
    main()
