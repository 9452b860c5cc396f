"""Geometry relaxation + vibrational analysis driver.

Relaxes an H2 molecule in a periodic box with BFGS on the analytic
reverse-mode forces (scf.optimize), then computes harmonic frequencies from
the FD-of-analytic-forces Hessian (scf.hessian).  A capability chain the
reference (single-point numpy scripts on PySCF) does not have at all.

Runs on CPU (f64) by default; pass --gpu to use the default backend in f32.

Usage: python examples/relax_vibrations.py [--mesh 20] [--d0 2.0] [--isdf]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", type=int, default=20)
    p.add_argument("--d0", type=float, default=2.0, help="start bond (bohr)")
    p.add_argument("--box", type=float, default=8.0)
    p.add_argument("--isdf", action="store_true",
                   help="ISDF force backend (per-geometry rebuilt)")
    p.add_argument("--gpu", action="store_true")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF
    from fftisdf_tpu.scf import optimize as scf_opt
    from fftisdf_tpu.scf import hessian as scf_hess

    box = args.box
    shells = [Shell(l=0, exps=np.array([1.3, 0.25]),
                    coeffs=np.array([[0.5], [0.6]]))]
    cell = Cell(
        a=np.diag([box, box, box]),
        atom=[("H", np.array([box / 2, box / 2, box / 2 - args.d0 / 2])),
              ("H", np.array([box / 2, box / 2, box / 2 + args.d0 / 2]))],
        basis={"H": shells}, pseudo=None,
        mesh=np.array([args.mesh] * 3), unit="bohr", precision=1e-12,
    ).build()

    mf = KRHF(cell, cell.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-10)
    backend = "isdf" if args.isdf else "pw"
    kw = ({"isdf_kwargs": {"c0": 40.0, "m0": (9, 9, 9)}}
          if args.isdf else {})

    t0 = time.time()
    res = scf_opt.kernel(mf, fmax=5e-4, max_steps=20, two_electron=backend,
                         **kw)
    bond = np.linalg.norm(res.positions[1] - res.positions[0])
    print(f"-> relaxation ({backend}): converged={res.converged} "
          f"steps={res.nsteps} E={res.energy:.8f} Ha bond={bond:.4f} bohr "
          f"({time.time()-t0:.1f}s)")
    for i, (pos, e, f) in enumerate(res.trajectory):
        d = np.linalg.norm(pos[1] - pos[0])
        print(f"   step {i}: E={e:.8f}  max|F|={f:.2e}  d={d:.4f}")

    t0 = time.time()
    hess, g0 = scf_hess.kernel(res.mf, step=1.5e-3)
    wav, _ = scf_hess.frequencies(res.mf.cell, hess)
    print(f"-> harmonic frequencies (cm^-1): {np.round(wav, 1)} "
          f"({time.time()-t0:.1f}s)")
    print(f"   (3 projected translations ~0; stretch "
          f"{np.abs(wav).max():.1f} cm^-1)")


if __name__ == "__main__":
    main()
