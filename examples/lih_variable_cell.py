"""Variable-cell relaxation driver: LiH rocksalt, cell-only BFGS.

Demonstrates scf.optimize.relax_cell: one traced cell-Lagrangian yields
stress + forces per step (scf.stress.make_cell_grad_fn), the SCF is fully
re-converged at every strained lattice with k-points deforming with the
cell, and the Lagrangian is automatically re-anchored when the accumulated
strain leaves the frozen-image-list validity.

Runs on CPU (f64) by default; pass --gpu to use the default backend in f32.

Usage: python examples/lih_variable_cell.py [--a0 6.8] [--mesh 18]
       [--relax-atoms] [--smax 1e-3] [--max-steps 20]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--a0", type=float, default=6.8, help="start a_lat (bohr)")
    p.add_argument("--mesh", type=int, default=18)
    p.add_argument("--kmesh", type=int, nargs=3, default=[1, 1, 1])
    p.add_argument("--smax", type=float, default=1e-3,
                   help="stress gate (Ha/bohr^3; all-electron egg-box "
                        "limits how low this system can go)")
    p.add_argument("--max-steps", type=int, default=20)
    p.add_argument("--relax-atoms", action="store_true")
    p.add_argument("--gpu", action="store_true")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF
    from fftisdf_tpu.scf import optimize as scf_opt

    a = 0.5 * args.a0 * (np.ones((3, 3)) - np.eye(3))  # primitive fcc
    li = [Shell(l=0, exps=np.array([16.0, 2.2]),
                coeffs=np.array([[0.8], [0.3]])),
          Shell(l=0, exps=np.array([0.6, 0.15]),
                coeffs=np.array([[0.5], [0.6]]))]
    h = [Shell(l=0, exps=np.array([1.3, 0.25]),
               coeffs=np.array([[0.5], [0.6]]))]
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    cell = Cell(a=a, atom=[("Li", frac[0] @ a), ("H", frac[1] @ a)],
                basis={"Li": li, "H": h}, pseudo=None,
                mesh=np.array([args.mesh] * 3), unit="bohr",
                precision=1e-12).build()
    mf = KRHF(cell, cell.get_kpts(args.kmesh), verbose=0, conv_tol=1e-10)

    t0 = time.time()
    res = scf_opt.relax_cell(mf, smax=args.smax, max_steps=args.max_steps,
                             relax_atoms=args.relax_atoms)
    print(f"-> relax_cell: converged={res.converged} steps={res.nsteps} "
          f"({time.time()-t0:.1f}s)")
    for i, (e, f, s) in enumerate(res.trajectory):
        print(f"   step {i}: E={e:.8f}  max|F|={f:.2e}  max|sigma|={s:.2e}")
    A = np.asarray(res.cell.a)
    print(f"-> final lattice constant a = {2*A[0,1]:.4f} bohr "
          f"(started {args.a0}); E = {res.energy:.8f} Ha")
    print(f"   final stress diag: {np.diag(res.sigma)}")


if __name__ == "__main__":
    main()
