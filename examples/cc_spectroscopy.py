"""Coupled-cluster spectroscopy demo on the ISDF factorization.

Runs the full correlated stack on a periodic hydrogen chain (the CC
fixture system): KRHF -> FFTISDF -> CCSD -> (T) -> EOM-EE optical
excitations -> k-resolved EOM-IP/EA quasiparticle energies and the
correlated fundamental gap, comparing the latter against the Koopmans
(mean-field band) values.

The reference repository has no correlated method; its furthest gesture
is the unfinished embedding transform (``/root/reference/
fftisdf.py:230-294``).  Everything here is served from the same
(x_k, w_q) ISDF state built once.

Usage: python examples/cc_spectroscopy.py [--nk 2] [--gpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nk", type=int, default=2, help="k-points along z")
    p.add_argument("--c0", type=float, default=60.0)
    p.add_argument("--gpu", action="store_true")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF
    from fftisdf_tpu.scf import cc
    from fftisdf_tpu.isdf import FFTISDF

    lz = 7.0
    cell = Cell(
        a=np.diag([6.0, 6.0, lz]),
        atom=[("H", (3.0, 3.0, 1.8)), ("H", (3.0, 3.0, 3.2))],
        basis={"H": [Shell(l=0, exps=np.array([1.2, 0.4]),
                           coeffs=np.eye(2))]},
        pseudo="gth-pade",
        mesh=np.array([14, 14, 15]),
        unit="bohr",
        precision=1e-12,
    ).build()
    kpts = cell.get_kpts([1, 1, args.nk])
    dtype = jnp.float64 if not args.gpu else jnp.float32

    t0 = time.perf_counter()
    mf = KRHF(cell, kpts, verbose=0, conv_tol=1e-10)
    mf.kernel()
    print(f"KRHF      E = {mf.e_tot:+.8f} Ha   "
          f"(conv={mf.converged}, {time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    df = FFTISDF(cell, kpts, c0=args.c0, m0=(11, 11, 13), verbose=0,
                 select_tol=1e-18, rcond=1e-12, dtype=dtype).build()
    print(f"ISDF build: nip={df.nip}  ({time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    e_cc, e_t, info = cc.kccsd_t(df, mf, conv_tol=1e-9)
    print(f"CCSD      Ecorr = {e_cc:+.8f} Ha/cell "
          f"({info['niter']} cycles, {time.perf_counter()-t0:.1f}s)")
    print(f"(T)       Ecorr = {e_t:+.8f} Ha/cell")
    print(f"CCSD(T)   E = {mf.e_tot + e_cc + e_t:+.8f} Ha/cell")

    t0 = time.perf_counter()
    w_ee, _ = cc.eomee_davidson(df, mf, nroots=3, conv_tol=1e-9)
    print(f"EOM-EE (q=0, Davidson) lowest: "
          f"{np.array2string(w_ee.real, precision=4)} Ha "
          f"({time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    w_ip, _ = cc.eomip(df, mf, conv_tol=1e-9)
    w_ea, _ = cc.eomea(df, mf, conv_tol=1e-9)
    print(f"quasiparticles ({time.perf_counter()-t0:.1f}s):")
    homo = lumo = None
    for k in range(len(kpts)):
        ip_k = np.min(w_ip[k].real)        # valence binding at k
        ea_k = np.min(w_ea[k].real)        # conduction energy at k
        e_mf = np.asarray(mf.mo_energy)[k]
        print(f"  k{k}:  IP = {ip_k:+.4f} (Koopmans {-e_mf[0]:+.4f})   "
              f"EA = {ea_k:+.4f} (Koopmans {e_mf[1]:+.4f})")
        homo = ip_k if homo is None else min(homo, ip_k)
        lumo = ea_k if lumo is None else min(lumo, ea_k)
    print(f"correlated fundamental gap  IP+EA = {homo + lumo:+.4f} Ha")

    from fftisdf_tpu.scf.gw import g0w0

    t0 = time.perf_counter()
    e_qp, gw_info = g0w0(df, mf, nw=32)
    print(f"G0W0 quasiparticles ({time.perf_counter()-t0:.1f}s):")
    for k in range(len(kpts)):
        z = gw_info["z"][k]
        print(f"  k{k}:  HOMO = {e_qp[k, 0]:+.4f} (Z={z[0]:.2f})   "
              f"LUMO = {e_qp[k, 1]:+.4f} (Z={z[1]:.2f})")
    gw_gap = e_qp[:, 1].min() - e_qp[:, 0].max()
    print(f"G0W0 fundamental gap = {gw_gap:+.4f} Ha "
          f"(EOM-CC {homo + lumo:+.4f})")


if __name__ == "__main__":
    main()
