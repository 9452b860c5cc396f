"""Phonon dispersion + elastic constants driver.

Frozen-phonon force constants on a supercell (scf.phonon: home-cell
displacements, analytic force response on every supercell atom), harmonic
thermodynamics on a BZ q-sample, and the Voigt elastic tensor by central
FD of the analytic stress (scf.elastic).  Second-derivative capabilities
the reference (single-point numpy scripts on PySCF) does not have at all.

Runs on CPU (f64) by default; pass --gpu to use the default backend in f32.

Usage: python examples/phonon_elastic.py [--nrep 2] [--mesh 12] [--temp 300]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", type=int, default=12, help="transverse FFT mesh")
    p.add_argument("--a", type=float, default=2.2, help="chain spacing, bohr")
    p.add_argument("--box", type=float, default=7.0)
    p.add_argument("--nrep", type=int, default=2, help="supercell along z")
    p.add_argument("--temp", type=float, default=300.0)
    p.add_argument("--qha", action="store_true",
                   help="quasi-harmonic thermal expansion of an H2 "
                        "molecular chain (E(V) scan + Gamma phonons per "
                        "volume + F(V,T) minimization + Grueneisen)")
    p.add_argument("--gpu", action="store_true")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF
    from fftisdf_tpu.scf import elastic, phonon
    from fftisdf_tpu.scf.hessian import HARTREE_TO_CM1  # noqa: F401

    if args.qha:
        from fftisdf_tpu.lattice import structure
        from fftisdf_tpu.scf import eos

        # GTH H2 chain with the bond tuned so p = 0 falls inside the scan
        # (co-scaled bond tension vs intermolecular chain repulsion)
        axy, az, dz = 6.0, 4.5, 0.54
        cell = structure.to_cell(
            np.diag([axy, axy, az]),
            [("H", np.array([axy / 2, axy / 2, az / 2 - dz])),
             ("H", np.array([axy / 2, axy / 2, az / 2 + dz]))],
            basis="gth-szv", pseudo="gth-pade", ke_cutoff=30.0)
        mf = KRHF(cell, cell.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11)
        mf.kernel()
        t0 = time.time()
        out = eos.qha_kernel(mf, [0.0, args.temp],
                             scales=np.linspace(0.94, 1.06, 5),
                             nrep=(1, 1, 1), step=2e-3)
        print(f"[qha] 5-volume scan + Gamma phonons in "
              f"{time.time()-t0:.1f} s")
        g = out["gamma"][0]
        mask = out["gamma_mask"]
        print("  mode gammas (optical): " +
              " ".join(f"{x:7.3f}" for x in g[mask[0]]))

        # this stiff toy's optical modes are frozen at room temperature
        # (w ~ 2000+ cm^-1), so also report at kT = hbar*w_min where the
        # expansion is actually active — recomputed from the recorded
        # spectra, no new SCF
        freqs, res = out["freqs_cm"], out["eos"]
        w_ha = np.clip(freqs, 0.0, None) / HARTREE_TO_CM1
        t1 = freqs[:, mask].min() / HARTREE_TO_CM1 / phonon.KB_HA
        # qha's central differences assume strictly increasing temperatures
        # (--temp above 0.7*t1 would otherwise scramble the stencil)
        ts = sorted({0.0, float(args.temp), 0.7 * t1, t1, 1.3 * t1})
        floor = 1.0 / HARTREE_TO_CM1   # drop ASR/noise residue modes

        def f_vib(iv, t):
            w = w_ha[iv][w_ha[iv] > floor]
            if t <= 0.0:
                return w.sum() / 2.0 / w_ha.shape[1]
            return (w / 2.0 + phonon.KB_HA * t
                    * np.log1p(-np.exp(-w / (phonon.KB_HA * t)))
                    ).sum() / w_ha.shape[1]

        fv = np.array([[f_vib(iv, t) for iv in range(res.volumes.size)]
                       for t in ts])
        ref = eos.qha(res.volumes, res.energies, fv, np.asarray(ts))
        for i, t in enumerate(ts):
            ag = (eos.gruneisen(res.volumes, freqs, temperature=float(t),
                                b0=ref["b0"][i], v0=ref["v0"][i])["alpha_v"]
                  if t > 0 else float("nan"))
            print(f"  T={t:7.1f} K  V0={ref['v0'][i]:9.4f} bohr^3  "
                  f"B0={ref['b0_gpa'][i]:8.3f} GPa  "
                  f"alpha_V(FD)={ref['alpha_v'][i]:11.4e}  "
                  f"alpha_V(Grueneisen)={ag:11.4e} 1/K")

        # cross-gate (the tests/test_eos.py regime): at T = 700 K on the
        # crossing-free first 4 volumes the two independent
        # thermal-expansion routes must agree in sign and decade
        vols4, e4, f4 = res.volumes[:4], res.energies[:4], freqs[:4]
        w4 = np.clip(f4, 0.0, None) / HARTREE_TO_CM1
        floor4 = 1.0 / HARTREE_TO_CM1
        tg = np.array([560.0, 700.0, 840.0])
        fv4 = np.array([[ (w4[iv][w4[iv] > floor4] / 2.0
                           + phonon.KB_HA * t * np.log1p(
                               -np.exp(-w4[iv][w4[iv] > floor4]
                                       / (phonon.KB_HA * t)))).sum()
                          / w4.shape[1]
                          for iv in range(vols4.size)] for t in tg])
        rg = eos.qha(vols4, e4, fv4, tg)
        a_fd = rg["alpha_v"][1]
        a_gr = eos.gruneisen(vols4, f4, temperature=700.0, b0=rg["b0"][1],
                             v0=rg["v0"][1])["alpha_v"]
        assert a_fd > 1e-6 and a_gr > 1e-6 and 0.1 < a_gr / a_fd < 10.0, \
            (a_fd, a_gr)
        print(f"  [cross-gate] T=700 K: alpha_FD={a_fd:.3e} "
              f"alpha_Grueneisen={a_gr:.3e} 1/K — sign+decade agreement OK")
        return

    shells = [Shell(l=0, exps=np.array([2.5, 0.7]),
                    coeffs=np.array([[0.6], [0.5]]))]
    b, az = args.box, args.a
    mz = max(6, int(round(args.mesh * az / b)) // 2 * 2)
    cell = Cell(a=np.diag([b, b, az]),
                atom=[("He", np.array([b / 2, b / 2, 0.0]))],
                basis={"He": shells}, pseudo=None,
                mesh=np.array([args.mesh, args.mesh, mz]),
                unit="bohr", precision=1e-12).build()
    mf = KRHF(cell, cell.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11)

    t0 = time.time()
    nrep = (1, 1, args.nrep)
    res = phonon.kernel(mf, nrep, step=2e-3)
    print(f"[phonon] supercell {nrep} SCF+FC in {time.time()-t0:.1f} s, "
          f"E_sc = {res.e_sc:.8f} Ha")
    qline = np.linspace(0.0, 0.5, 6)[:, None] * \
        cell.reciprocal_vectors()[2][None, :]
    w = res.frequencies(qline)
    for frac, wq in zip(np.linspace(0.0, 0.5, 6), w):
        print(f"  q = {frac:4.2f} * b3 : " +
              " ".join(f"{x:9.2f}" for x in wq) + "  cm^-1")
    try:
        th = res.thermodynamics((1, 1, 8), args.temp)
    except ValueError:
        # a free-standing chain buckles: the transverse branches are
        # genuinely imaginary (no harmonic free energy exists for them);
        # report the stable longitudinal subspace instead
        print("[thermo] transverse branches imaginary (free-standing "
              "chain buckles) - longitudinal subspace only:")
        fc_l = res.fc[:, 2:, :, :, 2:]
        th = phonon.thermodynamics(fc_l, res.masses_me, res.images,
                                   cell, (1, 1, 8), args.temp)
    print(f"[thermo] T={args.temp:.0f} K  ZPE={th['zpe']*1e3:.3f} mHa  "
          f"F_vib={th['f_vib']*1e3:.3f} mHa  Cv/kB="
          f"{th['cv']/phonon.KB_HA:.3f}")

    # --- elastic constants of the simple-cubic He crystal
    a0 = 4.0
    cub = Cell(a=np.diag([a0] * 3), atom=[("He", np.zeros(3))],
               basis={"He": shells}, pseudo=None,
               mesh=np.array([10, 10, 10]), unit="bohr",
               precision=1e-12).build()
    mfc = KRHF(cub, cub.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11)
    mfc.kernel()
    t0 = time.time()
    er = elastic.kernel(mfc, step=3e-3, components=(0, 3))
    print(f"[elastic] 2 Voigt components in {time.time()-t0:.1f} s")
    cg = er.c_gpa
    print(f"  C11 = {cg[0, 0]:9.3f} GPa   C12 = {cg[1, 0]:9.3f} GPa   "
          f"C44 = {cg[3, 3]:9.3f} GPa")
    print(f"  sigma0 diag (GPa): " +
          " ".join(f"{x*elastic.HA_PER_BOHR3_TO_GPA:8.3f}"
                   for x in np.diag(er.sigma0)))


if __name__ == "__main__":
    main()
