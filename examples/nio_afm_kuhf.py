"""NiO antiferromagnetic KUHF with ISDF J/K — the north-star configuration
(BASELINE.md): the reference's target system (``nio-afm.vasp``,
``fftisdf.py:412-473`` driver with KRHF; AFM needs KUHF).

Note: the embedded Ni q18 GTH pseudo is an in-repo refit by the GTH-96
procedure and the Ni basis columns are pseudo-atom-derived surrogates
(provenance notes in fftisdf_tpu/basis/data.py); the ISDF-vs-exact
comparison is exact regardless, absolute energies are not comparable to
external codes until verified CP2K tables are dropped in
(FFTISDF_TPU_CP2K_BASIS / FFTISDF_TPU_CP2K_POTENTIALS).

Usage: python examples/nio_afm_kuhf.py [--ke 50] [--kmesh 1 1 2] [--c0 20]
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
    p.add_argument("--c0", type=float, default=20.0)
    p.add_argument("--exact", action="store_true",
                   help="also run the exact plane-wave KUHF for comparison")
    p.add_argument("--gpu", action="store_true")
    p.add_argument("--level-shift", type=float, default=0.0)
    p.add_argument("--smearing", type=float, default=5e-3,
                   help="Fermi smearing sigma in Ha (0 = fixed occupations "
                        "+ level shift, the pre-smearing scheme)")
    p.add_argument("--basis", default="gth-szv",
                   help="e.g. gth-dzvp-molopt-sr (the reference driver's "
                        "basis, fftisdf.py:423)")
    p.add_argument("--production", action="store_true",
                   help="the reference driver's full config on the GPU "
                        "(fftisdf.py:423-432): 4x4x4, gth-dzvp-molopt-sr, "
                        "ke=200, c0=40, device-resident SCF")
    p.add_argument("--order", default="afm", choices=["afm", "fm", "pm"],
                   help="magnetic order of the initial guess: afm "
                        "(opposite Ni spins), fm (parallel), pm "
                        "(unpolarized) — running all three compares the "
                        "self-consistent magnetic ground states")
    p.add_argument("--xc", default=None,
                   help="run KS-DFT (KUKS) instead of KUHF: lda|pbe|pbe0")
    p.add_argument("--hubbard-u", type=float, default=0.0, metavar="EV",
                   help="DFT+U on the Ni d shells, U_eff in eV (needs "
                        "--xc; ~6.2 eV is the common NiO literature value)")
    args = p.parse_args()
    if args.production:
        args.ke, args.kmesh, args.c0 = 200.0, [4, 4, 4], 40.0
        args.basis, args.gpu = "gth-dzvp-molopt-sr", True
    if args.smearing == 0.0 and args.level_shift == 0.0:
        args.level_shift = 0.3

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf import KUHF

    cell = structure.to_cell(*structure.nio_afm(), basis=args.basis,
                             pseudo="gth-pade", ke_cutoff=args.ke,
                             exp_to_discard=0.1)
    kpts = cell.get_kpts(args.kmesh)
    print(f"NiO AFM: nao={cell.nao_nr()} nelec={cell.nelectron} "
          f"mesh={cell.mesh} nk={len(kpts)}")

    # magnetic order via the initial spin bias on the two Ni sites (atoms
    # 0, 1); the SCF then relaxes to the nearest self-consistent state
    init_spin = {"afm": {0: +1.0, 1: -1.0},
                 "fm": {0: +1.0, 1: +1.0},
                 "pm": {}}[args.order]

    t0 = time.time()
    m0 = tuple(min(15, int(m)) for m in cell.mesh)
    df = FFTISDF(cell, kpts, c0=args.c0, m0=m0, verbose=3).build()
    print(f"ISDF build: {time.time()-t0:.1f}s, nip={df.nip}")

    # on the GPU use the device-resident SCF loop (scf.device): one small
    # fetch per cycle instead of moving vj/vk/fock between host and device
    ks_kwargs = {}
    if args.xc is not None:
        # KS-DFT path: KUKS with optional DFT+U on the Ni d shells (the
        # production method for NiO — pure functionals alone close neither
        # the gap nor the AFM order; scf.hubbard)
        from fftisdf_tpu.scf.ks import KUKS, DeviceKUKS
        ks_kwargs["xc"] = args.xc
        if args.hubbard_u > 0.0:
            u_ha = args.hubbard_u / 27.211386
            ks_kwargs["hubbard"] = {0: (2, u_ha), 1: (2, u_ha)}
        host_cls, dev_cls = KUKS, DeviceKUKS  # +U traced in-loop too
    else:
        from fftisdf_tpu.scf.device import DeviceKUHF
        host_cls, dev_cls = KUHF, DeviceKUHF
    if args.gpu and args.level_shift == 0.0:
        _KUHF = dev_cls
        conv_tol = 1e-6   # f32 J/K noise floor
    else:
        _KUHF = host_cls
        conv_tol = 1e-8
    mf = _KUHF(cell, kpts, with_df=df, verbose=3, conv_tol=conv_tol,
               max_cycle=80, init_spin=init_spin,
               level_shift=args.level_shift, smearing=args.smearing,
               **ks_kwargs)
    t0 = time.time()
    e = mf.kernel()
    # local spin moments (Mulliken, diagonal of dm.S per atom)
    from fftisdf_tpu.scf.analysis import atom_charges_and_moments
    _charges, moments = atom_charges_and_moments(cell, mf.dm, mf.s1e)
    print(f"-> ISDF KUHF E = {e:.8f} Ha  ({time.time()-t0:.1f}s, "
          f"conv={mf.converged})")
    print("-> atomic spin moments:",
          " ".join(f"{sym}:{m:+.3f}" for (sym, _), m in zip(cell.atom, moments)))

    if args.exact:
        mf0 = host_cls(cell, kpts, verbose=0, conv_tol=1e-8, max_cycle=80,
                       init_spin=init_spin, level_shift=args.level_shift,
                       smearing=args.smearing, **ks_kwargs)
        e0 = mf0.kernel()
        print(f"-> exact-PW KUHF E = {e0:.8f} Ha (conv={mf0.converged})")
        print(f"-> dE/atom = {abs(e-e0)/cell.natm:.2e} Ha")


if __name__ == "__main__":
    main()
