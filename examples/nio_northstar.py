"""North-star SCF run (BASELINE.md): converged NiO AFM KUHF on the GPU.

Produces the committed evidence the round-2 verdict asked for (item 3):

  part A — accuracy CURVE: ISDF-served KUHF vs exact plane-wave KUHF on a
           reduced k-mesh (both fully converged), swept over (c0, m0) —
           the reference's fixed 15^3 selection mesh next to the auto
           (cutoff-derived, auto-densifying) mesh at rising c0 — so the
           committed artifact shows WHERE the energy error converges and
           which knob moves it (round-3 verdict item #1).  On an f32 device
           the curve floors at the f32 J/K noise of oracle+serve; the
           --a64 mode records the same curve on CPU f64 at a smaller
           config, where the true ISDF-form convergence to the
           <1e-6 Ha/atom BASELINE bar is measurable;
  part B — production: the reference driver's full config (NiO AFM 4x4x4,
           gth-dzvp-molopt-sr, ke=200, c0=40, m0=15^3 —
           ``/root/reference/fftisdf.py:423-432,461-462``) run to SCF
           convergence with the device-resident loop, recording converged
           energy, iteration count, wall/iteration and the ISDF build time.

ONE process (CLAUDE.md: in-process jit reuse always works; cross-process
compile-cache behavior is unreliable), incremental JSON lines per part to
stdout AND appended to the artifact file, so a timeout loses only the
unfinished part.

Usage:  python examples/nio_northstar.py [--out artifacts/nio_scf.json]
        [--skip-a] [--skip-b] [--ke-a 100] [--kmesh-a 2 2 2] [--cpu]

Note: absolute energies use the in-repo Ni q18 refit + surrogate molopt-sr
columns (basis/data.py provenance); the ISDF-vs-exact DELTA in part A is
exact regardless (same basis on both sides).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def emit(path, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(path, "a") as f:
        f.write(line + "\n")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="artifacts/nio_scf.json")
    p.add_argument("--skip-a", action="store_true")
    p.add_argument("--skip-b", action="store_true")
    p.add_argument("--ke-a", type=float, default=100.0)
    p.add_argument("--kmesh-a", type=int, nargs=3, default=[2, 2, 2])
    p.add_argument("--c0", type=float, default=40.0)
    p.add_argument("--smearing", type=float, default=5e-3)
    p.add_argument("--damp", type=float, default=0.0,
                   help="linear density mixing (0.2-0.5 tames the "
                        "production d-manifold oscillation)")
    p.add_argument("--max-cycle", type=int, default=80)
    p.add_argument("--cpu", action="store_true",
                   help="CPU f64 debug run (tiny settings advised)")
    p.add_argument("--a64", action="store_true",
                   help="run ONLY the f64 accuracy curve on CPU (NiO szv "
                        "ke=60 1x1x2: the exact oracle is f64-affordable "
                        "there, so the curve is free of f32 floors)")
    p.add_argument("--dzvp", action="store_true",
                   help="run ONLY the PRODUCTION-BASIS accuracy curve "
                        "(part A at gth-dzvp-molopt-sr ke=200 on the "
                        "2x2x2 sub-mesh, where the exact oracle fits one "
                        "chip — the round-4 verdict's top ask): ISDF-vs-"
                        "exact KUHF energy deltas over (c0, pool density) "
                        "past the old 23^3 selection guard")
    p.add_argument("--exact-e", type=float, default=None,
                   help="reuse a previously recorded converged exact "
                        "energy for the --dzvp curve (skips the ~30 min "
                        "exact arm; pass --dm-seed too, else curve points "
                        "start from the default init guess and UHF basin "
                        "differences contaminate the deltas)")
    p.add_argument("--dm-seed", default=None,
                   help="path to a saved converged density (.npy) used to "
                        "warm-start every --dzvp curve point (written by "
                        "the exact arm as <out-dir>/nio_dzvp_exact_dm.npy)")
    args = p.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax
    if args.cpu or args.a64:
        # platform pin must precede ANY backend touch (the a64 curve is a
        # pure-CPU f64 run; enable_persistent_cache below would otherwise
        # instantiate the GPU client first and c128 jits would route there)
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.utils.device import enable_persistent_cache

    enable_persistent_cache()
    backend = jax.default_backend()
    emit(args.out, {"part": "meta", "backend": backend,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S")})

    init_spin = {0: +1.0, 1: -1.0}   # AFM order on the two Ni sites

    # ---------------- part A64: f64 accuracy curve (CPU) ----------------
    if args.a64:
        from fftisdf_tpu.scf import KUHF

        cell = structure.to_cell(*structure.nio_afm(), basis="gth-szv",
                                 pseudo="gth-pade", ke_cutoff=60.0,
                                 exp_to_discard=0.1)
        kpts = cell.get_kpts([1, 1, 2])
        # warm-start the EXACT oracle from a converged dense-pool ISDF
        # fixed point (round-4's control ran from scratch and never
        # converged: 120 cycles / 2368 s / converged=false — which made
        # the 2-4e-5 deltas against it suggestive, not probative).  The
        # two fixed points differ by ~1e-4 in the density, so the exact
        # arm needs only the final polish cycles; warm-starting cannot
        # bias the self-consistent solution it converges TO.
        df_w = FFTISDF(cell, kpts, c0=60.0, m0="auto", verbose=0)
        df_w.build()
        mf_w = KUHF(cell, kpts, with_df=df_w, verbose=0, conv_tol=1e-9,
                    max_cycle=150, init_spin=init_spin,
                    smearing=args.smearing)
        mf_w.kernel()
        dm_seed = mf_w.dm
        del df_w, mf_w
        mf0 = KUHF(cell, kpts, verbose=3, conv_tol=1e-9, max_cycle=150,
                   init_spin=init_spin, smearing=args.smearing)
        t0 = time.perf_counter()
        e_exact = mf0.kernel(dm0=dm_seed)
        emit(args.out, {"part": "A64_exact", "basis": "gth-szv",
                        "ke_cutoff": 60.0, "kmesh": [1, 1, 2],
                        "e_exact_ha": e_exact,
                        "converged": bool(mf0.converged),
                        "cycles": int(getattr(mf0, "cycles", -1)),
                        "scf_s": round(time.perf_counter() - t0, 2),
                        "warm_start": "converged c0=60 auto-pool ISDF"})
        for c0x in (20.0, 40.0, 60.0, 80.0):
            t0 = time.perf_counter()
            df = FFTISDF(cell, kpts, c0=c0x, m0="auto", verbose=0)
            df.build()
            t_build = time.perf_counter() - t0
            mf = KUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-9,
                      max_cycle=150, init_spin=init_spin,
                      smearing=args.smearing)
            t0 = time.perf_counter()
            e_isdf = mf.kernel(dm0=mf0.dm)
            emit(args.out, {
                "part": "A64_curve_point", "c0": c0x,
                "m0": [int(v) for v in df.m0], "nip": int(df.nip),
                "de_per_atom_ha": abs(e_isdf - e_exact) / cell.natm,
                "e_isdf_ha": e_isdf, "converged": bool(mf.converged),
                "build_s": round(t_build, 2),
                "scf_s": round(time.perf_counter() - t0, 2)})
            del df, mf
        emit(args.out, {"part": "done_a64"})
        return

    # ------------- part A-dzvp: production-basis accuracy curve ---------
    if args.dzvp:
        from fftisdf_tpu.scf import KUHF
        from fftisdf_tpu.scf.device import DeviceKUHF

        cell = structure.to_cell(*structure.nio_afm(),
                                 basis="gth-dzvp-molopt-sr",
                                 pseudo="gth-pade", ke_cutoff=200.0,
                                 exp_to_discard=0.1)
        kpts = cell.get_kpts([2, 2, 2])
        cls = KUHF if backend == "cpu" else DeviceKUHF
        conv = 1e-8 if backend == "cpu" else 1e-6

        dm_seed = None
        if args.dm_seed:
            dm_seed = np.load(args.dm_seed)
        if args.exact_e is not None:
            e_exact = float(args.exact_e)
        else:
            # exact arm: plane-wave J/K at the full ke=200 mesh each cycle
            # (the r04 bench timed this serve at ~60 s/JK on the chip)
            mf0 = KUHF(cell, kpts, verbose=3, conv_tol=conv,
                       max_cycle=args.max_cycle, init_spin=init_spin,
                       smearing=args.smearing)
            t0 = time.perf_counter()
            e_exact = mf0.kernel()
            dm_seed = mf0.dm
            # persist the converged density: every curve point (and any
            # rerun) must start from the SAME SCF basin — UHF NiO has
            # nearby AFM solutions 0.01-0.04 Ha/atom apart, far above the
            # ISDF errors the curve measures
            np.save(os.path.join(os.path.dirname(args.out) or ".",
                                 "nio_dzvp_exact_dm.npy"),
                    np.asarray(dm_seed))
            emit(args.out, {"part": "Adzvp_exact", "system": "NiO AFM",
                            "basis": "gth-dzvp-molopt-sr",
                            "ke_cutoff": 200.0,
                            "kmesh": [2, 2, 2], "nao": cell.nao_nr(),
                            "e_exact_ha": e_exact,
                            "converged": bool(mf0.converged),
                            "scf_exact_s": round(
                                time.perf_counter() - t0, 2),
                            "smearing_ha": args.smearing})
        # (c0, pool) curve: the reference's own point, then pool density
        # rising past the round-4 guard (23^3) at fixed c0, then c0 rising
        # on the dense pool — separates the two knobs.  c0=52 stays under
        # the 2x2x2 pair-space rank (~3440); c0=60 exceeds it and runs
        # with the near-null guard (select_keep) at a tolerance just above
        # the selection rank floor — the bench accuracy_grid measured a
        # vk blow-up to 3.7e3 there without the guard.
        curve = [(40.0, tuple(min(15, int(m)) for m in cell.mesh), None),
                 (40.0, (23, 23, 23), None), (40.0, (29, 29, 29), None),
                 (52.0, (29, 29, 29), None),
                 (60.0, (31, 31, 31), 1e-11)]
        for c0x, m0x, keep in curve:
            try:
                t0 = time.perf_counter()
                df = FFTISDF(cell, kpts, c0=c0x, m0=m0x, verbose=0,
                             max_memory_gb=12.0, select_keep=keep)
                df.build()
                t_build = time.perf_counter() - t0
                mf = cls(cell, kpts, with_df=df, verbose=0, conv_tol=conv,
                         max_cycle=args.max_cycle, init_spin=init_spin,
                         smearing=args.smearing)
                t0 = time.perf_counter()
                e_isdf = mf.kernel(dm0=dm_seed)
                emit(args.out, {
                    "part": "Adzvp_curve_point", "c0": c0x,
                    "m0": [int(v) for v in df.m0], "nip": int(df.nip),
                    "de_per_atom_ha": abs(e_isdf - e_exact) / cell.natm,
                    "e_isdf_ha": e_isdf, "converged": bool(mf.converged),
                    "cycles": int(getattr(mf, "cycles", -1)),
                    "select_s": round(getattr(df, "_t_select", -1.0), 2),
                    "isdf_build_s": round(t_build, 2),
                    "scf_isdf_s": round(time.perf_counter() - t0, 2)})
                del df, mf
            except Exception as e:  # noqa: BLE001 — record, keep curving
                emit(args.out, {"part": "Adzvp_curve_point", "c0": c0x,
                                "m0": list(m0x),
                                "error": f"{type(e).__name__}: {e}"[:300]})
        emit(args.out, {"part": "done_dzvp"})
        return

    # ---------------- part A: ISDF-vs-exact accuracy curve --------------
    if not args.skip_a:
        from fftisdf_tpu.scf import KUHF
        from fftisdf_tpu.scf.device import DeviceKUHF

        cell = structure.to_cell(*structure.nio_afm(), basis="gth-szv",
                                 pseudo="gth-pade", ke_cutoff=args.ke_a,
                                 exp_to_discard=0.1)
        kpts = cell.get_kpts(args.kmesh_a)
        cls = KUHF if backend == "cpu" else DeviceKUHF
        conv = 1e-8 if backend == "cpu" else 1e-6

        # exact arm first: every curve point compares against it, and its
        # converged density warm-starts the ISDF arms (same fixed point,
        # fewer cycles)
        mf0 = KUHF(cell, kpts, verbose=0, conv_tol=conv,
                   max_cycle=args.max_cycle, init_spin=init_spin,
                   smearing=args.smearing)
        t0 = time.perf_counter()
        e_exact = mf0.kernel()
        t_exact = time.perf_counter() - t0
        emit(args.out, {"part": "A_exact", "system": "NiO AFM",
                        "basis": "gth-szv", "ke_cutoff": args.ke_a,
                        "kmesh": args.kmesh_a, "nao": cell.nao_nr(),
                        "e_exact_ha": e_exact,
                        "converged": bool(mf0.converged),
                        "scf_exact_s": round(t_exact, 2),
                        "smearing_ha": args.smearing})

        curve = [(args.c0, tuple(min(15, int(m)) for m in cell.mesh)),
                 (args.c0, "auto"), (60.0, "auto"), (80.0, "auto")]
        for c0x, m0x in curve:
            t0 = time.perf_counter()
            df = FFTISDF(cell, kpts, c0=c0x, m0=m0x, verbose=0)
            df.build()
            t_build = time.perf_counter() - t0
            mf = cls(cell, kpts, with_df=df, verbose=0, conv_tol=conv,
                     max_cycle=args.max_cycle, init_spin=init_spin,
                     smearing=args.smearing)
            t0 = time.perf_counter()
            e_isdf = mf.kernel(dm0=mf0.dm)
            t_isdf = time.perf_counter() - t0
            emit(args.out, {
                "part": "A_curve_point", "c0": c0x,
                "m0": [int(v) for v in df.m0], "nip": int(df.nip),
                "de_per_atom_ha": abs(e_isdf - e_exact) / cell.natm,
                "e_isdf_ha": e_isdf, "converged": bool(mf.converged),
                "cycles": int(getattr(mf, "cycles", -1)),
                "isdf_build_s": round(t_build, 2),
                "scf_isdf_s": round(t_isdf, 2)})
            del df, mf

    # ---------------- part B: production config to convergence ----------
    if not args.skip_b:
        from fftisdf_tpu.scf.device import DeviceKUHF
        from fftisdf_tpu.scf import KUHF

        cell = structure.to_cell(*structure.nio_afm(),
                                 basis="gth-dzvp-molopt-sr",
                                 pseudo="gth-pade", ke_cutoff=200.0,
                                 exp_to_discard=0.1)
        kpts = cell.get_kpts([4, 4, 4])
        m0 = tuple(min(15, int(m)) for m in cell.mesh)
        t0 = time.perf_counter()
        df = FFTISDF(cell, kpts, c0=args.c0, m0=m0, verbose=0,
                     max_memory_gb=13.0)
        df.build()
        t_build = time.perf_counter() - t0
        emit(args.out, {"part": "B_build", "isdf_build_s": round(t_build, 2),
                        "nip": int(df.nip), "nao": cell.nao_nr(),
                        "ngrid": int(np.prod(cell.mesh)),
                        "nchunks": int(getattr(df, "_nchunks", 1))})

        cls = KUHF if backend == "cpu" else DeviceKUHF
        conv = 1e-8 if backend == "cpu" else 1e-6
        mf = cls(cell, kpts, with_df=df, verbose=3, conv_tol=conv,
                 max_cycle=args.max_cycle, init_spin=init_spin,
                 smearing=args.smearing, damp=args.damp)
        t0 = time.perf_counter()
        e = mf.kernel()
        t_scf = time.perf_counter() - t0
        from fftisdf_tpu.scf.analysis import atom_charges_and_moments
        _c, moments = atom_charges_and_moments(cell, mf.dm, mf.s1e)
        ncyc = int(getattr(mf, "cycles", getattr(mf, "niter", -1)))
        ct = list(getattr(mf, "cycle_times", []))
        # steady state = median of the post-compile cycles (cycle 0 pays
        # the jitted step's compile; the round-4 verdict flagged the
        # missing compile-excluded number)
        steady = (float(np.median(ct[1:])) if len(ct) > 1 else None)
        emit(args.out, {
            "part": "B_production_scf",
            "config": "NiO AFM 4x4x4 gth-dzvp-molopt-sr ke=200 c0=40 "
                      "m0=15^3 (ref fftisdf.py:423-432,461-462)",
            "e_tot_ha": e, "converged": bool(mf.converged),
            "cycles": ncyc,
            "scf_wall_s": round(t_scf, 2),
            "s_per_cycle": round(t_scf / max(ncyc, 1), 3),
            "s_per_cycle_steady": round(steady, 3) if steady else None,
            "cycle_times_s": [round(t, 3) for t in ct],
            "ni_moments": [round(float(m), 3) for m in moments[:2]],
            "smearing_ha": args.smearing,
            "damp": args.damp,
            "adiis_switch": float(getattr(mf, "adiis_switch", 0.0)),
            "conv_tol": conv})
    emit(args.out, {"part": "done"})


if __name__ == "__main__":
    main()
