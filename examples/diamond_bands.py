"""Band structure of diamond along L-G-X-W-L (HF or any KS functional).

Converges an ISDF-driven KRHF/KRKS on a k-mesh, then evaluates band energies
at arbitrary k-points with ``get_bands`` (exact plane-wave J/K at the band
points from the converged mesh density) — a capability the reference guards
out (``/root/reference/fftisdf.py:194``: kpts_band -> NotImplementedError).

``--xc hse06`` demonstrates the production solid-state recipe: the screened
hybrid opens the PBE gap toward experiment without any exxdiv machinery
(the erfc-screened exchange is finite at q+G=0).  Compare
``--xc pbe`` / ``--xc hse06`` / plain HF.

Usage: python examples/diamond_bands.py [--gpu] [--ke 50] [--kmesh 2 2 2]
       [--npoints 8] [--c0 40] [--xc hf|lda|pbe|pbe0|hse06]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kpath(cell, npoints):
    """L-G-X-W-L path in the fcc Brillouin zone (scaled coordinates of the
    primitive reciprocal lattice)."""
    pts = {
        "L": np.array([0.5, 0.5, 0.5]),
        "G": np.array([0.0, 0.0, 0.0]),
        "X": np.array([0.5, 0.0, 0.5]),
        "W": np.array([0.5, 0.25, 0.75]),
    }
    legs = ["L", "G", "X", "W", "L"]
    b = cell.reciprocal_vectors()
    kpts, labels, dist = [], [], [0.0]
    for i in range(len(legs) - 1):
        p0, p1 = pts[legs[i]], pts[legs[i + 1]]
        n = npoints if i < len(legs) - 2 else npoints + 1
        for j in range(n):
            t = j / npoints
            kpts.append((1 - t) * p0 + t * p1)
    kcart = np.asarray(kpts) @ b
    for i in range(1, len(kcart)):
        dist.append(dist[-1] + np.linalg.norm(kcart[i] - kcart[i - 1]))
    for i, leg in enumerate(legs):
        labels.append((dist[min(i * npoints, len(dist) - 1)], leg))
    return kcart, np.asarray(dist), labels


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gpu", action="store_true")
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[2, 2, 2])
    p.add_argument("--npoints", type=int, default=8)
    p.add_argument("--c0", type=float, default=40.0)
    p.add_argument("--exxdiv", default=None, choices=[None, "ewald"])
    p.add_argument("--xc", default="hf",
                   help="hf (KRHF) or a KS functional (lda/pbe/pbe0/hse06)")
    args = p.parse_args()

    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    from fftisdf_tpu.utils.device import enable_persistent_cache
    enable_persistent_cache()

    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf import KRHF
    from fftisdf_tpu.scf.ks import KRKS

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)

    df = FFTISDF(cell, kpts, c0=args.c0, m0=(11, 11, 11), verbose=3).build()
    if args.xc == "hf":
        mf = KRHF(cell, kpts, with_df=df, verbose=3, exxdiv=args.exxdiv)
    else:
        mf = KRKS(cell, kpts, xc=args.xc, with_df=df, verbose=3,
                  exxdiv=args.exxdiv)
    e = mf.kernel()
    print(f"# converged {args.xc.upper()} E = {e:.10f} Ha "
          f"(converged={mf.converged})")

    kband, dist, labels = kpath(cell, args.npoints)
    # band J/K are exact plane-wave at the band points; exxdiv='ewald' bands
    # are only defined on the mesh, so interpolate with exxdiv=None
    mf.exxdiv = None
    es, _ = mf.get_bands(kband)
    nocc = mf.nocc
    homo = max(e[nocc - 1] for e in es)
    lumo = min(e[nocc] for e in es)
    print(f"# indirect gap along path: {27.2114 * (lumo - homo):.3f} eV "
          f"(exp ~5.5; HF overestimates ~2x, PBE underestimates ~25%, "
          f"HSE06 lands near experiment)")
    print("# path labels: " + "  ".join(f"{lab}@{d:.3f}" for d, lab in labels))
    print("# dist  e_1 e_2 ... (Ha)")
    for i, (d, ek) in enumerate(zip(dist, es)):
        print(f"{d:8.4f} " + " ".join(f"{x:12.6f}" for x in ek[:8]))


if __name__ == "__main__":
    main()
