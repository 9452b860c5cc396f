"""k-point Hartree-Fock (KRHF / KUHF) with DIIS, on top of any J/K provider.

The reference runs PySCF's ``KRHF`` with its ISDF object plugged in as
``with_df`` (``/root/reference/fftisdf.py:437-466``); here the SCF driver is
native and the J/K provider is duck-typed: anything with
``get_jk(dm) -> (vj, vk)`` works — ``fftisdf_tpu.isdf.FFTISDF`` (fast path)
or ``PWDF`` below (exact plane-wave oracle).  ``exxdiv=None`` semantics
throughout, matching the reference drivers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.scf import integrals
from fftisdf_tpu.scf.core import (adiis_coeffs, diis_extrapolate, fori_host,
                                  fixed_occupations, smeared_occupations)
from fftisdf_tpu.basis.eval import make_evaluator
from fftisdf_tpu.utils.logging import Logger
from fftisdf_tpu.utils.device import to_host, to_device


class PWDF:
    """Exact plane-wave J/K provider (FFTDF-oracle) with the get_jk interface."""

    def __init__(self, cell, kpts, dtype=jnp.float64, trunc=None):
        from fftisdf_tpu.pw import jk as pw_jk

        self.cell = cell
        self.kpts = np.asarray(kpts)
        fn = make_evaluator(cell, kpts=kpts, dtype=dtype)
        self.coords = cell.gen_uniform_grids()
        self.ao = fn(jnp.asarray(self.coords, dtype=dtype))
        self._jk = pw_jk
        self._madelung = None
        self._s1e = None
        if isinstance(trunc, str):
            from fftisdf_tpu.linalg.coulomb import trunc_for_cell

            trunc = trunc_for_cell(cell, trunc)
        self.trunc = trunc

    def get_jk(self, dm, with_j=True, with_k=True, exxdiv=None, omega=None):
        if exxdiv not in (None, "ewald"):
            raise NotImplementedError(f"exxdiv={exxdiv!r} not supported")
        omega = float(omega or 0.0)
        if omega != 0.0 and exxdiv is not None:
            # range-separated kernels carry no q+G=0 divergence to correct
            raise NotImplementedError("exxdiv with omega")
        dm = to_device(dm)
        if dm.ndim == 4:  # spin/set axis
            out = [self.get_jk(d, with_j, with_k, exxdiv, omega=omega)
                   for d in dm]
            vj = jnp.stack([o[0] for o in out]) if with_j else None
            vk = jnp.stack([o[1] for o in out]) if with_k else None
            return vj, vk
        vj = (self._jk.get_j_kpts(self.cell, dm, self.ao, omega=omega,
                                  trunc=self.trunc)
              if with_j else None)
        vk = (self._jk.get_k_kpts(self.cell, dm, self.ao, self.kpts,
                                  coords=self.coords, omega=omega,
                                  trunc=self.trunc)
              if with_k else None)
        if exxdiv == "ewald" and with_k:
            from fftisdf_tpu.isdf.jk import add_ewald_exx

            if self._madelung is None:
                from fftisdf_tpu.lattice import kpoints as kpt_mod
                from fftisdf_tpu.scf.integrals import madelung, madelung_trunc

                kmesh = kpt_mod.kpts_to_kmesh(self.cell, self.kpts)
                # truncated kernels: nothing is dropped at q+G=0, so the
                # probe-charge correction is the Riemann-sum-vs-integral
                # defect of the TRUNCATED kernel (integrals.madelung_trunc;
                # exactly 0 for 0d)
                self._madelung = (madelung_trunc(self.cell, kmesh, self.trunc)
                                  if self.trunc is not None
                                  else madelung(self.cell, kmesh))
                self._s1e = integrals.get_ovlp(self.cell, self.ao)
            vk = add_ewald_exx(vk, self._s1e, dm, self._madelung)
        return vj, vk


class DIIS:
    """ADIIS-stabilized Pulay DIIS over flattened (dm, fock, error) rows.

    Storage management only — the extrapolation math is the shared
    ``scf.core`` code (same code the traced device driver runs).  Policy
    (PySCF's): while the commutator error is large the coefficients come
    from the globally-damped ADIIS energy model (``scf.core.adiis_coeffs``
    — the fix for the round-3 d-manifold limit cycle that needed damp=0.4
    and 179 cycles); once |FDS-SDF| < ``adiis_switch`` the terminal
    quadratic phase uses plain CDIIS.  ``adiis_switch=0`` disables ADIIS
    (legacy behavior)."""

    def __init__(self, space=8, adiis_switch=1e-2):
        self.space = space
        self.adiis_switch = float(adiis_switch)
        self.errs = []
        self.focks = []
        self.dms = []

    def update(self, fock_flat, err_flat, dm_flat=None):
        self.errs.append(np.asarray(err_flat, dtype=np.complex128))
        self.focks.append(np.asarray(fock_flat, dtype=np.complex128))
        self.dms.append(None if dm_flat is None
                        else np.asarray(dm_flat, dtype=np.complex128))
        if len(self.errs) > self.space:
            self.errs.pop(0)
            self.focks.pop(0)
            self.dms.pop(0)
        n = len(self.errs)
        err_norm = float(np.abs(self.errs[-1]).max())
        # ADIIS can only extrapolate over slots that carry a density (rows
        # stored while the caller withheld dm — e.g. bias cycles — are
        # masked out)
        valid = np.array([d is not None for d in self.dms])
        if (self.adiis_switch > 0 and self.dms[-1] is not None
                and valid.sum() >= 2 and err_norm > self.adiis_switch):
            dms = np.stack([np.zeros_like(self.focks[0]) if d is None else d
                            for d in self.dms])
            c = adiis_coeffs(dms, np.asarray(self.focks),
                             n - 1, valid, np, fori_host)
            return np.einsum("i,il->l", c, np.asarray(self.focks))
        return diis_extrapolate(np.asarray(self.errs), np.asarray(self.focks),
                                np.ones(n, dtype=bool), np)


def _eigh_gen(f, s, cutoff=1e-10):
    """Generalized hermitian eigensolve F C = S C e via canonical
    orthogonalization (threshold tiny overlap eigenvalues).

    ``cutoff`` must sit above the noise floor of the overlap's provenance:
    1e-10 for f64 integrals, ~1e-6 when S was computed in f32 on device
    (f32 quadrature noise in near-null directions otherwise gets amplified
    by 1/sqrt(noise) and the SCF NaNs out)."""
    se, sv = np.linalg.eigh(s)
    keep = se > cutoff * se.max()
    x = sv[:, keep] / np.sqrt(se[keep])[None, :]
    fo = x.conj().T @ f @ x
    e, c = np.linalg.eigh(fo)
    return e, x @ c


def _build_dm(mo_coeff, mo_occ):
    return np.einsum("kmi,ki,kni->kmn", mo_coeff, mo_occ, mo_coeff.conj())


@dataclass
class KRHF:
    """Restricted HF over a uniform k-mesh; insulating (fixed) occupations."""
    cell: object
    kpts: np.ndarray
    with_df: object = None            # J/K provider; default PWDF
    max_cycle: int = 50
    conv_tol: float = 1e-8
    diis_space: int = 8
    adiis_switch: float = 1e-2  # |FDS-SDF| above which the globally-damped
                               # ADIIS energy model supplies the DIIS
                               # coefficients (Hu & Yang 2010; kills the
                               # d-manifold limit cycles that plain CDIIS
                               # needs hand-tuned damping for).  0 = legacy
                               # CDIIS-only.
    exxdiv: str = None         # None (ref semantics) | 'ewald' (Madelung
                               # probe-charge correction of the G=0 exchange)
    level_shift: float = 0.0   # Ha shift of virtuals (helps small-gap SCF)
    damp: float = 0.0          # density mixing dm <- (1-damp) dm_new + damp dm
    smearing: float = 0.0      # sigma (Ha); > 0 enables fractional occupations
    smearing_method: str = "fermi"   # fermi | gauss
    trunc: object = None       # truncated Coulomb for low-dimensional
                               # systems ("0d" | ("0d", rc)): truncates
                               # J/K, electron-ion AND ion-ion consistently
                               # (isolated-molecule SCF in a box).  Adopted
                               # from with_df.trunc when one is supplied.
    ovlp_cutoff: float = None  # canonical-orthogonalization threshold;
                               # None: dtype-aware (1e-10 f64, 2e-6 f32)
    dtype: object = None       # device dtype; None = f64 on CPU, f32 on
    #                            any non-CPU backend
    setup_chunk_gb: float = 2.0  # AO-block budget of the k-chunked
                               # s1e/h1e setup (see __post_init__)
    verbose: int = 3

    e_tot: float = None
    e_free: float = None       # Mermin free energy E - sigma*S (== e_tot at sigma=0)
    entropy: float = 0.0
    mu: float = None           # chemical potential (smearing only)
    mo_energy: np.ndarray = None
    mo_coeff: np.ndarray = None
    mo_occ: np.ndarray = None
    converged: bool = False

    def __post_init__(self):
        from fftisdf_tpu.utils.device import ensure_f32_matmul_precision

        ensure_f32_matmul_precision()
        self.kpts = np.asarray(self.kpts)
        self._log = Logger(self.verbose)
        cell = self.cell
        if self.dtype is None:
            import jax as _jax

            self.dtype = (jnp.float64 if _jax.default_backend() == "cpu"
                          else jnp.float32)
        if self.ovlp_cutoff is None:
            self.ovlp_cutoff = 1e-10 if self.dtype == jnp.float64 else 2e-6
        # Coulomb truncation: normalize, adopt from / check against the
        # J/K provider (the metric it serves MUST match hcore + e_nuc)
        if isinstance(self.trunc, str):
            from fftisdf_tpu.linalg.coulomb import trunc_for_cell

            self.trunc = trunc_for_cell(cell, self.trunc)
        df_trunc = getattr(self.with_df, "trunc", None)
        if self.trunc is None:
            self.trunc = df_trunc
        elif df_trunc is not None and (
                df_trunc[0] != self.trunc[0]
                or abs(df_trunc[1] - self.trunc[1]) > 1e-10):
            raise ValueError(
                f"with_df truncation {df_trunc} != SCF truncation "
                f"{self.trunc}")
        # one-time s1e/h1e setup, CHUNKED over k-points: the full-grid AO
        # tensor is nk*ngrid*nao complex (7.9 GB at NiO dzvp ke=200 4x4x4),
        # held next to the ISDF state — but the integrals are k-diagonal,
        # so k-chunks of ~2 GB suffice.  The
        # full tensor itself is only needed by the band-structure / exact-
        # PW / xc paths and is evaluated LAZILY there (self._get_ao).
        coords = cell.gen_uniform_grids()
        ng = coords.shape[0]
        nao = cell.nao_nr()
        itemsize = 8 if self.dtype == jnp.float32 else 16
        nk = len(self.kpts)
        kchunk = int(max(1, min(nk, (self.setup_chunk_gb * 1e9)
                                // max(3 * ng * nao * itemsize, 1))))
        self._ao = None
        if kchunk >= nk:
            ao = self._get_ao()
            self.s1e = to_host(integrals.get_ovlp(cell, ao))
            self.h1e = to_host(integrals.get_hcore(
                cell, ao, self.kpts, coords, trunc=self.trunc))
        else:
            coords_d = jnp.asarray(coords, dtype=self.dtype)
            s_parts, h_parts = [], []
            chunk_keys = []
            for k0 in range(0, nk, kchunk):
                kp = self.kpts[k0:k0 + kchunk]
                fn = make_evaluator(cell, kpts=kp, dtype=self.dtype)
                ao = fn(coords_d)
                s_parts.append(to_host(integrals.get_ovlp(cell, ao)))
                h_parts.append(to_host(integrals.get_hcore(
                    cell, ao, kp, coords, trunc=self.trunc)))
                del ao
                chunk_keys.append(kp.tobytes())
            self.s1e = np.concatenate(s_parts, axis=0)
            self.h1e = np.concatenate(h_parts, axis=0)
            # drop the per-chunk evaluator cache entries: this setup is
            # one-shot and the slices never recur (the full-kpts evaluator
            # other consumers use has a different key), so the entries
            # would just sit on the cell for its lifetime (round-3
            # advisor note)
            ecache = cell.__dict__.get("_evaluator_cache", {})
            for key in list(ecache):
                if key[0] in chunk_keys:
                    del ecache[key]
        self.e_nuc = (integrals.energy_nuc_trunc(cell, self.trunc)
                      if self.trunc is not None else integrals.ewald(cell))
        if self.with_df is None:
            self.with_df = PWDF(cell, self.kpts, dtype=self.dtype,
                                trunc=self.trunc)

    def _get_ao(self):
        """Full-grid AO tensor (nk, ngrid, nao), lazily evaluated and
        cached — used by the band-structure, exact-PW and xc paths; the
        production ISDF-SCF path never materializes it."""
        if self._ao is None:
            fn = make_evaluator(self.cell, kpts=self.kpts, dtype=self.dtype)
            coords = self.cell.gen_uniform_grids()
            self._ao = fn(jnp.asarray(coords, dtype=self.dtype))
        return self._ao

    # --------------------------------------------------------------
    @property
    def nocc(self):
        ne = self.cell.nelectron
        assert ne % 2 == 0, "odd electron count: use KUHF"
        return ne // 2

    def get_init_guess(self):
        """Diagonalize hcore (the reference uses PySCF's minao guess; hcore
        keeps us self-contained)."""
        nk, nao = self.h1e.shape[:2]
        es, cs = [], []
        for k in range(nk):
            e, c = _eigh_gen(self.h1e[k], self.s1e[k],
                             cutoff=self.ovlp_cutoff)
            es.append(e)
            cs.append(c)
        occs = fixed_occupations(es, self.nocc, factor=2.0)
        return _build_dm(np.asarray(cs), np.asarray(occs))

    def get_fock(self, dm):
        vj, vk = self.with_df.get_jk(to_device(dm), exxdiv=self.exxdiv)
        vj, vk = to_host(vj), to_host(vk)
        return self.h1e + vj - 0.5 * vk, vj, vk

    def save(self, path):
        """Checkpoint the SCF state (density, orbitals, energies) to one
        .npz — restartable across processes (utils.serialization)."""
        from fftisdf_tpu.utils.serialization import save_scf

        return save_scf(path, self)

    def load_chk(self, path):
        """Geometry-validated restart density from a checkpoint:
        ``mf.kernel(dm0=mf.load_chk(path))``."""
        from fftisdf_tpu.utils.serialization import load_scf

        return load_scf(path, cell=self.cell, kpts=self.kpts)["dm"]

    def _occupations(self, es):
        """Per-k occupation vectors; fractional when smearing is on.

        NB: smearing uses a *global* chemical potential across the k-mesh
        (per-k aufbau is ill-defined for metals/small gaps); don't combine
        with ``level_shift`` — the shift would leak into the smeared
        occupations of partially-filled states.
        """
        if self.smearing > 0:
            occs, self.mu, self.entropy = smeared_occupations(
                es, self.nocc, self.smearing, self.smearing_method,
                factor=2.0)
            return occs
        self.entropy = 0.0
        return fixed_occupations(es, self.nocc, factor=2.0)

    def energy_elec(self, dm, vj, vk):
        nk = len(self.kpts)
        e1 = np.einsum("kmn,knm->", dm, self.h1e).real / nk
        e2 = 0.5 * np.einsum("kmn,knm->", dm, vj - 0.5 * vk).real / nk
        return e1 + e2

    def kernel(self, dm0=None):
        log = self._log
        dm = self.get_init_guess() if dm0 is None else np.asarray(dm0)
        diis = DIIS(self.diis_space, adiis_switch=self.adiis_switch)
        nk, nao = self.h1e.shape[:2]
        e_last = 0.0
        it = -1
        for it in range(self.max_cycle):
            t0 = time.perf_counter()
            fock, vj, vk = self.get_fock(dm)
            e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
            # DIIS on FDS - SDF of the *unshifted* Fock
            err = np.stack([
                fock[k] @ dm[k] @ self.s1e[k] - self.s1e[k] @ dm[k] @ fock[k]
                for k in range(nk)
            ])
            fock = diis.update(fock.reshape(-1), err.reshape(-1),
                               dm_flat=dm.reshape(-1)).reshape(fock.shape)
            if self.level_shift:
                # virtual-space shift applied only to the diagonalized Fock:
                # F += shift * (S - S D S / 2); stationary points unchanged
                fock = fock + self.level_shift * np.stack([
                    self.s1e[k]
                    - self.s1e[k] @ dm[k] @ self.s1e[k] / 2.0
                    for k in range(nk)
                ])
            es, cs = [], []
            for k in range(nk):
                e, c = _eigh_gen(fock[k], self.s1e[k],
                                 cutoff=self.ovlp_cutoff)
                es.append(e)
                cs.append(c)
            occs = self._occupations(es)
            dm_new = _build_dm(np.asarray(cs), np.asarray(occs))
            if self.damp:
                dm_new = (1.0 - self.damp) * dm_new + self.damp * dm
            ddm = abs(dm_new - dm).max()
            de = abs(e_tot - e_last)
            log.info("SCF it %2d  E = %.10f  dE = %.2e  |ddm| = %.2e (%.2fs)",
                     it, e_tot, de, ddm, time.perf_counter() - t0)
            dm = dm_new
            if de < self.conv_tol and ddm < np.sqrt(self.conv_tol):
                self.converged = True
                e_last = e_tot
                break
            e_last = e_tot
        self.cycles = it + 1   # iterations actually run
        # final consistent quantities
        fock, vj, vk = self.get_fock(dm)
        self.e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
        self.e_free = self.e_tot - self.smearing * self.entropy / nk
        self.mo_energy = np.asarray(es)
        self.mo_coeff = np.asarray(cs)
        self.mo_occ = np.asarray(occs)
        self.dm = dm
        return self.e_tot

    # --------------------------------------------------------------
    def _band_ingredients(self, kpts_band, dm, with_k=True,
                          return_ao=False):
        """(s1e_b, h1e_b, vj_b, vk_b[, ao_b]) at band k-points from the
        mesh density.

        Exact plane-wave J/K at the band points: the Hartree potential is
        k-independent (one Poisson solve), exchange runs the (band, mesh)
        pair sweep.  Capability beyond the reference (its guard:
        ``fftisdf.py:194`` kpts_band -> NotImplementedError).

        ``with_k=False`` (pure-DFT band paths, scf.ks) skips the exchange
        sweep entirely and returns ``vk_b = 0.0``; ``return_ao=True``
        additionally returns the band-kpoint AO values (nb, ng, nao) so KS
        callers can take Vxc matrix elements without re-evaluating."""
        from fftisdf_tpu.pw import jk as pw_jk

        cell = self.cell
        kpts_band = np.asarray(kpts_band).reshape(-1, 3)
        fnb = make_evaluator(cell, kpts=kpts_band, dtype=self.dtype)
        coords = cell.gen_uniform_grids()
        aob = fnb(jnp.asarray(coords, dtype=self.dtype))
        s1e_b = to_host(integrals.get_ovlp(cell, aob))
        h1e_b = to_host(integrals.get_hcore(cell, aob, kpts_band, coords,
                                            trunc=self.trunc))
        dm = to_device(dm, dtype=self._get_ao().dtype)
        # exclude exactly the argmin-|q+G|^2 exchange-kernel sample of
        # each (band, mesh) pair when it is strictly inside dmin of the
        # singular lattice (at mesh points this reduces to dropping exactly
        # the q+G = 0 term; see pw.jk.get_k_kpts docstring)
        from fftisdf_tpu.lattice import kpoints as kpt_mod

        kmesh = np.asarray(kpt_mod.kpts_to_kmesh(cell, self.kpts),
                           dtype=np.float64)
        qlat = cell.reciprocal_vectors() / kmesh[:, None]
        volq = abs(np.linalg.det(qlat))
        dmin = min(volq / np.linalg.norm(
            np.cross(qlat[(i + 1) % 3], qlat[(i + 2) % 3]))
            for i in range(3))
        g0_argmin_thresh = dmin ** 2
        if getattr(self.with_df, "wq", None) is not None:
            # ISDF-backed SCF: serve band J/K from the product state too
            # (per-pair re-fit, isdf.bands) instead of the exact-PW sweep
            vj_b, vk_b = self.with_df.get_jk(dm, kpts_band=kpts_band,
                                             with_k=with_k)
            if vk_b is None:
                vk_b = 0.0
        elif dm.ndim == 4:   # spin channels (KUHF)
            vj_b = jnp.stack([pw_jk.get_j_kpts(cell, d, self._get_ao(),
                                               ao_band=aob, trunc=self.trunc)
                              for d in dm])
            vk_b = jnp.stack([
                pw_jk.get_k_kpts(cell, d, self._get_ao(), self.kpts, coords=coords,
                                 ao_band=aob, kpts_band=kpts_band,
                                 g0_argmin_thresh=g0_argmin_thresh,
                                 trunc=self.trunc)
                for d in dm]) if with_k else 0.0
        else:
            vj_b = pw_jk.get_j_kpts(cell, dm, self._get_ao(), ao_band=aob,
                                    trunc=self.trunc)
            vk_b = (pw_jk.get_k_kpts(cell, dm, self._get_ao(), self.kpts,
                                     coords=coords, ao_band=aob,
                                     kpts_band=kpts_band,
                                     g0_argmin_thresh=g0_argmin_thresh,
                                     trunc=self.trunc)
                    if with_k else 0.0)
        if self.exxdiv == "ewald" and with_k:
            # the probe-charge correction needs the density *at the band
            # k-point*; it exists only where the band point lies on the SCF
            # mesh.  Off-mesh band paths must run with exxdiv=None.
            from fftisdf_tpu.lattice import kpoints as kpt_mod
            from fftisdf_tpu.scf.integrals import madelung
            from fftisdf_tpu.isdf.jk import add_ewald_exx

            scaled = self.cell.get_scaled_kpts(kpts_band)
            smesh = self.cell.get_scaled_kpts(self.kpts)
            idx = [kpt_mod.member(s, smesh, strict=False) for s in scaled]
            if any(i < 0 for i in idx):
                raise ValueError(
                    "exxdiv='ewald' band energies are defined only at the "
                    "SCF mesh k-points; run get_bands on an exxdiv=None "
                    "Fock (pass dm from an exxdiv='ewald' SCF but set "
                    "self.exxdiv = None first) for off-mesh paths")
            kmesh = kpt_mod.kpts_to_kmesh(self.cell, self.kpts)
            mad = madelung(self.cell, kmesh)
            # complex gather under jit (eager complex ops can be unsupported)
            dmb = jax.jit(lambda a, i: jnp.take(a, i, axis=-3))(
                dm, jnp.asarray(idx))
            s1e_dev = to_device(s1e_b, dtype=self._get_ao().dtype)
            vk_b = add_ewald_exx(vk_b, s1e_dev, dmb, mad)
        vk_h = 0.0 if isinstance(vk_b, float) else to_host(vk_b)
        out = (s1e_b, h1e_b, to_host(vj_b), vk_h)
        return out + (aob,) if return_ao else out

    def get_bands(self, kpts_band, dm=None):
        """Band energies/orbitals at arbitrary k-points from the converged
        density: F(kb) = hcore(kb) + J(kb) - K(kb)/2, one generalized
        eigensolve per band point.  Returns (mo_energy list, mo_coeff list).
        """
        if dm is None:
            dm = getattr(self, "dm", None)
            assert dm is not None, "run kernel() first or pass dm"
        else:
            dm = np.asarray(dm)
        s1e_b, h1e_b, vj_b, vk_b = self._band_ingredients(kpts_band, dm)
        fock = h1e_b + vj_b - 0.5 * vk_b
        es, cs = [], []
        for kb in range(fock.shape[0]):
            e, c = _eigh_gen(fock[kb], s1e_b[kb], cutoff=self.ovlp_cutoff)
            es.append(e)
            cs.append(c)
        return es, cs


@dataclass
class KUHF(KRHF):
    """Unrestricted HF: dm has a spin axis (2, nk, nao, nao).

    J couples to the total density; K acts per spin.  Initial AFM symmetry
    breaking via `init_spin`: {atom_index: +1/-1} scales the hcore-guess
    occupations per spin channel (the NiO-AFM capability of the reference's
    north-star config, BASELINE.md)."""
    init_spin: dict = field(default_factory=dict)
    spin_bias: float = 0.5      # Ha on-site shift breaking spin symmetry
    bias_cycles: int = 4        # keep the bias in the Fock for N cycles

    def _atom_blocks(self):
        off = 0
        blocks = []
        for sym, _ in self.cell.atom:
            nfa = sum(sh.nfunc for sh in self.cell._basis[sym])
            blocks.append((off, nfa))
            off += nfa
        return blocks

    def _apply_bias(self, fock):
        """Spin-dependent on-site level shifts (AFM symmetry breaking)."""
        if not self.init_spin:
            return fock
        fock = fock.copy()
        nk = len(self.kpts)
        for ia, (off, nfa) in enumerate(self._atom_blocks()):
            bias = self.init_spin.get(ia, 0.0)
            if bias == 0.0:
                continue
            for s, sgn in ((0, -1.0), (1, +1.0)):
                for k in range(nk):
                    fock[s, k, off:off + nfa, off:off + nfa] += (
                        sgn * self.spin_bias * bias
                        * self.s1e[k][off:off + nfa, off:off + nfa])
        return fock

    @property
    def nocc_ab(self):
        ne = self.cell.nelectron
        s = self.cell.spin
        na = (ne + s) // 2
        nb = ne - na
        return na, nb

    def get_init_guess(self):
        nk, nao = self.h1e.shape[:2]
        na, nb = self.nocc_ab
        dms = []
        for ispin, nocc in enumerate((na, nb)):
            es, cs = [], []
            for k in range(nk):
                h = self.h1e[k].copy()
                if self.init_spin:
                    # bias on-site energies to break spin symmetry
                    sgn = -1.0 if ispin == 0 else 1.0
                    for ia, (off, nfa) in enumerate(self._atom_blocks()):
                        bias = self.init_spin.get(ia, 0.0)
                        h[off:off + nfa, off:off + nfa] += (
                            sgn * self.spin_bias * bias
                            * self.s1e[k][off:off + nfa, off:off + nfa])
                e, c = _eigh_gen(h, self.s1e[k], cutoff=self.ovlp_cutoff)
                es.append(e)
                cs.append(c)
            occs = fixed_occupations(es, nocc, factor=1.0)
            dms.append(_build_dm(np.asarray(cs), np.asarray(occs)))
        return np.asarray(dms)

    def get_fock(self, dm):
        vj, vk = self.with_df.get_jk(to_device(dm),
                                     exxdiv=self.exxdiv)  # (2, nk, nao, nao)
        vj, vk = to_host(vj), to_host(vk)
        vj_tot = vj[0] + vj[1]
        fock = np.stack([self.h1e + vj_tot - vk[0],
                         self.h1e + vj_tot - vk[1]])
        return fock, vj, vk

    def energy_elec(self, dm, vj, vk):
        nk = len(self.kpts)
        vj_tot = vj[0] + vj[1]
        e1 = np.einsum("skmn,knm->", dm, self.h1e).real / nk
        ecoul = 0.5 * np.einsum("skmn,sknm->", dm,
                                np.stack([vj_tot, vj_tot])).real / nk
        ex = -0.5 * np.einsum("skmn,sknm->", dm, vk).real / nk
        return e1 + ecoul + ex

    def kernel(self, dm0=None):
        log = self._log
        dm = self.get_init_guess() if dm0 is None else np.asarray(dm0)
        # the symmetry-breaking bias exists to steer the spin-restricted
        # INIT GUESS into the requested magnetic order; a caller-provided
        # density already encodes its basin, and biasing the Fock on top
        # of it kicks the SCF OUT of that basin (measured: the A64 exact
        # arm seeded with a converged ISDF density 4e-5 away landed in a
        # metastable state 0.18 Ha up after the 0.5 Ha bias cycles)
        bias_cycles = self.bias_cycles if dm0 is None else 0
        diis = DIIS(self.diis_space, adiis_switch=self.adiis_switch)
        nk, nao = self.h1e.shape[:2]
        na, nb = self.nocc_ab
        e_last = 0.0
        it = -1
        for it in range(self.max_cycle):
            t0 = time.perf_counter()
            fock, vj, vk = self.get_fock(dm)
            e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
            err = np.stack([
                fock[s, k] @ dm[s, k] @ self.s1e[k]
                - self.s1e[k] @ dm[s, k] @ fock[s, k]
                for s in range(2) for k in range(nk)
            ])
            # no ADIIS while the symmetry-breaking bias drives the Fock:
            # the energy-model extrapolation over biased iterates averages
            # the broken-symmetry seed away (measured: stretched-H2 BS test
            # relaxes to the symmetric state) — CDIIS until the bias is off
            dm_for_adiis = (dm.reshape(-1)
                            if (not self.init_spin
                                or it >= bias_cycles) else None)
            fock = diis.update(fock.reshape(-1), err.reshape(-1),
                               dm_flat=dm_for_adiis).reshape(fock.shape)
            if it < bias_cycles:
                fock = self._apply_bias(fock)
            if self.level_shift:
                # per-spin virtual shift on the diagonalized Fock only
                fock = fock + self.level_shift * np.stack([
                    np.stack([self.s1e[k]
                              - self.s1e[k] @ dm[sp, k] @ self.s1e[k]
                              for k in range(nk)])
                    for sp in range(2)
                ])
            es, cs, occs = [], [], []
            dm_new = np.empty_like(dm)
            self.entropy = 0.0
            mus = []
            for s, nocc in enumerate((na, nb)):
                es_s, cs_s = [], []
                for k in range(nk):
                    e, c = _eigh_gen(fock[s, k], self.s1e[k],
                                     cutoff=self.ovlp_cutoff)
                    es_s.append(e)
                    cs_s.append(c)
                if self.smearing > 0:
                    # per-spin chemical potential: (na, nb) fixed by
                    # cell.spin, matching the fixed-occupation semantics
                    occ_s, mu_s, ent_s = smeared_occupations(
                        es_s, nocc, self.smearing, self.smearing_method,
                        factor=1.0)
                    self.entropy += ent_s
                    mus.append(mu_s)
                else:
                    occ_s = fixed_occupations(es_s, nocc, factor=1.0)
                dm_new[s] = _build_dm(np.asarray(cs_s), np.asarray(occ_s))
                es.append(es_s)
                cs.append(cs_s)
                occs.append(occ_s)
            if mus:
                self.mu = tuple(mus)
            if self.damp:
                dm_new = (1.0 - self.damp) * dm_new + self.damp * dm
            ddm = abs(dm_new - dm).max()
            de = abs(e_tot - e_last)
            log.info("UHF it %2d  E = %.10f  dE = %.2e  |ddm| = %.2e (%.2fs)",
                     it, e_tot, de, ddm, time.perf_counter() - t0)
            dm = dm_new
            if de < self.conv_tol and ddm < np.sqrt(self.conv_tol):
                self.converged = True
                e_last = e_tot
                break
            e_last = e_tot
        self.cycles = it + 1   # iterations actually run
        fock, vj, vk = self.get_fock(dm)
        self.e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
        self.e_free = self.e_tot - self.smearing * self.entropy / nk
        self.mo_energy = np.asarray(es)
        self.mo_coeff = np.asarray(cs)
        self.mo_occ = np.asarray(occs)
        self.dm = dm
        return self.e_tot

    def get_bands(self, kpts_band, dm=None):
        """Per-spin band energies/orbitals at arbitrary k-points:
        F_s(kb) = hcore(kb) + J_tot(kb) - K_s(kb).  Returns
        (mo_energy [2][nb] lists, mo_coeff [2][nb] lists)."""
        if dm is None:
            dm = getattr(self, "dm", None)
            assert dm is not None, "run kernel() first or pass dm"
        else:
            dm = np.asarray(dm)
        s1e_b, h1e_b, vj_b, vk_b = self._band_ingredients(kpts_band, dm)
        vj_tot = vj_b[0] + vj_b[1]
        es, cs = [], []
        for s in range(2):
            fock = h1e_b + vj_tot - vk_b[s]
            es_s, cs_s = [], []
            for kb in range(fock.shape[0]):
                e, c = _eigh_gen(fock[kb], s1e_b[kb], cutoff=self.ovlp_cutoff)
                es_s.append(e)
                cs_s.append(c)
            es.append(es_s)
            cs.append(cs_s)
        return es, cs
