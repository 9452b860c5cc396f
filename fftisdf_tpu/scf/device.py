"""Device-resident SCF driver: the whole iteration on the device.

The host-loop drivers in ``scf.hf`` move vj/vk/fock/dm between host and
device every cycle, so each iteration pays several host<->device crossings
next to a J/K serve of milliseconds.  This driver keeps the entire
iteration on device — J/K, Fock assembly, DIIS (ring-buffer state + small
complex solve), canonical-orthogonalization eigensolve, smeared occupations
(bisected chemical potential under ``lax.fori_loop``), density update,
energy — and fetches ONE small real vector (E, |ddm|, S) per cycle.

The reference has no counterpart (its SCF is PySCF's host loop,
``/root/reference/fftisdf.py:437-466``); this is device-native design in the
same sense the sharded build is.  Parity gate:
``tests/test_scf_device.py`` — identical converged energies to the host
driver on CPU/f64.

Scope: KUHF/KRHF with fixed or smeared occupations, the AFM on-site bias,
and traced linear density damping (``damp``, the oscillation-killer for
energy-flat d-manifold competitions at production scale); level shifting
stays host-driver-only (smearing is the small-gap tool here).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.isdf import jk as jk_mod
from fftisdf_tpu.utils.device import to_device, to_host
from fftisdf_tpu.utils.logging import Logger
from fftisdf_tpu.scf import core
from fftisdf_tpu.scf.hf import KUHF, _eigh_gen, smeared_occupations


def orth_and_penalty(s1e, cutoff):
    """Canonical orthogonalization bases X_k (host, f64) with static shapes.

    Dropped near-null overlap directions keep their column slot (zeroed) and
    get a +1e6 Ha diagonal penalty in the orthogonal basis so they can never
    be occupied — static shapes are what the jitted step needs.
    Returns (x (nk, nao, nao), penalty (nk, nao))."""
    nk, nao = s1e.shape[:2]
    x = np.zeros((nk, nao, nao), dtype=np.complex128)
    pen = np.zeros((nk, nao))
    for k in range(nk):
        se, sv = np.linalg.eigh(s1e[k])
        keep = se > cutoff * se.max()
        xk = sv * np.where(keep, 1.0 / np.sqrt(np.where(keep, se, 1.0)), 0.0)
        x[k] = xk
        pen[k] = np.where(keep, 0.0, _PENALTY)
    return x, pen


def _diis_update(errs, focks, dms, ok, n, err_flat, fock_flat, dm_flat,
                 adiis_switch, allow_adiis):
    """Ring-buffer ADIIS/CDIIS state management, fully on device.

    errs/focks/dms: (m, L) complex; ok: (m,) bool (slot eligible for the
    ADIIS hull); n: int32 count.  Returns the extrapolated fock (L,) and
    the new state.  The extrapolation math is the shared ``scf.core`` code
    (same code the host driver runs): the globally-damped ADIIS energy
    model while |FDS-SDF| > ``adiis_switch`` (a traced ``where`` — both
    coefficient solves are tiny next to one J/K serve), CDIIS in the
    terminal quadratic phase.  Rows stored while ``allow_adiis`` was False
    (bias cycles: the energy model would average the broken-symmetry seed
    away) never enter the ADIIS hull — the same masking the host DIIS
    applies."""
    m = errs.shape[0]
    idx = jnp.mod(n, m)
    zero = jnp.zeros((), dtype=idx.dtype)
    errs = jax.lax.dynamic_update_slice(errs, err_flat[None], (idx, zero))
    focks = jax.lax.dynamic_update_slice(focks, fock_flat[None], (idx, zero))
    dms = jax.lax.dynamic_update_slice(dms, dm_flat[None], (idx, zero))
    ok = jax.lax.dynamic_update_slice(
        ok, jnp.reshape(allow_adiis, (1,)).astype(ok.dtype), (idx,))
    n = n + 1
    valid = (jnp.arange(m) < n)
    fock_c = core.diis_extrapolate(errs, focks, valid, jnp)
    if adiis_switch > 0.0:
        valid_a = jnp.logical_and(valid, ok)
        c_a = core.adiis_coeffs(dms, focks, idx, valid_a, jnp,
                                jax.lax.fori_loop)
        fock_a = jnp.einsum("i,il->l", c_a.astype(focks.real.dtype), focks)
        err_norm = jnp.max(jnp.abs(err_flat))
        use_a = (err_norm > adiis_switch) & allow_adiis \
            & (jnp.sum(valid_a) >= 2)
        fock_out = jnp.where(use_a, fock_a, fock_c)
    else:
        fock_out = fock_c
    return fock_out, errs, focks, dms, ok, n


# Penalized (dropped-overlap-direction) eigenvalues sit at ~+1e6 Ha AFTER
# the eigensolve sorts them to the top of each spectrum; the validity mask
# must therefore be derived from the eigenvalues themselves, NOT from the
# per-column penalty vector (positions no longer correspond after sorting).
_PENALTY = 1e6
_PENALTY_GATE = 0.5e6


def _smeared_occ(e, nocc, sigma, factor, method="fermi"):
    """Smeared occupations from a bisected global mu, on device.

    e: (nk, nmo) eigenvalues; entries above the penalty gate are dropped
    overlap directions and get occupation 0.  Thin traced wrapper over the
    shared ``scf.core.smeared_occ`` (same code the host driver runs)."""
    ok = e < _PENALTY_GATE
    f, s, _ = core.smeared_occ(e, ok, float(nocc * e.shape[0]), sigma,
                               method, jnp, jax.lax.fori_loop)
    return factor * f, factor * s


def _fixed_occ(e, nocc, factor):
    return factor * core.aufbau_occ(e, e < _PENALTY_GATE, nocc, jnp), 0.0


@dataclass
class DeviceKUHF(KUHF):
    """KUHF with the device-resident iteration loop (one fetch per cycle)."""
    diis_space: int = 8

    # -- overridable traced Fock/energy assembly (scf.device_ks swaps in
    #    the KS functional here; everything below it is shared) ----------
    def _veff_args(self):
        """Extra device arrays the traced veff needs (jit *arguments*, not
        closures)."""
        return ()

    def _needs_exx(self):
        """Whether the traced veff builds exact exchange (pure-functional KS
        overrides to False so the image-space metric is never materialized)."""
        return True

    def _trace_veff(self, dm, x_k, w0, ws, h1e):
        """(fock (2, nk, nao, nao), e_elec) under trace.  UHF functional.
        ``ws`` is the precomputed image-space metric (df.get_ws()); K runs
        the gemm serve path (isdf.jk.get_k_kpts_img).  Only w0 = wq[0]
        ships into the step: the full (nk, nip, nip) wq is a 3 GB argument
        the serve never reads (production device-memory headroom)."""
        nk = h1e.shape[0]
        vj = jk_mod.get_j_kpts(x_k, w0, dm)
        vk = jk_mod.get_k_kpts_img(x_k, ws, dm, self._kmesh_t)
        vj_tot = vj[0] + vj[1]
        fock = jnp.stack([h1e + vj_tot - vk[0], h1e + vj_tot - vk[1]])
        e1 = jnp.einsum("skmn,knm->", dm, h1e).real / nk
        ecoul = jnp.einsum("skmn,knm->", dm, vj_tot).real / (2 * nk)
        ex = -jnp.einsum("skmn,sknm->", dm, vk).real / (2 * nk)
        return fock, e1 + ecoul + ex

    def kernel(self, dm0=None):
        log = self._log
        nk, nao = self.h1e.shape[:2]
        na, nb = self.nocc_ab
        cdtype = (jnp.complex128 if self.dtype == jnp.float64
                  else jnp.complex64)
        rdtype = jnp.float64 if self.dtype == jnp.float64 else jnp.float32

        x_np, pen_np = orth_and_penalty(self.s1e, self.ovlp_cutoff)
        consts = dict(
            h1e=to_device(self.h1e, dtype=cdtype),
            s1e=to_device(self.s1e, dtype=cdtype),
            xo=to_device(x_np, dtype=cdtype),
            pen=jnp.asarray(pen_np, dtype=rdtype),
        )
        df = self.with_df
        assert hasattr(df, "x_k") and df.x_k is not None, (
            "DeviceKUHF needs a built FFTISDF J/K provider")
        from fftisdf_tpu.lattice import kpoints as kpt_mod
        self._kmesh_t = tuple(
            int(m) for m in kpt_mod.kpts_to_kmesh(self.cell, self.kpts))
        # image-space serve metric, built once; K-free functionals (pure
        # KS) never materialize it (dummy rides the jit signature unused)
        # only the q=0 slice of wq feeds the traced step (the J metric) —
        # shipping the full (nk, nip, nip) wq was a 3 GB dead argument at
        # the production config
        w0 = jax.jit(lambda w: w[0])(df.wq)
        ws = df.get_ws() if self._needs_exx() else w0

        # AFM on-site bias matrix (host, once)
        bias_np = np.zeros((2, nk, nao, nao), dtype=np.complex128)
        if self.init_spin:
            for ia, (off, nfa) in enumerate(self._atom_blocks()):
                bsc = self.init_spin.get(ia, 0.0)
                if bsc == 0.0:
                    continue
                for sp, sgn in ((0, -1.0), (1, +1.0)):
                    for k in range(nk):
                        bias_np[sp, k, off:off + nfa, off:off + nfa] += (
                            sgn * self.spin_bias * bsc
                            * self.s1e[k][off:off + nfa, off:off + nfa])
        bias = to_device(bias_np, dtype=cdtype)

        m = self.diis_space
        L = 2 * nk * nao * nao
        errs0, focks0, dms0 = jax.jit(
            lambda: (jnp.zeros((m, L), dtype=cdtype),
                     jnp.zeros((m, L), dtype=cdtype),
                     jnp.zeros((m, L), dtype=cdtype)))()
        ok0 = jnp.zeros((m,), dtype=bool)

        if self.level_shift:
            raise NotImplementedError(
                "DeviceKUHF does not implement level_shift — use the "
                "host driver (scf.hf.KUHF) or smearing, the small-gap tool")
        sigma = float(self.smearing)
        method_smear = sigma > 0.0
        smear_method = self.smearing_method
        e_nuc = float(self.e_nuc)
        # a caller-provided density already encodes its magnetic basin —
        # the symmetry-breaking bias is for the init guess only (biasing a
        # seeded Fock kicks the SCF out of the seed's basin; see the host
        # driver's kernel for the measured failure)
        bias_cycles = int(self.bias_cycles) if dm0 is None else 0
        damp = float(self.damp)
        adiis_switch = float(self.adiis_switch)
        has_bias = bool(self.init_spin)

        @partial(jax.jit, static_argnames=())
        def step(dm, errs, focks, dms, ok, n, it, x_k, w0, h1e, s1e, xo,
                 pen, bias, ws, *veff_extra):
            fock, e_elec = self._trace_veff(dm, x_k, w0, ws, h1e,
                                            *veff_extra)
            e_tot = e_elec + e_nuc

            err = jnp.einsum("skmn,sknl,klo->skmo", fock, dm, s1e) \
                - jnp.einsum("kmn,sknl,sklo->skmo", s1e, dm, fock)
            allow_adiis = (jnp.asarray(True) if not has_bias
                           else it >= bias_cycles)
            fock_x, errs, focks, dms, ok, n = _diis_update(
                errs, focks, dms, ok, n, err.reshape(-1), fock.reshape(-1),
                dm.reshape(-1), adiis_switch, allow_adiis)
            fock = fock_x.reshape(fock.shape)
            fock = fock + jnp.where(it < bias_cycles, 1.0, 0.0) * bias

            fo = jnp.einsum("kmp,skmn,knq->skpq", xo.conj(), fock, xo)
            fo = fo + jax.vmap(jnp.diag)(pen)[None].astype(fo.dtype)
            e, c = jnp.linalg.eigh(fo)
            ent = jnp.asarray(0.0, rdtype)
            occs = []
            for sp, nocc in ((0, na), (1, nb)):
                if method_smear:
                    occ_s, ent_s = _smeared_occ(e[sp], nocc, sigma, 1.0,
                                                method=smear_method)
                else:
                    occ_s, ent_s = _fixed_occ(e[sp], nocc, 1.0)
                occs.append(occ_s)
                ent = ent + ent_s
            occ = jnp.stack(occs)
            mo = jnp.einsum("kmp,skpi->skmi", xo, c)
            dm_new = jnp.einsum("skmi,ski,skni->skmn", mo, occ.astype(
                mo.dtype), mo.conj())
            if damp:
                # static python float: linear density mixing, the host
                # driver's semantics — kills 2-state DIIS oscillations in
                # energy-flat d-manifold directions (NiO dzvp production)
                dm_new = (1.0 - damp) * dm_new + damp * dm
            ddm = jnp.max(jnp.abs(dm_new - dm))
            stats = jnp.stack([e_tot.astype(rdtype),
                               ddm.real.astype(rdtype), ent])
            return dm_new, errs, focks, dms, ok, n, stats

        dm = to_device(self.get_init_guess() if dm0 is None
                       else np.asarray(dm0), dtype=cdtype)
        veff_extra = self._veff_args()
        errs, focks, dms, ok = errs0, focks0, dms0, ok0
        n = jnp.asarray(0, jnp.int32)
        e_last, self.converged = 0.0, False
        it = -1
        self.cycle_times = []   # per-cycle wall (the host stats fetch
        #                         syncs the device each cycle, so these are
        #                         real; cycle 0 pays the step compile)
        self.cycle_energies = []  # on-device E_tot of every cycle
        for it in range(self.max_cycle):
            t0 = time.perf_counter()
            dm, errs, focks, dms, ok, n, stats = step(
                dm, errs, focks, dms, ok, n, jnp.asarray(it, jnp.int32),
                df.x_k, w0, consts["h1e"], consts["s1e"], consts["xo"],
                consts["pen"], bias, ws, *veff_extra)
            e_tot, ddm, ent = [float(v) for v in to_host(stats)]
            de = abs(e_tot - e_last)
            self.cycle_times.append(time.perf_counter() - t0)
            self.cycle_energies.append(e_tot)
            log.info("dSCF it %2d  E = %.10f  dE = %.2e  |ddm| = %.2e (%.2fs)",
                     it, e_tot, de, ddm, self.cycle_times[-1])
            if it > max(2, bias_cycles) and de < self.conv_tol \
                    and ddm < np.sqrt(self.conv_tol) * 30:
                self.converged = True
                e_last = e_tot
                self.entropy = ent
                break
            e_last = e_tot
            self.entropy = ent
        self.cycles = it + 1   # iterations actually run
        # the on-device energy reduction is f32-granular (~6e-5 Ha at
        # |E|~340); recompute the final energy AND the molecular orbitals
        # from the converged density on the host in f64 (transfers once) so
        # downstream consumers (mp2, analysis) see the same attributes the
        # host driver provides
        self.dm = to_host(dm)
        fock, vj, vk = self.get_fock(self.dm)
        self.e_tot = float(self.energy_elec(self.dm, vj, vk) + self.e_nuc)
        self.e_free = self.e_tot - sigma * self.entropy / nk
        es, cs, occs, mus = [], [], [], []
        for s, nocc in ((0, na), (1, nb)):
            es_s, cs_s = [], []
            for k in range(nk):
                e, c = _eigh_gen(fock[s, k], self.s1e[k],
                                 cutoff=self.ovlp_cutoff)
                es_s.append(e)
                cs_s.append(c)
            if sigma > 0:
                occ_s, mu_s, _ = smeared_occupations(
                    es_s, nocc, sigma, self.smearing_method, factor=1.0)
                mus.append(mu_s)
            else:
                occ_s = core.fixed_occupations(es_s, nocc, factor=1.0)
            es.append(es_s)
            cs.append(cs_s)
            occs.append(occ_s)
        self.mo_energy = np.asarray(es)
        self.mo_coeff = np.asarray(cs)
        self.mo_occ = np.asarray(occs)
        if mus:
            self.mu = tuple(mus)
        return self.e_tot


@dataclass
class DeviceKRHF(DeviceKUHF):
    """Restricted wrapper: runs the UHF step with na == nb, then presents
    RHF-convention results (spin-summed ``dm`` of shape (nk, nao, nao),
    doubled ``mo_occ``).  For closed shells UHF and RHF coincide; the device
    loop stays a single code path."""
    init_spin: dict = None

    def __post_init__(self):
        if self.init_spin is None:
            self.init_spin = {}
        assert self.cell.nelectron % 2 == 0, "odd electron count: use UHF"
        super().__post_init__()

    def kernel(self, dm0=None):
        if dm0 is not None and np.asarray(dm0).ndim == 3:
            dm0 = np.stack([np.asarray(dm0) / 2.0] * 2)
        e = super().kernel(dm0=dm0)
        # restricted view for downstream consumers (host-KRHF conventions)
        self.dm = self.dm[0] + self.dm[1]
        self.mo_energy = self.mo_energy[0]
        self.mo_coeff = self.mo_coeff[0]
        self.mo_occ = 2.0 * self.mo_occ[0]
        return e

    def get_init_guess(self):
        nk, nao = self.h1e.shape[:2]
        occs, cs = [], []
        for k in range(nk):
            e, c = _eigh_gen(self.h1e[k], self.s1e[k],
                             cutoff=self.ovlp_cutoff)
            occ = np.zeros(c.shape[1])
            occ[: self.cell.nelectron // 2] = 1.0
            occs.append(occ)
            cs.append(c)
        dm1 = np.einsum("kmi,ki,kni->kmn", np.asarray(cs), np.asarray(occs),
                        np.conj(cs))
        return np.stack([dm1, dm1])
