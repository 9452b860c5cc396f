"""k-point TDA and TDDFT (Casida) excitation energies on the ISDF state.

Capability beyond the reference (it stops at ground-state HF,
``/root/reference/fftisdf.py:437-466``): linear-response excitation
energies at arbitrary momentum transfer q — exciton dispersion across the
Brillouin zone — from KRHF (CIS/TDHF) and KRKS (TDA-DFT/TDDFT) references.

Design (accelerator-first):

- The two-electron couplings ride the ISDF factorization: with
  ``(i k1, j k2 | k k3, l k4) = sum_IJ w^q_IJ conj(x1_Ii) x2_Ij
  conj(x3_Jk) x4_Jl`` (isdf.ao2mo.mo_eri), the Coulomb coupling of the
  whole excitation space collapses to ONE nip-vector through w_{-q}, and
  the exchange coupling (hybrids/HF) to nk gathered nip x nip Hadamard-
  gram products — all matmuls, no O(npair^2) integral tensor.
- The adiabatic xc kernel needs no hand-derived fxc: the coupling is the
  exact Hessian-vector product of the *discrete* Exc (scf.xc evaluates
  Exc on the FFT grid; its gradient is the SCF potential, FD-gated), so
  ``fxc . t = jvp(grad(Exc))[rho0](t)`` — LDA and GGA uniformly, with the
  GGA gradient terms supplied by autodiff through the FFT density
  gradient.  Complex transition densities (q != 0 Bloch phases) split
  into two real tangents by linearity.
- Dense solves for small spaces; a matrix-free Davidson (the matvec is
  one jitted pass) for production.

Conventions: an excitation at momentum-transfer index ``q`` moves an
electron i at k_i into a at k_a with kpts[k_a] = kpts[k_i] + kpts[q]
(mod G); matrix elements between supercell-normalized configurations
carry 1/nk per assembled Bloch ERI (pinned by the k-mesh <-> supercell
consistency gate, tests/test_tddft.py).

Singlet TDA (closed shell, complex orbitals; chemists' notation):

    A_{(ki,ia),(kj,jb)} = delta * (e_a - e_i)
        + [2 (a i | j b) - c_hf (a b | j i)] / nk + (ia| fxc |jb)

with (ia|fxc|jb) = integral p_ia*(r) fxc(r, r') p_jb(r'), p_jb =
conj(psi_j) psi_b.  Triplet: no Coulomb term, spin-flip kernel
(f_uu - f_ud).  Full TDDFT pairs (X at q, Y at -q) in the standard
[[A_q, B], [-B*, -conj(A_{-q})]] non-Hermitian eigenproblem with
B_{(ia),(jb)} = [2 (a i | b j) - c_hf (a j | b i)] / nk + xc term.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.lattice import kpoints as kpt_mod
from fftisdf_tpu.linalg.fft import fft3, ifft3
from fftisdf_tpu.linalg.coulomb import get_coulG
from fftisdf_tpu.scf import xc as xc_mod
from fftisdf_tpu.utils.device import to_device, to_host, jit_take


# ----------------------------------------------------------------------
# setup helpers

def _ka_map(k2c, q):
    """ka_of[ki] = index of kpts[ki] + kpts[q] (mod G)."""
    nk = k2c.shape[0]
    out = np.empty(nk, dtype=np.int64)
    for ki in range(nk):
        hits = np.nonzero(k2c[ki] == q)[0]
        assert len(hits) == 1, "k-mesh not closed under the q shift"
        out[ki] = hits[0]
    return out


def _mo_setup(mf):
    """(mo_c, eo, ev, nocc) with an insulating-occupation check."""
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    assert mo_c.ndim == 3, "restricted (KRHF/KRKS) reference required"
    assert np.all((mo_o < 1e-6) | (np.abs(mo_o - 2.0) < 1e-6)), \
        "fractional occupations (smearing): TDA needs an insulating gap"
    nocc = int(round(mo_o[0].sum() / 2))
    assert 0 < nocc < mo_c.shape[-1], "need occupied and virtual orbitals"
    return mo_c, mo_e, nocc


def _spec_of(mf):
    """(hyb, hyb_sr, omega, spec-or-None): exchange fractions (full-range
    and erfc-screened SR with its range parameter) and xc terms."""
    spec = getattr(mf, "_spec", None)
    if spec is None:                      # KRHF
        return 1.0, 0.0, 0.0, None
    if spec.is_mgga:
        raise NotImplementedError(
            "adiabatic meta-GGA kernel (tau response) not implemented")
    hyb_sr = float(getattr(spec, "hyb_sr", 0.0))
    return (spec.hyb, hyb_sr, float(getattr(spec, "omega", 0.0)),
            spec if spec.terms else None)


# ----------------------------------------------------------------------
# jitted matvec pieces

@partial(jax.jit, static_argnames=("nk",))
def _coul_piece(xo, xva, wqc, x, nk):
    """Singlet Coulomb coupling 2 (a i | j b)/nk via the metric sector of
    momentum -q: one nip-vector contraction for the whole space.

    xo (nk, nip, no): occupied-projected interpolation vectors at k_i;
    xva (nk, nip, nv): virtual-projected at k_a = k_i + q."""
    s = jnp.einsum("kJj,kJb,kjb->J", xo.conj(), xva, x)
    u = wqc @ s
    return (2.0 / nk) * jnp.einsum("I,kIa,kIi->kia", u, xva.conj(), xo)


@partial(jax.jit, static_argnames=("nk",))
def _exch_piece(xo, xva, wq, qx, x, nk):
    """Exchange coupling -(a b | j i)/nk (caller scales by c_hf).

    T_kj = sum_jb xva[kj]_Ib conj(xo[kj]_Jj) X_jb is kj-local; each row
    block ki then contracts the gathered metric sectors
    qx[ki, kj] = index of (k_j - k_i)."""
    t_k = jnp.einsum("kIb,kjb,kJj->kIJ", xva, x, xo.conj())

    def row(args):
        xva_i, xo_i, qx_i = args
        m = jnp.einsum("kIJ,kIJ->IJ", jnp.take(wq, qx_i, axis=0), t_k)
        return jnp.einsum("Ia,Ji,IJ->ia", xva_i.conj(), xo_i, m)

    return -(1.0 / nk) * jax.lax.map(row, (xva, xo, qx))


@partial(jax.jit, static_argnames=("nk",))
def _coul_piece_u(xo, xva, wqc, x, nk):
    """Spin-channel Coulomb coupling (a i | j b)/nk of ONE ket channel
    (no spin factor 2; the caller sums ket channels and reads each bra
    channel)."""
    s = jnp.einsum("kJj,kJb,kjb->J", xo.conj(), xva, x)
    return wqc @ s


@partial(jax.jit, static_argnames=("nk",))
def _coul_read_u(u, xo, xva, nk):
    return (1.0 / nk) * jnp.einsum("I,kIa,kIi->kia", u, xva.conj(), xo)


@partial(jax.jit, static_argnames=("spec", "fmesh", "weight", "nk"))
def _xc_piece_u(psio_a, psiva_a, psio_b, psiva_b, rho0, gv, xa, xb, spec,
                fmesh, weight, nk):
    """Spin-resolved adiabatic kernel coupling: the full (2, ng) tangent
    (t_alpha, t_beta) through one Hessian-vector product; returns the
    couplings read in both bra channels ((nk,noa,nva), (nk,nob,nvb))."""
    gvt = gv.T

    def total(r):
        if spec.is_gga:
            g = jnp.stack([
                ifft3(1j * gvt[i] * fft3(r.astype(
                    jnp.complex64 if r.dtype == jnp.float32
                    else jnp.complex128), fmesh), fmesh).real
                for i in range(3)], axis=1)
            sigma = jnp.stack([jnp.sum(g[0] * g[0], axis=0),
                               jnp.sum(g[0] * g[1], axis=0),
                               jnp.sum(g[1] * g[1], axis=0)])
        else:
            sigma = None
        return weight * jnp.sum(xc_mod._exc_density(r, sigma, spec))

    ta = jnp.einsum("kgj,kgb,kjb->g", psio_a.conj(), psiva_a, xa)
    tb = jnp.einsum("kgj,kgb,kjb->g", psio_b.conj(), psiva_b, xb)

    def hvp(dr):
        return jax.jvp(jax.grad(total), (rho0,), (dr,))[1]

    tre = jnp.stack([jnp.real(ta), jnp.real(tb)])
    tim = jnp.stack([jnp.imag(ta), jnp.imag(tb)])
    v = hvp(tre) + 1j * hvp(tim)
    ya = (1.0 / nk) * jnp.einsum("g,kgi,kga->kia", v[0], psio_a,
                                 psiva_a.conj())
    yb = (1.0 / nk) * jnp.einsum("g,kgi,kga->kia", v[1], psio_b,
                                 psiva_b.conj())
    return ya, yb


@partial(jax.jit, static_argnames=("spec", "fmesh", "weight", "singlet",
                                   "nk"))
def _xc_piece(psio, psiva, psio2, psiva2, rho0, gv, x, spec, fmesh,
              weight, singlet, nk):
    """Adiabatic xc-kernel coupling via the exact Hessian-vector product
    of the discrete Exc.

    t(r) = sum conj(psio2_j) psiva2_b X_jb is the (complex, Bloch-phased)
    transition density of the KET pairs; the response potential is
    jvp(grad(Exc))[rho0] applied to its real and imaginary parts
    (the kernel is a real linear map), spin-summed for singlets
    (f_uu + f_ud) and spin-flipped for triplets (f_uu - f_ud); the BRA
    pairs (psio, psiva) then take its matrix elements.  psio2/psiva2
    allow B-matrix couplings where bra and ket pair spaces differ."""
    gvt = gv.T

    def total(r):
        if spec.is_gga:
            g = jnp.stack([
                ifft3(1j * gvt[i] * fft3(r.astype(
                    jnp.complex64 if r.dtype == jnp.float32
                    else jnp.complex128), fmesh), fmesh).real
                for i in range(3)], axis=1)
            sigma = jnp.stack([jnp.sum(g[0] * g[0], axis=0),
                               jnp.sum(g[0] * g[1], axis=0),
                               jnp.sum(g[1] * g[1], axis=0)])
        else:
            sigma = None
        return weight * jnp.sum(xc_mod._exc_density(r, sigma, spec))

    sgn = 1.0 if singlet else -1.0
    t = jnp.einsum("kgj,kgb,kjb->g", psio2.conj(), psiva2, x)

    def hvp(dr):
        tangent = jnp.stack([dr, sgn * dr])
        return jax.jvp(jax.grad(total), (rho0,), (tangent,))[1][0]

    v = hvp(jnp.real(t)) + 1j * hvp(jnp.imag(t))
    # matrix element of the response potential dv = hvp/weight against
    # the bra pairs, quadrature weight w: w sum conj(p_ia) dv = sum p hvp
    return (1.0 / nk) * jnp.einsum("g,kgi,kga->kia", v, psio,
                                   psiva.conj())


@partial(jax.jit, static_argnames=("fmesh", "nk"))
def _coul_grid_piece(psio, psiva, coulg, eiqr, x, fmesh, nk):
    """Exact grid-route Coulomb coupling (df-free path and oracle):
    the transition density's periodic part is Poisson-solved at q."""
    t = jnp.einsum("kgj,kgb,kjb->g", psio.conj(), psiva, x)
    v = ifft3(fft3(t * eiqr.conj(), fmesh) * coulg, fmesh) * eiqr
    return (2.0 / nk) * jnp.einsum("g,kgi,kga->kia", v, psio,
                                   psiva.conj())


@partial(jax.jit, static_argnames=("c",))
def _scale(x, c):
    return x * c


@jax.jit
def _mul(a, b):
    return a * b


@jax.jit
def _axpy(*terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


# ----------------------------------------------------------------------
# the TDA operator

class TDAOperator:
    """Matrix-free TDA response operator at momentum-transfer index q.

    ``mf``: converged KRHF or KRKS (insulating occupations).
    ``df``: built FFTISDF serving the two-electron couplings; optional
    for pure (hyb=0) functionals and plain Coulomb (the exact grid route
    is used when absent).
    """

    def __init__(self, mf, df=None, q=0, singlet=True):
        cell, kpts = mf.cell, np.asarray(mf.kpts)
        nk = len(kpts)
        self.nk, self.q, self.singlet = nk, int(q), bool(singlet)
        self.hyb, self.hyb_sr, self.omega, self.spec = _spec_of(mf)
        if df is None and (self.hyb != 0.0 or self.hyb_sr != 0.0):
            raise ValueError("exact-exchange coupling (CIS/hybrid TDA) "
                             "needs a built FFTISDF: pass df=")
        mo_c, mo_e, nocc = _mo_setup(mf)
        nao, nmo = mo_c.shape[1:]
        self.nocc, self.nvir = nocc, nmo - nocc
        k2c = (df.kconserv2() if df is not None
               else kpt_mod.get_kconserv2(cell, kpts))
        self.ka_of = _ka_map(k2c, self.q)
        self.delta = np.stack([
            mo_e[self.ka_of[ki]][None, nocc:] - mo_e[ki][:nocc, None]
            for ki in range(nk)])                    # (nk, no, nv)

        cdt = None
        self._isdf = df is not None
        if self._isdf:
            cdt = df.x_k.dtype
            xo, xva = [], []
            for ki in range(nk):
                xk = jit_take(df.x_k, ki)
                xa = jit_take(df.x_k, int(self.ka_of[ki]))
                co = to_device(mo_c[ki][:, :nocc], dtype=cdt)
                cv = to_device(mo_c[self.ka_of[ki]][:, nocc:], dtype=cdt)
                xo.append(jax.jit(lambda a, b: a @ b)(xk, co))
                xva.append(jax.jit(lambda a, b: a @ b)(xa, cv))
            self.xo = jax.jit(lambda *a: jnp.stack(a))(*xo)
            self.xva = jax.jit(lambda *a: jnp.stack(a))(*xva)
            self.wq = df.wq
            # screened hybrids (HSE06): the SR exchange block uses the
            # erfc-screened metric from the same interpolation basis
            self.wq_sr = (df.get_wq_omega(-self.omega)
                          if self.hyb_sr != 0.0 else None)
            # Coulomb sector: pair (conj a at k_a, i at k_i) carries -q
            self.qc = int(k2c[self.ka_of[0], 0])
            # exchange sectors: pair (conj a at k_a, b at k_b) carries
            # k_b - k_a = k_j - k_i
            self.qx = to_device(k2c.astype(np.int32))
        self._grid = (not self._isdf) or (self.spec is not None)
        if self._grid:
            ao = mf._ao                                 # (nk, ng, nao)
            adt = ao.dtype
            rdt = jnp.float64 if adt == jnp.complex128 else jnp.float32
            po, pva = [], []
            for ki in range(nk):
                co = to_device(mo_c[ki][:, :nocc], dtype=adt)
                cv = to_device(mo_c[self.ka_of[ki]][:, nocc:], dtype=adt)
                po.append(jax.jit(lambda a, b: a @ b)(
                    jit_take(ao, ki), co))
                pva.append(jax.jit(lambda a, b: a @ b)(
                    jit_take(ao, int(self.ka_of[ki])), cv))
            self.psio = jax.jit(lambda *a: jnp.stack(a))(*po)
            self.psiva = jax.jit(lambda *a: jnp.stack(a))(*pva)
            self.fmesh = tuple(int(m) for m in cell.mesh)
            ng = int(np.prod(self.fmesh))
            self.weight = float(cell.vol) / ng
            self.gv = jnp.asarray(cell.get_Gv(self.fmesh), dtype=rdt)
            if self.spec is not None:
                dm = getattr(mf, "dm", None)
                assert dm is not None, "run mf.kernel() first"
                dm_dev = to_device(np.asarray(dm).astype(complex),
                                   dtype=adt)
                from fftisdf_tpu.scf.ks import _spin_rho
                self.rho0 = jax.jit(
                    lambda ao, d: _spin_rho(ao, d[None], nk, 1))(ao,
                                                                 dm_dev)
            if not self._isdf:
                qvec = kpts[self.q] - kpts[0]
                coords = cell.gen_uniform_grids(self.fmesh)
                self.coulg = jnp.asarray(
                    get_coulG(cell, q=qvec, mesh=self.fmesh,
                              trunc=getattr(mf, "trunc", None)), dtype=rdt)
                self.eiqr = jax.jit(
                    lambda c, v: jnp.exp(1j * (c @ v)))(
                        jnp.asarray(coords, dtype=rdt),
                        jnp.asarray(qvec, dtype=rdt))
        self._cdt = cdt if cdt is not None else mf._ao.dtype
        rdt = (jnp.float64 if self._cdt == jnp.complex128 else jnp.float32)
        self._delta_dev = to_device(self.delta.astype(float), dtype=rdt)
        self.shape = (nk, nocc, self.nvir)
        self.size = nk * nocc * self.nvir

    # ------------------------------------------------------------------
    def matvec(self, x):
        """A @ x for host x of shape (nk, no, nv) (or flat); returns the
        same shape on host."""
        flat = np.asarray(x).ndim == 1
        xd = to_device(np.asarray(x).reshape(self.shape).astype(complex),
                       dtype=self._cdt)
        terms = [_mul(self._delta_dev, xd)]
        if self.singlet:
            if self._isdf:
                terms.append(_coul_piece(self.xo, self.xva,
                                         jit_take(self.wq, self.qc),
                                         xd, self.nk))
            else:
                terms.append(_coul_grid_piece(
                    self.psio, self.psiva, self.coulg, self.eiqr, xd,
                    self.fmesh, self.nk))
        if self.hyb != 0.0:
            ex = _exch_piece(self.xo, self.xva, self.wq, self.qx, xd,
                             self.nk)
            terms.append(_scale(ex, float(self.hyb)))
        if self.hyb_sr != 0.0:
            ex = _exch_piece(self.xo, self.xva, self.wq_sr, self.qx, xd,
                             self.nk)
            terms.append(_scale(ex, float(self.hyb_sr)))
        if self.spec is not None:
            terms.append(_xc_piece(self.psio, self.psiva, self.psio,
                                   self.psiva, self.rho0, self.gv, xd,
                                   self.spec, self.fmesh, self.weight,
                                   self.singlet, self.nk))
        y = _axpy(*terms) if len(terms) > 1 else terms[0]
        out = to_host(y)
        return out.ravel() if flat else out

    def dense(self):
        """Materialize A by unit-vector application (small spaces /
        validation; also exercises the matvec itself)."""
        n = self.size
        a = np.empty((n, n), dtype=complex)
        e = np.zeros(n, dtype=complex)
        for j in range(n):
            e[j] = 1.0
            a[:, j] = self.matvec(e)
            e[j] = 0.0
        return a


# ----------------------------------------------------------------------
# unrestricted TDA (KUHF / KUKS references)

class UTDAOperator:
    """Spin-conserving TDA operator for unrestricted (KUHF/KUKS)
    references — the response method for spin-polarized systems (the
    north-star NiO-AFM).  Excitation space: both spin channels
    concatenated, X = [X_a.ravel(), X_b.ravel()] with per-spin
    (nk, no_s, nv_s) blocks.

        A_{(s,ia),(s',jb)} = d_ss' d delta^s + (a_s i_s | j_s' b_s')/nk
            - d_ss' c_hf (a b | j i)/nk + (ia| f_{ss'} |jb)

    (cross-spin Coulomb, same-spin exchange, full spin-resolved kernel —
    for a closed-shell reference the spectrum is exactly the union of
    the restricted singlet and triplet TDA spectra, gated in tests).
    """

    def __init__(self, mf, df=None, q=0):
        cell, kpts = mf.cell, np.asarray(mf.kpts)
        nk = len(kpts)
        self.nk, self.q = nk, int(q)
        self.hyb, self.hyb_sr, self.omega, self.spec = _spec_of(mf)
        if df is None:
            raise ValueError("UTDA needs a built FFTISDF (df=)")
        mo_c = np.asarray(mf.mo_coeff)
        mo_e = np.asarray(mf.mo_energy)
        mo_o = np.asarray(mf.mo_occ)
        assert mo_c.ndim == 4, "unrestricted (KUHF/KUKS) reference required"
        assert np.all((mo_o < 1e-6) | (np.abs(mo_o - 1.0) < 1e-6)), \
            "fractional occupations (smearing): TDA needs an insulating gap"
        self.noccs = [int(round(mo_o[s][0].sum())) for s in range(2)]
        nmo = mo_c.shape[-1]
        self.nvirs = [nmo - n for n in self.noccs]
        k2c = df.kconserv2()
        self.ka_of = _ka_map(k2c, self.q)
        cdt = df.x_k.dtype
        self._cdt = cdt
        rdt = jnp.float64 if cdt == jnp.complex128 else jnp.float32
        self.deltas, self.xo, self.xva = [], [], []
        for s in range(2):
            no = self.noccs[s]
            self.deltas.append(np.stack([
                mo_e[s, self.ka_of[ki]][None, no:]
                - mo_e[s, ki][:no, None] for ki in range(nk)]))
            xo, xva = [], []
            for ki in range(nk):
                xk = jit_take(df.x_k, ki)
                xa = jit_take(df.x_k, int(self.ka_of[ki]))
                co = to_device(mo_c[s, ki][:, :no], dtype=cdt)
                cv = to_device(mo_c[s, self.ka_of[ki]][:, no:], dtype=cdt)
                xo.append(jax.jit(lambda a, b: a @ b)(xk, co))
                xva.append(jax.jit(lambda a, b: a @ b)(xa, cv))
            self.xo.append(jax.jit(lambda *a: jnp.stack(a))(*xo))
            self.xva.append(jax.jit(lambda *a: jnp.stack(a))(*xva))
        self._delta_dev = [to_device(d.astype(float), dtype=rdt)
                           for d in self.deltas]
        self.wq = df.wq
        self.wq_sr = (df.get_wq_omega(-self.omega)
                      if self.hyb_sr != 0.0 else None)
        self.qc = int(k2c[self.ka_of[0], 0])
        self.qx = to_device(k2c.astype(np.int32))
        if self.spec is not None:
            ao = mf._ao
            adt = ao.dtype
            dm = getattr(mf, "dm", None)
            assert dm is not None, "run mf.kernel() first"
            from fftisdf_tpu.scf.ks import _spin_rho
            self.rho0 = jax.jit(
                lambda ao, d: _spin_rho(ao, d, nk, 2))(
                    ao, to_device(np.asarray(dm).astype(complex),
                                  dtype=adt))
            self.psio, self.psiva = [], []
            for s in range(2):
                no = self.noccs[s]
                po, pva = [], []
                for ki in range(nk):
                    co = to_device(mo_c[s, ki][:, :no], dtype=adt)
                    cv = to_device(mo_c[s, self.ka_of[ki]][:, no:],
                                   dtype=adt)
                    po.append(jax.jit(lambda a, b: a @ b)(
                        jit_take(ao, ki), co))
                    pva.append(jax.jit(lambda a, b: a @ b)(
                        jit_take(ao, int(self.ka_of[ki])), cv))
                self.psio.append(jax.jit(lambda *a: jnp.stack(a))(*po))
                self.psiva.append(jax.jit(lambda *a: jnp.stack(a))(*pva))
            self.fmesh = tuple(int(m) for m in cell.mesh)
            ng = int(np.prod(self.fmesh))
            self.weight = float(cell.vol) / ng
            self.gv = jnp.asarray(cell.get_Gv(self.fmesh), dtype=rdt)
        self.sizes = [nk * self.noccs[s] * self.nvirs[s] for s in range(2)]
        self.size = sum(self.sizes)

    def matvec(self, x):
        """A @ x for flat x of length sum_s nk*no_s*nv_s."""
        x = np.asarray(x).ravel()
        xs = [x[:self.sizes[0]].reshape(self.nk, self.noccs[0],
                                        self.nvirs[0]),
              x[self.sizes[0]:].reshape(self.nk, self.noccs[1],
                                        self.nvirs[1])]
        xd = [to_device(a.astype(complex), dtype=self._cdt) for a in xs]
        outs = [[_mul(self._delta_dev[s], xd[s])] for s in range(2)]
        # cross-spin Coulomb: one shared nip vector
        wqc = jit_take(self.wq, self.qc)
        u = _axpy(_coul_piece_u(self.xo[0], self.xva[0], wqc, xd[0],
                                self.nk),
                  _coul_piece_u(self.xo[1], self.xva[1], wqc, xd[1],
                                self.nk))
        for s in range(2):
            outs[s].append(_coul_read_u(u, self.xo[s], self.xva[s],
                                        self.nk))
            if self.hyb != 0.0:
                ex = _exch_piece(self.xo[s], self.xva[s], self.wq,
                                 self.qx, xd[s], self.nk)
                outs[s].append(_scale(ex, float(self.hyb)))
            if self.hyb_sr != 0.0:
                ex = _exch_piece(self.xo[s], self.xva[s], self.wq_sr,
                                 self.qx, xd[s], self.nk)
                outs[s].append(_scale(ex, float(self.hyb_sr)))
        if self.spec is not None:
            ya, yb = _xc_piece_u(self.psio[0], self.psiva[0],
                                 self.psio[1], self.psiva[1], self.rho0,
                                 self.gv, xd[0], xd[1], self.spec,
                                 self.fmesh, self.weight, self.nk)
            outs[0].append(ya)
            outs[1].append(yb)
        ys = [to_host(_axpy(*o)) for o in outs]
        return np.concatenate([np.asarray(y).ravel() for y in ys])

    def dense(self):
        n = self.size
        a = np.empty((n, n), dtype=complex)
        e = np.zeros(n, dtype=complex)
        for j in range(n):
            e[j] = 1.0
            a[:, j] = self.matvec(e)
            e[j] = 0.0
        return a


def utda(mf, df, q=0, nroots=5, tol=1e-6, max_cycle=200, dense=None):
    """Lowest spin-conserving TDA excitations of an unrestricted
    reference at momentum-transfer index q."""
    op = UTDAOperator(mf, df, q=q)
    if dense is None:
        dense = op.size <= 800
    if dense:
        a = op.dense()
        w = np.sort(np.linalg.eigvals(a).real)
        herm = float(np.abs(a - a.conj().T).max())
        return (w[:nroots] if nroots else w), {
            "op": op, "nonhermiticity": herm, "dense": True}
    diag = np.concatenate([d.ravel() for d in op.deltas])
    w, x, conv = davidson(op.matvec, diag, op.size, nroots=nroots,
                          tol=tol, max_cycle=max_cycle)
    return w, {"op": op, "converged": conv, "x": x, "dense": False}


# ----------------------------------------------------------------------
# drivers

def tda(mf, df=None, q=0, nroots=5, singlet=True, tol=1e-6,
        max_cycle=200, dense=None):
    """Lowest TDA excitation energies at momentum-transfer index q.

    Returns (omega (nroots,) real-sorted, info dict).  ``dense=True``
    forces full diagonalization (all roots); default densifies small
    spaces and runs Davidson above 800 pairs."""
    op = TDAOperator(mf, df, q=q, singlet=singlet)
    if dense is None:
        dense = op.size <= 800
    if dense:
        a = op.dense()
        herm = float(np.abs(a - a.conj().T).max())
        w, x = np.linalg.eigh(0.5 * (a + a.conj().T))
        sel = slice(None, nroots) if nroots else slice(None)
        return w[sel], {"op": op, "nonhermiticity": herm, "dense": True,
                        "x": x[:, sel]}
    w, x, conv = davidson(op.matvec, op.delta.ravel(), op.size,
                          nroots=nroots, tol=tol, max_cycle=max_cycle)
    return w, {"op": op, "converged": conv, "x": x, "dense": False}


def davidson(matvec, diag, n, nroots=4, tol=1e-6, max_space=60,
             max_cycle=200):
    """Davidson for the lowest eigenvalues of a (near-)Hermitian operator
    given by ``matvec`` on flat complex vectors; ``diag`` preconditions.
    Returns (omega real (nroots,), ritz vectors (n, nroots), converged).
    """
    nroots = min(nroots, n)
    order = np.argsort(diag)
    vs = np.zeros((n, nroots), dtype=complex)
    for r in range(nroots):
        vs[order[r], r] = 1.0
    v = vs
    theta = np.zeros(nroots)
    xr = vs
    conv = False
    for _ in range(max_cycle):
        v, _ = np.linalg.qr(v)
        mv = np.stack([matvec(v[:, j]) for j in range(v.shape[1])],
                      axis=1)
        h = v.conj().T @ mv
        h = 0.5 * (h + h.conj().T)
        w, y = np.linalg.eigh(h)
        theta, yv = w[:nroots], y[:, :nroots]
        xr = v @ yv
        r = mv @ yv - xr * theta[None, :]
        rn = np.linalg.norm(r, axis=0)
        if np.all(rn < tol):
            conv = True
            break
        if v.shape[1] + nroots > max_space:
            v = xr
            continue
        new = []
        for j in range(nroots):
            if rn[j] < tol:
                continue
            den = diag - theta[j]
            den = np.where(np.abs(den) < 1e-8, 1e-8, den)
            new.append(r[:, j] / den)
        if not new:
            conv = True
            break
        v = np.concatenate([v] + [c[:, None] for c in new], axis=1)
    return theta, xr, conv


# ----------------------------------------------------------------------
# spectra: velocity-gauge transition moments (q = 0 optical limit)

def momentum_matrix(mf, nocc=None):
    """Momentum (velocity-gauge) matrix elements p^d_{k,ia} =
    <psi_ik| d/dr_d |psi_ak>, shape (3, nk, no, nv) — the PBC-legal
    transition-dipole surrogate (the position operator is ill-defined
    under periodic boundary conditions; velocity gauge needs only the
    band-limited FFT gradient, scf.xc.bloch_ao_grad)."""
    cell, kpts = mf.cell, np.asarray(mf.kpts)
    nk = len(kpts)
    if nocc is None:
        mo_c, _, no = _mo_setup(mf)
    else:
        mo_c, no = np.asarray(mf.mo_coeff), nocc
    ao = mf._ao
    adt = ao.dtype
    rdt = jnp.float64 if adt == jnp.complex128 else jnp.float32
    fmesh = tuple(int(m) for m in cell.mesh)
    ng = int(np.prod(fmesh))
    weight = float(cell.vol) / ng
    coords = jnp.asarray(cell.gen_uniform_grids(fmesh), dtype=rdt)
    gv = jnp.asarray(cell.get_Gv(fmesh), dtype=rdt)
    kpts_d = jnp.asarray(kpts, dtype=rdt)
    co = to_device(np.asarray(mo_c)[:, :, :no].astype(complex), dtype=adt)
    cv = to_device(np.asarray(mo_c)[:, :, no:].astype(complex), dtype=adt)

    @jax.jit
    def kernel(ao, co, cv, kpts_d, coords, gv):
        dphi = xc_mod.bloch_ao_grad(ao, kpts_d, coords, gv, fmesh)
        psio = jnp.einsum("kgm,kmi->kgi", ao, co)
        dpsiv = jnp.einsum("dkgm,kma->dkga", dphi, cv)
        return weight * jnp.einsum("kgi,dkga->dkia", psio.conj(), dpsiv)

    return kernel(ao, co, cv, kpts_d, coords, gv)


def oscillator_strengths(mf, omega, xvecs, restricted=True, nocc=None):
    """Velocity-gauge oscillator strengths of q=0 TDA roots:
    f_n = 2 |<0| p |n>|^2 / (3 omega_n), <0|p|n> = sqrt(2) sum X p
    (the sqrt(2) is the closed-shell spin factor; drop with
    restricted=False for spin-resolved vectors; supercell-normalized
    orbitals make the Bloch cell matrix elements the supercell ones with
    no extra nk factor, so sum_n f_n -> nk * nelec_cell under TRK).
    xvecs: (size, nroots) normalized TDA eigenvectors in the operator's
    flat layout."""
    p = np.asarray(to_host(momentum_matrix(mf, nocc=nocc)))
    xv = np.asarray(xvecs)
    out = []
    spin = 2.0 if restricted else 1.0
    for n in range(xv.shape[1]):
        x = xv[:, n].reshape(p.shape[1:])
        m = np.einsum("dkia,kia->d", p, x) * np.sqrt(spin)
        out.append(2.0 * float(np.vdot(m, m).real) / (3.0 * omega[n]))
    return np.asarray(out)


def density_fluctuation(mf, op):
    """G = 0 Fourier components of the transition pair densities at the
    operator's momentum transfer: rho_q(k,ia) = integral conj(psi_ik)
    e^{-i q r} psi_{a,k+q} — the coupling of each excitation to a probe
    of momentum q (EELS / dielectric matrix head).  As q -> 0 this obeys
    rho_q -> -i q . p_ia / (e_a - e_i) (gated).  Returns (nk, no, nv)."""
    cell, kpts = mf.cell, np.asarray(mf.kpts)
    nk = len(kpts)
    ao = mf._ao
    adt = ao.dtype
    rdt = jnp.float64 if adt == jnp.complex128 else jnp.float32
    fmesh = tuple(int(m) for m in cell.mesh)
    ng = int(np.prod(fmesh))
    weight = float(cell.vol) / ng
    coords = jnp.asarray(cell.gen_uniform_grids(fmesh), dtype=rdt)
    qvec = jnp.asarray(kpts[op.q] - kpts[0], dtype=rdt)
    mo_c, _, no = _mo_setup(mf)
    co = to_device(mo_c[:, :, :no].astype(complex), dtype=adt)
    cv = to_device(np.stack([mo_c[int(op.ka_of[k])][:, no:]
                             for k in range(nk)]).astype(complex),
                   dtype=adt)
    ka = jnp.asarray(op.ka_of)

    @jax.jit
    def kernel(ao, co, cv, coords, qvec, ka):
        phase = jnp.exp(-1j * (coords @ qvec)).astype(ao.dtype)
        psio = jnp.einsum("kgm,kmi->kgi", ao, co)
        psiva = jnp.einsum("kgm,kma->kga", jnp.take(ao, ka, axis=0), cv)
        return weight * jnp.einsum("kgi,g,kga->kia", psio.conj(), phase,
                                   psiva)

    return kernel(ao, co, cv, coords, qvec, ka)


def dielectric_tda(mf, df, q, omegas, eta=0.005, nroots=0, singlet=True):
    """Macroscopic dielectric function eps_M(q, omega) and loss function
    -Im 1/eps_M from the TDA spectral representation at momentum-transfer
    index q (EELS at the mesh's finite q vectors; q=0 is the optical
    head and requires |q| != 0, so pass a nonzero sector):

        eps_M = 1 - (4 pi / |q|^2 V_sc) sum_n |m_n|^2
                    [1/(w - w_n + i eta) - 1/(w + w_n + i eta)],
        m_n = sqrt(2) sum X^n_kia rho_q(k,ia),  V_sc = nk vol.

    Returns (eps (nw,) complex, detail dict)."""
    kpts = np.asarray(mf.kpts)
    qvec = kpts[int(q)] - kpts[0]
    qn = float(np.linalg.norm(qvec))
    assert qn > 1e-10, "q = 0 has no density head: use a finite-q sector"
    w, info = tda(mf, df, q=q, nroots=nroots, singlet=singlet, dense=True)
    rho = np.asarray(to_host(density_fluctuation(mf, info["op"])))
    xv = np.asarray(info["x"])
    # m_n = <0|rho_q|n> = sqrt(2) sum_kia X^n rho_q (momentum-conserving
    # head: |n> carries +q, the probe removes it)
    m2 = np.array([abs(np.sqrt(2.0) * np.sum(rho.ravel() * xv[:, n])) ** 2
                   for n in range(xv.shape[1])])
    vsc = len(kpts) * float(mf.cell.vol)
    pref = 4.0 * np.pi / (qn * qn * vsc)
    omegas = np.asarray(omegas)
    eps = np.ones(len(omegas), dtype=complex)
    for wn, mn in zip(w, m2):
        eps -= pref * mn * (1.0 / (omegas - wn + 1j * eta)
                            - 1.0 / (omegas + wn + 1j * eta))
    return eps, {"omega_n": w, "m2": m2, "loss": -np.imag(1.0 / eps)}


# ----------------------------------------------------------------------
# full TDDFT / TDHF (Casida)

def tddft(mf, df=None, q=0, nroots=5, singlet=True):
    """Full linear-response (Casida) excitation energies at momentum q:
    the non-Hermitian eigenproblem pairing excitations at q with
    de-excitations at -q,

        [[A_q, B], [-conj(B), -conj(A_{-q})]] [X; Y] = omega [X; Y],

    dense (small spaces).  Returns (positive branch sorted, info)."""
    cell, kpts = mf.cell, np.asarray(mf.kpts)
    k2c = (df.kconserv2() if df is not None
           else kpt_mod.get_kconserv2(cell, kpts))
    s_kpts = cell.get_scaled_kpts(kpts)
    qm = kpt_mod.member(-s_kpts[int(q)], s_kpts, strict=False)
    assert qm >= 0, "the -q point is not on the mesh"
    op = TDAOperator(mf, df, q=q, singlet=singlet)
    opm = TDAOperator(mf, df, q=int(qm), singlet=singlet)
    a = op.dense()
    am = opm.dense()
    b = _b_dense(mf, df, op, opm, k2c, singlet)
    n = op.size
    m = np.block([[a, b], [-b.conj(), -am.conj()]])
    w = np.linalg.eigvals(m)
    pos = np.sort(w.real[w.real > 1e-10])
    return (pos[:nroots] if nroots else pos), {
        "a": a, "b": b, "a_minus_q": am}


def _b_dense(mf, df, op, opm, k2c, singlet):
    """B_{(ia at q),(jb at -q)} = [2 (a i | b j) - c_hf (a j | b i)]/nk
    + xc coupling of the bra pairs with the -q-sector ket pairs."""
    from fftisdf_tpu.isdf.ao2mo import mo_eri

    nk, no, nv = op.shape
    mo_c = np.asarray(mf.mo_coeff)
    n = op.size
    b = np.zeros((n, n), dtype=complex)
    idx = lambda k, i, a_: (k * no + i) * nv + a_

    if singlet or op.hyb != 0.0 or op.hyb_sr != 0.0:
        assert df is not None, "Casida B couplings need df"
        for ki in range(nk):
            ka = int(op.ka_of[ki])
            cv_a = mo_c[ka][:, no:]
            co_i = mo_c[ki][:, :no]
            for kj in range(nk):
                kb = int(opm.ka_of[kj])
                cv_b = mo_c[kb][:, no:]
                co_j = mo_c[kj][:, :no]
                blk = np.zeros((no * nv, no * nv), dtype=complex)
                if singlet:
                    # (a k_a, i k_i | b k_b, j k_j) -> axes (a, i, b, j)
                    v = np.asarray(to_host(mo_eri(
                        df, (cv_a, co_i, cv_b, co_j), (ka, ki, kb, kj))))
                    blk += 2.0 * v.transpose(1, 0, 3, 2).reshape(
                        no * nv, no * nv)
                if op.hyb != 0.0:
                    # (a k_a, j k_j | b k_b, i k_i) -> axes (a, j, b, i)
                    v = np.asarray(to_host(mo_eri(
                        df, (cv_a, co_j, cv_b, co_i), (ka, kj, kb, ki))))
                    blk -= op.hyb * v.transpose(3, 0, 1, 2).reshape(
                        no * nv, no * nv)
                if op.hyb_sr != 0.0:
                    # screened-hybrid SR exchange block: same quadruple
                    # through the erfc-screened metric
                    v = np.asarray(to_host(mo_eri(
                        df, (cv_a, co_j, cv_b, co_i), (ka, kj, kb, ki),
                        wq=op.wq_sr)))
                    blk -= op.hyb_sr * v.transpose(3, 0, 1, 2).reshape(
                        no * nv, no * nv)
                r0, c0 = idx(ki, 0, 0), idx(kj, 0, 0)
                b[r0:r0 + no * nv, c0:c0 + no * nv] += blk / nk
    if op.spec is not None:
        # xc block by columns: ket pair (j -> b at k_j - q) transition
        # densities against the bra pairs, same Hessian-vector product
        e = np.zeros((nk, no, nv), dtype=complex)
        for kj in range(nk):
            for j in range(no):
                for bb in range(nv):
                    e[kj, j, bb] = 1.0
                    col = to_host(_xc_piece(
                        op.psio, op.psiva, opm.psio, opm.psiva,
                        op.rho0, op.gv, to_device(e, dtype=op._cdt),
                        op.spec, op.fmesh, op.weight, singlet, nk))
                    b[:, idx(kj, j, bb)] += np.asarray(col).ravel()
                    e[kj, j, bb] = 0.0
    return b
