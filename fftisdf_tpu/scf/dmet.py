"""Density-matrix embedding (DMET) on the ISDF factorization.

One-shot DMET with an interacting bath, for k-point KRHF references —
the quantum-embedding capability the reference repository pointed at
with its never-finished libdmet-style embedding transform
(``/root/reference/fftisdf.py:230-294``): `isdf.ao2mo.trans_2e`
completes the transform, and this module uses it end-to-end.

Construction (standard DMET, all host-side f64 — the heavy work is the
embedding-ERI assembly, which runs on device through the ISDF factors):

1. Loewdin-orthogonalize per k; the supercell mean-field 1-RDM's
   fragment rows  D[(0, f), (R, nu)]  are assembled from the k-resolved
   RDM with the image<->k phase matrix.
2. Bath = right singular vectors of the fragment-environment block
   (<= n_frag vectors); embedding basis = fragment ⊕ bath, carried as
   k-resolved AO coefficients.
3. Embedding ERIs from `trans_2e` (three matmuls per momentum
   triple); embedding one-body = projected converged Fock minus the
   embedding-internal mean field (interacting-bath standard), so the
   mean-field density is stationary inside the embedding.
4. Impurity solver: `scf.fci.fci_ground` (exact diagonalization).
5. Energy: correlation-energy functional with democratic fragment
   partitioning of the *difference* RDMs,

     E = E_HF + sum_f w_f [ h_emb (gamma - gamma_mf)
                            + 1/2 eri_emb (Gamma - Gamma_mf) ]

   which is exactly E_HF when the solver returns the mean field, and
   exactly E_FCI in the full-fragment gamma-point limit (both gated in
   tests/test_dmet.py, the latter cross-checked against CCSD which is
   exact for the 2-electron fixture).
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu.lattice import kpoints as kpt_mod
from fftisdf_tpu.isdf.ao2mo import trans_2e
from fftisdf_tpu.utils.device import to_host


def _s_powers(s1e):
    """Per-k S^{1/2} and S^{-1/2}."""
    sh, smh = [], []
    for s in s1e:
        w, v = np.linalg.eigh(s)
        sh.append((v * np.sqrt(w)) @ v.conj().T)
        smh.append((v / np.sqrt(w)) @ v.conj().T)
    return np.array(sh), np.array(smh)


def build_embedding(mf, frag_ao, tol=1e-7):
    """Fragment AO indices -> k-resolved embedding coefficients.

    Returns (c_ao_lo (nk, nao, nemb), gamma_mf (fci convention
    <p+ q>), nfrag, info).  The first len(frag_ao) embedding orbitals
    ARE the (Loewdin) fragment orbitals.
    """
    cell, kpts = mf.cell, mf.kpts
    nk = len(kpts)
    dm = np.asarray(mf.dm)
    s1e = np.asarray(mf.s1e)
    nao = dm.shape[1]
    frag = np.asarray(frag_ao, dtype=int)
    nfrag = len(frag)
    sh, smh = _s_powers(s1e)
    d_oao = np.einsum("kpm,kmn,knq->kpq", sh, dm, sh)

    kmesh = kpt_mod.kpts_to_kmesh(cell, kpts)
    phase = kpt_mod.get_phase(cell, kpts, kmesh)   # (nimg, nk)
    # supercell RDM fragment rows: D[(0,f),(R,nu)]
    rows = np.einsum("k,kfv,Rk->fRv", phase[0], d_oao[:, frag, :],
                     phase.conj())
    rows = rows.reshape(nfrag, nk * nao)
    env_mask = np.ones(nk * nao, dtype=bool)
    env_mask[frag] = False                         # R=0 block leads
    b = rows[:, env_mask]
    u, sv, vh = np.linalg.svd(b, full_matrices=False)
    nbath = int(np.sum(sv > tol))
    bath_env = vh[:nbath].conj()                   # (nbath, Nenv)
    bath_sc = np.zeros((nbath, nk * nao), dtype=complex)
    bath_sc[:, env_mask] = bath_env

    # k components: v_k[nu] = sum_R phase[R,k]^* v[(R,nu)]
    bath_k = np.einsum("Rk,bRv->kvb", phase.conj(),
                       bath_sc.reshape(nbath, nk, nao))
    nemb = nfrag + nbath
    c_oao = np.zeros((nk, nao, nemb), dtype=complex)
    for i, f in enumerate(frag):
        c_oao[:, f, i] = phase[0].conj()           # 1/sqrt(nk)
    c_oao[:, :, nfrag:] = bath_k
    # orthonormality over the supercell
    ortho = np.einsum("kpi,kpj->ij", c_oao.conj(), c_oao)
    assert np.max(np.abs(ortho - np.eye(nemb))) < 1e-8

    c_ao_lo = np.einsum("kpq,kqi->kpi", smh, c_oao)
    demb = np.einsum("kpi,kpq,kqj->ij", c_oao.conj(), d_oao, c_oao)
    gamma_mf = demb.T                              # <p+ q> convention
    # DMET bath exactness: the embedded mean-field RDM is idempotent
    occs = np.linalg.eigvalsh(0.5 * (demb + demb.conj().T))
    assert np.max(np.minimum(np.abs(occs), np.abs(occs - 2.0))) < 1e-5, \
        occs
    return c_ao_lo, gamma_mf, nfrag, {"nbath": nbath, "svals": sv}


def _vhf(eri, gamma):
    """Closed-shell mean field in the <p+ q> convention."""
    j = np.einsum("pqrs,rs->pq", eri, gamma)
    k = np.einsum("plrq,rl->pq", eri, gamma)
    return j - 0.5 * k


def _gamma2_mf(gamma):
    return (np.einsum("pq,rs->pqrs", gamma, gamma)
            - 0.5 * np.einsum("ps,rq->pqrs", gamma, gamma))


def dmet_energy(mf, df, frag_ao, solver=None, tol=1e-7, fit_mu=False,
                mu_tol=1e-6, mu_maxiter=20):
    """One-shot DMET total energy per cell.

    mf: converged KRHF; df: built FFTISDF on the same (cell, kpts);
    frag_ao: AO indices of the fragment within the reference cell;
    solver(h1, eri, nelec) -> (e, gamma, Gamma): defaults to scf.fci.
    ``fit_mu``: fit a global chemical potential on the fragment diagonal
    (secant iterations of the impurity solve) so the correlated fragment
    filling matches the mean-field one — the standard DMET number-
    conservation condition; the Lagrange-multiplier term is excluded
    from the energy functional.  Returns (e_dmet, info).
    """
    from fftisdf_tpu.scf.fci import fci_ground

    solver = solver or fci_ground
    c_ao_lo, gamma_mf, nfrag, info = build_embedding(mf, frag_ao,
                                                     tol=tol)
    nemb = c_ao_lo.shape[2]
    eri = np.asarray(to_host(trans_2e(df, c_ao_lo)))

    fock, _, _ = mf.get_fock(mf.dm)
    f_emb = np.einsum("kpi,kpq,kqj->ij", np.conj(c_ao_lo),
                      np.asarray(fock), c_ao_lo)
    h_solver = f_emb - _vhf(eri, gamma_mf)
    nelec = int(round(float(np.trace(gamma_mf).real)))

    def solve(mu):
        hmu = h_solver.copy()
        hmu[np.arange(nfrag), np.arange(nfrag)] -= mu
        return solver(hmu, eri, nelec)

    mu = 0.0
    e_emb, gamma, Gam = solve(mu)
    if fit_mu:
        target = float(np.trace(gamma_mf[:nfrag, :nfrag]).real)

        def nf(g):
            return float(np.trace(g[:nfrag, :nfrag]).real)

        mu0, n0 = 0.0, nf(gamma)
        if abs(n0 - target) > mu_tol:
            mu1 = 0.05 if n0 < target else -0.05
            e_emb, gamma, Gam = solve(mu1)
            n1 = nf(gamma)
            for _ in range(mu_maxiter):
                if abs(n1 - target) < mu_tol or abs(n1 - n0) < 1e-12:
                    break
                mu_new = mu1 + (target - n1) * (mu1 - mu0) / (n1 - n0)
                mu0, n0 = mu1, n1
                mu1 = float(np.clip(mu_new, mu1 - 0.5, mu1 + 0.5))
                e_emb, gamma, Gam = solve(mu1)
                n1 = nf(gamma)
            mu = mu1
            info["nfrag_err"] = abs(n1 - target)
        info["mu"] = mu
    dgam = gamma - gamma_mf
    dgam2 = Gam - _gamma2_mf(gamma_mf)

    w = np.zeros(nemb)
    w[:nfrag] = 1.0
    w1 = 0.5 * (w[:, None] + w[None, :])
    w2 = 0.25 * (w[:, None, None, None] + w[None, :, None, None]
                 + w[None, None, :, None] + w[None, None, None, :])
    de = (np.einsum("pq,pq,pq->", h_solver, dgam, w1)
          + 0.5 * np.einsum("pqrs,pqrs,pqrs->", eri, dgam2, w2))
    info.update(e_hf=mf.e_tot, de_corr=float(de.real),
                de_imag=float(de.imag), nelec_emb=nelec, nemb=nemb,
                e_emb=e_emb)
    return mf.e_tot + float(de.real), info
