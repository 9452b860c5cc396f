"""DFT+U (Dudarev rotationally-invariant scheme) for the KS drivers.

Capability beyond the reference (HF-only): the production method for the
north-star NiO-AFM system (BASELINE.md) is DFT+U on the Ni d shell — pure
(semi)local functionals underestimate the on-site repulsion that opens the
charge-transfer gap and stabilizes the AFM order.

Scheme (Dudarev et al., PRB 57, 1505 (1998)): per selected (atom, l) site
and spin channel,

    E_U = sum_{I,sigma} U_I/2 * [ Tr n_I^sigma - Tr (n_I^sigma)^2 ]

with the on-site occupation matrix in the Loewdin-orthonormalized AO
projector subspace:

    n_I,ij^sigma = (1/nk) sum_k [ S_k^1/2 D_k^sigma S_k^1/2 ]_{I_i, I_j}

Projector convention: the FIRST contracted radial of each m channel of the
first l-shell on the atom ("first-radial AO projector", the analog of the
atomic-orbital projectors of plane-wave codes).  Explicit AO index lists
can be passed instead.

Fock contribution (derived for the energy pairing used throughout scf.hf:
E contributions are einsum("kmn,knm->", dm, V)/nk):

    V_k^sigma = S_k^1/2 P^T [ U/2 (1 - 2 n^sigma) ] P S_k^1/2

restricted drivers (total-density dm, factor-2 occupations) use
n^sigma = n_total/2, which gives V = S^1/2 P^T [U/2 (1 - n_total)] P S^1/2.
Both the energy and the potential are FD-cross-gated in tests/test_hubbard.py.

U is in Hartree (the rest of the package is atomic units); literature
values quoted in eV divide by 27.2114.
"""
from __future__ import annotations

import numpy as np


def projector_indices(cell, ia, l):
    """AO indices of the first-radial projector functions of the first
    l-shell on atom ``ia`` (one AO per m channel, 2l+1 total).

    AO layout (basis.eval): shells in cell.shells() order; within a shell
    the (2l+1, nctr) block is m-major, contracted-radial-minor."""
    off = 0
    for ja, sym, _xyz, sh in cell.shells():
        if ja == ia and sh.l == l:
            return np.asarray([off + m * sh.nctr for m in range(2 * l + 1)])
        off += sh.nfunc
    raise ValueError(f"atom {ia} has no l={l} shell")


def shalf_kpts(s1e):
    """Hermitian S_k^1/2 per k-point (host, f64)."""
    s1e = np.asarray(s1e)
    out = np.empty_like(s1e)
    for k in range(s1e.shape[0]):
        se, sv = np.linalg.eigh(s1e[k])
        out[k] = (sv * np.sqrt(np.maximum(se, 0.0))) @ sv.conj().T
    return out


def build_sites(cell, hubbard):
    """Normalize the ``hubbard`` spec to [(idx array, U), ...].

    ``hubbard``: {atom_index: (l, U)} with the first-radial projector, or
    {atom_index: (indices, U)} with an explicit AO index list."""
    sites = []
    for ia, (sel, u) in sorted(hubbard.items()):
        idx = (projector_indices(cell, ia, int(sel))
               if np.isscalar(sel) else np.asarray(sel, dtype=int))
        sites.append((idx, float(u)))
    return sites


def occupation_matrices(dm, shalf, sites):
    """Per-site on-site occupation matrices.

    dm: (nspin, nk, nao, nao) SPIN-RESOLVED density matrices (restricted
    callers pass dm_total/2 per channel); shalf: (nk, nao, nao).
    Returns [n (nspin, p, p) hermitian, ...] aligned with ``sites``."""
    dm = np.asarray(dm)
    nspin, nk = dm.shape[:2]
    sd = np.einsum("kmp,skpq,kqn->skmn", shalf, dm, shalf)
    sd = sd.mean(axis=1)                          # (nspin, nao, nao), 1/nk
    out = []
    for idx, _u in sites:
        n = sd[:, idx[:, None], idx[None, :]]
        out.append(0.5 * (n + np.conj(np.swapaxes(n, -1, -2))))
    return out


def eu_and_vu(dm, shalf, sites):
    """(E_U, V_U, g) for spin-resolved dm (nspin, nk, nao, nao).

    V_U pairs with dm in the package energy convention:
    dE_U = einsum("skmn,sknm->", d dm, V_U) / nk.  ``g`` is the potential
    in the Loewdin frame (nspin, nao, nao): V at any k-point set — e.g.
    band paths — is S_k^1/2 g S_k^1/2 (see ``vu_from_g``)."""
    dm = np.asarray(dm)
    nspin, nk, nao = dm.shape[:3]
    occ = occupation_matrices(dm, shalf, sites)
    e_u = 0.0
    g = np.zeros((nspin, nao, nao), dtype=dm.dtype)
    for (idx, u), n in zip(sites, occ):
        for s in range(nspin):
            ns = n[s]
            e_u += 0.5 * u * np.real(np.trace(ns) - np.trace(ns @ ns))
            g[s][idx[:, None], idx[None, :]] += \
                0.5 * u * (np.eye(len(idx)) - 2.0 * ns)
    return float(e_u), vu_from_g(shalf, g), g


def vu_from_g(shalf, g):
    """V_U (nspin, nk, nao, nao) from the Loewdin-frame potential g."""
    return np.einsum("kmp,spq,kqn->skmn", shalf, g, shalf)


def sqrtm_traced(s, iters=24):
    """Differentiation-safe hermitian-PSD matrix square root (batched).

    Denman-Beavers iteration (Y -> S^1/2, Z -> S^-1/2) with trace scaling:
    smooth in S everywhere, so reverse-mode gradients are well-defined even
    when S has DEGENERATE eigenvalues — the eigh-based Loewdin construction
    (shalf_kpts) is fine for values but its autodiff divides by eigenvalue
    gaps and NaNs on the symmetry-degenerate overlap spectra of periodic
    cells.  Used by the force/stress Lagrangians (scf.grad) for the +U
    term's S(R)^1/2 dependence."""
    import jax.numpy as jnp

    n = s.shape[-1]
    scale = jnp.trace(s, axis1=-2, axis2=-1).real / n
    y = s / scale[..., None, None].astype(s.dtype)
    z = jnp.broadcast_to(jnp.eye(n, dtype=s.dtype), s.shape)
    for _ in range(iters):
        zi = jnp.linalg.inv(z)
        yi = jnp.linalg.inv(y)
        y, z = 0.5 * (y + zi), 0.5 * (z + yi)
    return y * jnp.sqrt(scale)[..., None, None].astype(s.dtype)


def eu_and_vu_traced(dm, shalf, sites):
    """Traced (jax.numpy) analog of :func:`eu_and_vu` for the
    device-resident SCF loop (scf.device): same math, same energy pairing,
    gated bit-for-bit against the host version in tests/test_hubbard.py.

    ``dm`` (nspin, nk, nao, nao) and ``shalf`` (nk, nao, nao) are device
    arrays; ``sites`` is the static [(idx, U), ...] list from
    :func:`build_sites` (the small integer index constants embed in the
    trace)."""
    import jax.numpy as jnp

    nspin, nk, nao = dm.shape[:3]
    sd = jnp.einsum("kmp,skpq,kqn->skmn", shalf, dm, shalf).mean(axis=1)
    e_u = jnp.zeros((), dm.real.dtype)
    g = jnp.zeros((nspin, nao, nao), dm.dtype)
    for idx, u in sites:
        n = sd[:, idx[:, None], idx[None, :]]
        n = 0.5 * (n + jnp.conj(jnp.swapaxes(n, -1, -2)))
        eye = jnp.eye(len(idx), dtype=dm.dtype)
        for s in range(nspin):
            ns = n[s]
            e_u = e_u + 0.5 * u * jnp.real(
                jnp.trace(ns) - jnp.trace(ns @ ns))
            g = g.at[s, idx[:, None], idx[None, :]].add(
                0.5 * u * (eye - 2.0 * ns))
    vu = jnp.einsum("kmp,spq,kqn->skmn", shalf, g, shalf)
    return e_u, vu
