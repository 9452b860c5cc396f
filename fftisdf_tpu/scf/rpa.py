"""Direct RPA correlation energy in the ISDF interpolation basis.

The second correlated-method consumer of the (x_k, w_q) artifact (after
scf.mp2): because the ERIs factorize as ``(ia|jb) = A_q^T w_q A_q`` with
``A_{I,(k,ia)} = conj(xo_k)_{Ii} xv_{k_a}_{Ia}``, the RPA ring series
contracts to the nip x nip fitting space by the determinant identity

    det(1 - V G) = det(1 - w_q chi_q(iw)),
    chi_q(iw) = sum_p g_p(iw) A[:, p] A[:, p]^T,

so each (q, iw) sample costs one (nip, npair) x (npair, nip) matmul
and one nip x nip slogdet instead of anything in the O((nocc*nvir*nk)^2)
pair space.  Closed-shell, insulating occupations:

    E_c = (1/2pi nk) sum_q  int_0^inf dw  Re[ln det(1 - K_q(iw)) + tr K_q],
    K_q = (1/nk) w_q chi_q(iw),   g_p(iw) = -4 Delta_p / (Delta_p^2 + w^2)

(the -4 = 2 spin x 2 time orderings; the 1/nk on K and the 1/nk front
factor implement the supercell-block-diagonalization of the Bloch pair
space — both pinned by the k-mesh <-> doubled-supercell consistency gate).
Frequency integration: Gauss-Legendre on w = t/(1-t).

The reference has no correlated methods at all (its embedding transform,
``/root/reference/fftisdf.py:230-294``, is dead code).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.utils.device import to_device, to_host, jit_take


def _freq_grid(nw):
    """Gauss-Legendre nodes/weights for int_0^inf dw via w = t/(1-t)."""
    t, wt = np.polynomial.legendre.leggauss(nw)
    t = 0.5 * (t + 1.0)
    wt = 0.5 * wt
    omega = t / (1.0 - t)
    weight = wt / (1.0 - t) ** 2
    return omega, weight


@jax.jit
def _rpa_q(pair_amp, delta, wq, omega, weight, inv_nk):
    """Frequency-integrated ring energy of one momentum sector.

    pair_amp: (nip, npair) complex; delta: (npair,) positive; wq: (nip, nip).
    Returns sum_w weight * Re[ln det(1 - K) + tr K], K = inv_nk * wq @ chi.
    """
    eye = jnp.eye(wq.shape[0], dtype=wq.dtype)

    def one_freq(args):
        om, wt = args
        g = -4.0 * delta / (delta * delta + om * om)
        chi = (pair_amp * g[None, :].astype(pair_amp.dtype)) @ pair_amp.T
        k_mat = inv_nk * (wq @ chi)
        sign, logdet = jnp.linalg.slogdet(eye - k_mat)
        val = (logdet + jnp.log(sign)) + jnp.trace(k_mat)
        return wt * jnp.real(val)

    return jnp.sum(jax.lax.map(one_freq, (omega, weight)))


def drpa(df, mf, nw=24):
    """dRPA correlation energy per cell from a converged KRHF.

    df: built FFTISDF; mf: KRHF with mo_coeff/mo_energy/mo_occ.
    Returns (e_c, detail dict)."""
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    nocc = int(round(mo_o[0].sum() / 2))
    assert nocc > 0 and nocc < mo_c.shape[-1], "need occupied and virtuals"
    k2c = df.kconserv2()

    xo, xv = [], []
    for k in range(nk):
        x = jit_take(df.x_k, k)
        c = to_device(mo_c[k], dtype=df.x_k.dtype)
        xo.append(jax.jit(lambda x, c: x @ c)(x, c[:, :nocc]))
        xv.append(jax.jit(lambda x, c: x @ c)(x, c[:, nocc:]))

    omega, weight = _freq_grid(nw)
    rdt = jnp.float64 if df.x_k.dtype == jnp.complex128 else jnp.float32
    om_d = jnp.asarray(omega, dtype=rdt)
    wt_d = jnp.asarray(weight, dtype=rdt)

    @jax.jit
    def pair_block(xo_k, xv_k):
        # A_{I,(ia)} = conj(xo)_{Ii} xv_{Ia}
        return jnp.einsum("Ii,Ia->Iia", xo_k.conj(), xv_k).reshape(
            xo_k.shape[0], -1)

    e_c = 0.0
    for q in range(nk):
        blocks, deltas = [], []
        for ki in range(nk):
            ka = int(np.nonzero(k2c[ki] == q)[0][0])
            blocks.append(pair_block(xo[ki], xv[ka]))
            deltas.append((mo_e[ka][nocc:][None, :]
                           - mo_e[ki][:nocc][:, None]).ravel())
        pair_amp = jnp.concatenate(blocks, axis=1)
        delta = to_device(np.concatenate(deltas), dtype=rdt)
        e_q = _rpa_q(pair_amp, delta, jit_take(df.wq, q), om_d, wt_d,
                     jnp.asarray(1.0 / nk, dtype=rdt))
        e_c += float(to_host(e_q))
    e_c /= 2.0 * np.pi * nk
    return e_c, {"nw": nw, "nocc": nocc, "nk": nk}


def drpa_ov_space(v_iajb, eps_o, eps_v, nw=24):
    """Oracle: dRPA from explicit (ia|jb) integrals in the full ov pair
    space (gamma point / single sector) — algebraically identical to the
    nip-space contraction; used by tests to pin the trace identities."""
    no, nv = len(eps_o), len(eps_v)
    nov = no * nv
    v = np.asarray(v_iajb).reshape(nov, nov)
    delta = (np.asarray(eps_v)[None, :]
             - np.asarray(eps_o)[:, None]).ravel()
    omega, weight = _freq_grid(nw)
    e_c = 0.0
    eye = np.eye(nov)
    for om, wt in zip(omega, weight):
        g = -4.0 * delta / (delta * delta + om * om)
        k_mat = v * g[None, :]
        sign, logdet = np.linalg.slogdet(eye - k_mat)
        val = logdet + np.log(sign) + np.trace(k_mat)
        e_c += wt * np.real(val)
    return e_c / (2.0 * np.pi)
