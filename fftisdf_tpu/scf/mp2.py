"""k-point MP2 on top of the ISDF ERI factorization.

A correlated-method consumer of the (x_k, w_q) state — the kind of
downstream use the reference sketched with its embedding transform
(``/root/reference/fftisdf.py:230-294``) but never finished.  Restricted,
insulating occupations.

    E2 = (1/nk) sum_{k_i k_j k_a} sum_{ijab}
         t * (2 conj(v_ijab) - conj(v_ijba')) ...

with v_{ijab} = (i k_i, a k_a | j k_j, b k_b), k_b fixed by momentum
conservation, and denominators from the converged KRHF orbital energies.
ERIs come straight from ``assemble_eri`` over MO-projected interpolation
vectors, so the cost per k-triple is three small matmuls.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.isdf.eri import assemble_eri
from fftisdf_tpu.utils.device import to_device, jit_take, to_host


def kmp2(df, mf):
    """MP2 correlation energy per cell from a converged KRHF `mf`.

    df: built FFTISDF; mf: KRHF with mo_coeff/mo_energy/mo_occ set.
    Returns (e_mp2, detail dict)."""
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)      # (nk, nao, nmo)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    nocc = int(round(mo_o[0].sum() / 2))
    k3c = df.kconserv3()
    k2c = df.kconserv2()

    # MO-projected interpolation vectors, occ and virt blocks
    xo, xv = [], []
    for k in range(nk):
        x = jit_take(df.x_k, k)
        c = to_device(mo_c[k], dtype=df.x_k.dtype)
        xo.append(jax.jit(lambda x, c: x @ c)(x, c[:, :nocc]))
        xv.append(jax.jit(lambda x, c: x @ c)(x, c[:, nocc:]))
    eo = [mo_e[k][:nocc] for k in range(nk)]
    ev = [mo_e[k][nocc:] for k in range(nk)]

    @jax.jit
    def pair_energy(v_iajb, v_ibja, d):
        # v_iajb[i,a,j,b]; antisymmetrized closed-shell MP2
        t = v_iajb / d
        return jnp.sum(t * (2.0 * v_iajb.conj() - v_ibja.conj()))

    e2 = 0.0
    for ki in range(nk):
        for ka in range(nk):
            q = k2c[ki, ka]  # sector of pair (i k_i, a k_a)
            for kj in range(nk):
                kb = int(k3c[ki, ka, kj])
                # (i k_i a k_a | j k_j b k_b)
                v_iajb = assemble_eri(jit_take(df.wq, int(q)),
                                      xo[ki], xv[ka], xo[kj], xv[kb])
                qb = k2c[ki, kb]
                v_ibja = assemble_eri(jit_take(df.wq, int(qb)),
                                      xo[ki], xv[kb], xo[kj], xv[ka])
                # denominators e_i + e_j - e_a - e_b
                d = (eo[ki][:, None, None, None]
                     - ev[ka][None, :, None, None]
                     + eo[kj][None, None, :, None]
                     - ev[kb][None, None, None, :])
                # v_ibja has axes (i, b, j, a) -> align to (i, a, j, b)
                contrib = pair_energy(
                    v_iajb, jnp.transpose(v_ibja, (0, 3, 2, 1)),
                    to_device(d, dtype=jnp.float64
                              if df.x_k.dtype == jnp.complex128
                              else jnp.float32))
                e2 += complex(to_host(contrib))
    # per-cell normalization: supercell orbitals are Bloch/sqrt(nk), so each
    # cell-integrated v carries 1/nk vs the supercell ERI and the triple
    # k-sum contributes nk^3 terms -> overall 1/nk^3 per cell (verified by
    # the k-mesh vs doubled-supercell consistency test)
    e2 = e2 / nk ** 3
    return float(np.real(e2)), {"imag": float(np.imag(e2)), "nocc": nocc}


def kump2(df, mf):
    """Unrestricted k-point MP2 from a converged KUHF/KUKS ``mf`` — the
    correlated method for the spin-polarized north-star system (NiO-AFM).

    Spin-resolved spatial-orbital decomposition (insulating occupations):

        E2 = E_ss(alpha) + E_ss(beta) + E_os
        E_ss^s = (1/2) sum t (v_iajb - v_ibja)^*,  t = v_iajb / D
        E_os   =       sum t v_iajb^*   (i,a alpha; j,b beta — each
                                         opposite-spin pair counted once)

    with the same ISDF ERI assembly and 1/nk^3 per-cell normalization as
    :func:`kmp2`; reduces exactly to it for closed shells (gated in
    tests/test_mp2.py)."""
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)      # (2, nk, nao, nmo)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    assert mo_c.ndim == 4, "kump2 needs a spin-resolved (KUHF/KUKS) mf"
    noccs = [int(round(mo_o[s][0].sum())) for s in range(2)]

    xo = [[], []]
    xv = [[], []]
    eo = [[], []]
    ev = [[], []]
    for s in range(2):
        no = noccs[s]
        for k in range(nk):
            x = jit_take(df.x_k, k)
            c = to_device(mo_c[s, k], dtype=df.x_k.dtype)
            xo[s].append(jax.jit(lambda x, c: x @ c)(x, c[:, :no]))
            xv[s].append(jax.jit(lambda x, c: x @ c)(x, c[:, no:]))
            eo[s].append(mo_e[s, k][:no])
            ev[s].append(mo_e[s, k][no:])

    rdt = (jnp.float64 if df.x_k.dtype == jnp.complex128 else jnp.float32)
    k3c = df.kconserv3()
    k2c = df.kconserv2()

    @jax.jit
    def pair_ss(v_iajb, v_ibja, d):
        t = v_iajb / d
        return 0.5 * jnp.sum(t * (v_iajb.conj() - v_ibja.conj()))

    @jax.jit
    def pair_os(v_iajb, d):
        return jnp.sum((v_iajb / d) * v_iajb.conj())

    e2 = 0.0
    for s1, s2 in ((0, 0), (1, 1), (0, 1)):
        same = s1 == s2
        for ki in range(nk):
            for ka in range(nk):
                q = k2c[ki, ka]
                for kj in range(nk):
                    kb = int(k3c[ki, ka, kj])
                    v_iajb = assemble_eri(jit_take(df.wq, int(q)),
                                          xo[s1][ki], xv[s1][ka],
                                          xo[s2][kj], xv[s2][kb])
                    d = (eo[s1][ki][:, None, None, None]
                         - ev[s1][ka][None, :, None, None]
                         + eo[s2][kj][None, None, :, None]
                         - ev[s2][kb][None, None, None, :])
                    d = to_device(d, dtype=rdt)
                    if same:
                        qb = k2c[ki, kb]
                        v_ibja = assemble_eri(jit_take(df.wq, int(qb)),
                                              xo[s1][ki], xv[s1][kb],
                                              xo[s1][kj], xv[s1][ka])
                        contrib = pair_ss(
                            v_iajb, jnp.transpose(v_ibja, (0, 3, 2, 1)), d)
                    else:
                        contrib = pair_os(v_iajb, d)
                    e2 += complex(to_host(contrib))
    e2 = e2 / nk ** 3
    return float(np.real(e2)), {"imag": float(np.imag(e2)),
                                "nocc": tuple(noccs)}
