"""ISDF-compact 3-index Cholesky factors ("cderi", the GDF analog).

The reference's benchmark harness times a PySCF GDF arm — build + J/K from
a COMPACT auxiliary basis (naux ~ 3-10x nao) — as its third column
(``/root/reference/fftisdf.py:446-457``).  This module fills that column
with in-repo machinery (round-3 verdict item #5): the built ISDF state
(x_k, w_q) already IS a compact quadratic form, so the hermitized metric's
PSD square root

    w_q ~= cd_q^H cd_q,   cd_q[P, I] = sqrt(s_P) conj(U[I, P])
    (w_h = U diag(s) U^H, s clipped at 0)

turns every ERI into the GDF pairing convention with naux = nip
auxiliaries (vs ngrid for the exact plane-wave factor — an ~ngrid/nip
compression of the auxiliary dimension):

    eri((k1 k2)|(k3 k4)) = sum_P A_{k1k2}[P, mn] conj(A_{k4k3}[P, sl])
    A_{k1k2}[P, mn] = sum_I conj(cd_q[P, I]) conj(x_{k1,I,m}) x_{k2,I,n},
    q = k2 - k1 (mod G).

J/K here run the GDF algorithm — per-(k1,k2) half-transforms of the
3-index factor — NOT the ISDF image-space serve: on the device there is no disk
worth spilling the (nk^2, naux, nao^2) tensor to (PySCF streams it from
HDF5), so ``A`` is regenerated on the fly per k1 row and consumed
immediately; the timing is what a disk-free GDF serve costs, which is the
honest third column next to the exact plane-wave and ISDF arms.

Derivation notes: B_{34} = cd_q @ t34 equals conj(A_{43}) transposed in
(l, s) because conj(t34[J, kl]) = t43[J, lk] — the same bra-side identity
the plane-wave oracle uses (isdf/thc.py pw_cderi docstring).  Verified
against ``FFTISDF.get_eri`` and ``get_jk`` in tests/test_cderi.py.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@jax.jit
def wq_to_cd(wq):
    """PSD square-root factors cd (nk, nip, nip): w_h[q] ~= cd_q^H cd_q.

    The metric is hermitized first (w_q is built unsymmetrized — the even-
    mesh skew part is shared with the plane-wave oracle, isdf.kpoint) and
    negative eigenvalues (fit noise) are clipped: the clip is what makes
    the Cholesky form exist, and its size is bounded by the fitting-solve
    floor the c0 sweep measures.  In the f32 regime the clipped mass is
    NOT negligible (round-4: vk error 10x the ISDF serve's at identical
    naux) — prefer :func:`wq_to_cd_signed`, which keeps it."""
    w_h = 0.5 * (wq + jnp.conj(jnp.swapaxes(wq, -1, -2)))
    s, u = jnp.linalg.eigh(w_h)
    root = jnp.sqrt(jnp.maximum(s, 0.0)).astype(wq.dtype)
    # cd[P, I] = sqrt(s_P) conj(u[I, P])
    return root[:, :, None] * jnp.conj(jnp.swapaxes(u, -1, -2))


@jax.jit
def wq_to_cd_signed(wq):
    """SIGNED square-root factors: w_h[q] = cd_q^H diag(sign_q) cd_q
    exactly (up to eigh roundoff), with cd = sqrt(|s|) U^H and
    sign = sign(s).

    The fitting metric is indefinite at the fit-noise level (ridge solve
    floor; in f32 the negative tail carries ~1e-3 of the spectrum), and
    the ISDF image-space serve uses that metric verbatim — clipping it
    (the plain PSD root above) is where the round-4 cderi arm lost 10x
    accuracy vs the ISDF serve.  A diagonal sign costs one elementwise
    multiply per contraction and restores exactness: the GDF pairing
    becomes sum_P sign_P A12[P] conj(A43[P]) — structurally identical to
    PySCF GDF's j2c-sqrt serve, which handles the same indefiniteness
    with its j2c eigendecomposition."""
    w_h = 0.5 * (wq + jnp.conj(jnp.swapaxes(wq, -1, -2)))
    s, u = jnp.linalg.eigh(w_h)
    root = jnp.sqrt(jnp.abs(s)).astype(wq.dtype)
    cd = root[:, :, None] * jnp.conj(jnp.swapaxes(u, -1, -2))
    return cd, jnp.sign(s).astype(jnp.real(wq).dtype)


@jax.jit
def pair_cderi(cd_q, x1, x2):
    """A_{k1k2} (naux, n1, n2) for one k-pair: the GDF 3-index factor."""
    nip = x1.shape[0]
    t12 = (x1.conj()[:, :, None] * x2[:, None, :]).reshape(nip, -1)
    a = cd_q.conj() @ t12
    return a.reshape(cd_q.shape[0], x1.shape[1], x2.shape[1])


@jax.jit
def assemble_eri_cderi(cd_q, x1, x2, x3, x4, sign_q=None):
    """ERI via the GDF pairing: sum_P sign_P A12[P,mn] conj(A43[P,sl])
    (sign_q=None: the PSD-clipped convention)."""
    a12 = pair_cderi(cd_q, x1, x2)
    a43 = pair_cderi(cd_q, x4, x3)
    if sign_q is not None:
        a12 = a12 * sign_q[:, None, None].astype(a12.dtype)
    return jnp.einsum("Pmn,Psl->mnls", a12, jnp.conj(a43))


@partial(jax.jit, static_argnames=("k2_chunk",))
def get_jk_cderi(x_k, cd, q_of, dm, k2_chunk=None, sign=None):
    """J/K from the compact factors, GDF-style (one density).

    x_k (nk, nip, nao); cd (nk, naux, nip) per-sector factors;
    q_of (nk, nk) int: q_of[k1, k2] = index of k2 - k1; dm (nk, nao, nao);
    ``sign`` (nk, naux) from :func:`wq_to_cd_signed` (None: PSD-clipped).

    J uses only the q=0 factor (aux-space two-step: the GDF J algorithm);
    K loops k1 rows, regenerating the (nk2, naux, nao, nao) slab on the
    fly and contracting the two half-transforms immediately.  ``k2_chunk``
    bounds the slab (HBM) for large nao."""
    nk, nip, nao = x_k.shape
    naux = cd.shape[1]
    k2_chunk = k2_chunk or nk
    assert nk % k2_chunk == 0, "k2_chunk must divide nk (static scan grid)"

    # ---- J: rho_I = (1/nk) sum_k (x dm x^H)_II ; two aux-space gemms
    rho = jnp.einsum("kIm,kIn,kmn->I", x_k, x_k.conj(), dm) / nk
    vaux = cd[0] @ rho                      # (naux,)
    if sign is not None:
        vaux = vaux * sign[0].astype(vaux.dtype)
    v = cd[0].conj().T @ vaux               # (nip,)
    vj = jnp.einsum("kIm,kIn,I->kmn", x_k.conj(), x_k, v)

    # ---- K: vk[k1]_{ms} = (1/nk) sum_{k2,P,l} s_P G[P,m,l] conj(A[P,s,l]),
    #         G = A @ dm[k2]
    def k1_row(k1):
        x1 = x_k[k1]

        def k2_blk(c, k2s):
            cdq = cd[q_of[k1]][k2s]         # (nc, naux, nip)
            x2 = x_k[k2s]
            t12 = jnp.einsum("Im,cIn->cImn", x1.conj(), x2).reshape(
                -1, nip, nao * nao)
            a = jnp.einsum("cPI,cIx->cPx", cdq.conj(), t12).reshape(
                -1, naux, nao, nao)
            g = jnp.einsum("cPmn,cnl->cPml", a, dm[k2s])
            if sign is not None:
                g = g * sign[q_of[k1]][k2s][:, :, None, None].astype(
                    g.dtype)
            return c + jnp.einsum("cPml,cPsl->ms", g, jnp.conj(a)), None

        ks = jnp.arange(nk).reshape(-1, k2_chunk)
        acc0 = jnp.zeros((nao, nao), dtype=x_k.dtype)
        acc, _ = jax.lax.scan(k2_blk, acc0, ks)
        return acc / nk

    vk = jax.lax.map(k1_row, jnp.arange(nk))
    return vj, vk


def q_index_table(cell, kpts):
    """q_of[k1, k2] = sector index of k2 - k1 (host, once)."""
    from fftisdf_tpu.lattice import kpoints as kpt_mod

    s = cell.get_scaled_kpts(np.asarray(kpts))
    nk = len(s)
    q_of = np.empty((nk, nk), dtype=np.int32)
    for k1 in range(nk):
        for k2 in range(nk):
            q_of[k1, k2] = kpt_mod.member(s[k2] - s[k1], s, strict=False)
    assert (q_of >= 0).all(), "k-mesh not closed under differences"
    return q_of
