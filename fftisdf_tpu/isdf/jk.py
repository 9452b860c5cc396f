"""ISDF J/K builders: pure dense algebra (matrix products).

Native equivalents of ``get_j_kpts`` / ``get_k_kpts``
(``/root/reference/fftisdf.py:133-228``).  Derivation (independent of the
reference; verified against the exact plane-wave oracle in
tests/test_isdf_kpoint.py):

J:  vj[k]_{mn} = sum_I conj(x_{k,I,m}) x_{k,I,n} v_I,
    v = w_{q=0} rho,   rho_I = (1/nk) sum_k (x_k dm_k x_k^H)_{II}.

K:  the k2-sum  vk[k1] = (1/nk) sum_{k2} w^{k2-k1} (.) (x dm x^H)_{k2}
    is a convolution over the k-grid, diagonalized by the image-space DFT:
    with W[R] = sum_q phase[R,q] w_q / sqrt(nk) * nk-normalizations folded as
    in the code, V[k1] = sum_R e^{i k1 R} W[R] (.) P[R]^T, using
    P[-R] = P[R]^T for time-reversal-symmetric densities (that transpose is
    the subtle step the reference derives in fftisdf-supercell-2.py:
    "they are identical, but wrong!").
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def get_j_kpts(x_k, w0, dms):
    """vj (nset, nk, nao, nao) from dms (nset, nk, nao, nao)."""
    nk = x_k.shape[0]
    rho = jnp.einsum("kIm,kIn,xkmn->xI", x_k, x_k.conj(), dms) / nk
    v = jnp.einsum("IJ,xJ->xI", w0, rho)
    vj = jnp.einsum("kIm,kIn,xI->xkmn", x_k.conj(), x_k, v)
    return vj


@jax.jit
def add_ewald_exx(vk, s1e, dms, mad):
    """Probe-charge (exxdiv='ewald') G=0 exchange correction:
    vk[k] += madelung * S_k dm_k S_k, batched over any leading set axes."""
    return vk + mad * jnp.einsum("kmp,...kpq,kqn->...kmn", s1e, dms, s1e)


@jax.jit
def get_k_kpts(x_k, wq, phase, dms):
    """vk (nset, nk, nao, nao); phase (nimg, nk) unitary DFT matrix."""
    nk = x_k.shape[0]
    ws = jnp.einsum("Rq,qIJ->RIJ", phase, wq).real * jnp.sqrt(1.0 * nk)

    def per_dm(dm):
        rhok = jnp.einsum("kIm,kmn,kJn->kIJ", x_k, dm, x_k.conj()) / nk
        rhos = jnp.einsum("Rk,kIJ->RIJ", phase, rhok).real
        vs = ws * jnp.transpose(rhos, (0, 2, 1))
        vk_q = jnp.einsum("Rk,RIJ->kIJ", phase, vs.astype(phase.dtype))
        return jnp.einsum("kIm,kIJ,kJn->kmn", x_k.conj(), vk_q, x_k)

    return jax.vmap(per_dm)(dms)


# ---------------------------------------------------------------------
# serving-optimized K path: the image-space metric ws = Re(phase @ wq) is
# density-INdependent, so SCF drivers precompute it once per build (real:
# half the bytes of wq) and each iteration pays only the density-side
# transforms.  The k-grid enumeration is C-ordered (lattice.kpoints), so
# the (nimg, nk) phase contraction is a 3D DFT over the mesh axes.  The
# serve runs it as an O(nk^2) matmul instead of the O(nk log nk) k-axis
# FFT: jnp.fft over the LEADING axes makes XLA transpose the multi-GB
# (nk, nip, nip) tensor so the transform axes are innermost, while
# splitting the phase matrix into its cos/sin parts turns both
# transforms into four real (nk, nk) x (nk, nip^2) gemms with k
# contracted in place; the nk^2 extra flops are negligible (nk ~ 64 <<
# nip).  Which form is faster on a given device is not re-measured here.
# ---------------------------------------------------------------------

def _phase_cs(kmesh, rdtype):
    """cos/sin split of the unnormalized image DFT matrix for the
    C-ordered k-grid: C+iS = e^{+2pi i R.k_frac} / sqrt(nk), both
    (nk, nk), SYMMETRIC (R and k enumerate the same integer grid).
    Computed host-side at trace time (kmesh is static)."""
    import numpy as _np

    ii = _np.indices(tuple(kmesh)).reshape(len(kmesh), -1).T
    ang = 2.0 * _np.pi * (ii @ (ii / _np.asarray(kmesh)[None, :]).T)
    nk = ii.shape[0]
    c = _np.cos(ang) / _np.sqrt(nk)
    s = _np.sin(ang) / _np.sqrt(nk)
    return jnp.asarray(c, rdtype), jnp.asarray(s, rdtype)


def _ifftk(a_k, kmesh):
    """sum_q phase[R, q] a[q] == sqrt(nk) * ifftn over the C-ordered k axis.
    (Build-time helper; the serve hot path uses the cos/sin gemm form.)"""
    nk = a_k.shape[0]
    a = a_k.reshape(*kmesh, *a_k.shape[1:])
    out = jnp.fft.ifftn(a, axes=(0, 1, 2)) * jnp.sqrt(1.0 * nk)
    return out.reshape(nk, *a_k.shape[1:])


@partial(jax.jit, static_argnames=("kmesh",))
def wq_to_ws(wq, kmesh):
    """Image-space Coulomb metric: ws[R] = Re(phase @ wq)[R] * sqrt(nk).
    Real (nimg, nip, nip) — the K serve's per-iteration state."""
    return _ifftk(wq, kmesh).real * jnp.sqrt(1.0 * wq.shape[0])


@partial(jax.jit, static_argnames=("kmesh",))
def get_k_kpts_img(x_k, ws, dms, kmesh):
    """vk from the precomputed image-space metric (see :func:`wq_to_ws`);
    identical algebra to :func:`get_k_kpts` (gated in tests), with the two
    per-density phase contractions as real cos/sin gemms (see the
    layout note above):

        rhos   = Re((C + iS) rhok)        = C Re(rhok) - S Im(rhok)
        vk_q   = (C + iS) vs              (vs real)
    """
    nk = x_k.shape[0]
    rdtype = ws.dtype
    c, s = _phase_cs(kmesh, rdtype)

    def per_dm(dm):
        rhok = jnp.einsum("kIm,kmn,kJn->kIJ", x_k, dm, x_k.conj()) / nk
        rhos = (jnp.einsum("Rk,kIJ->RIJ", c, jnp.real(rhok))
                - jnp.einsum("Rk,kIJ->RIJ", s, jnp.imag(rhok)))
        vs = ws * jnp.transpose(rhos, (0, 2, 1))
        vk_q = jax.lax.complex(jnp.einsum("Rk,RIJ->kIJ", c, vs),
                               jnp.einsum("Rk,RIJ->kIJ", s, vs))
        return jnp.einsum("kIm,kIJ,kJn->kmn", x_k.conj(), vk_q, x_k)

    # sequential (lax.map) over the set/spin axis: vmap materializes every
    # O(nk nip^2) temp for ALL channels at once — at the production config
    # a 2-spin serve is ~12 GB of temps and the SCF step cannot compile;
    # mapped channels halve that, and the axis is tiny (1-2)
    return jax.lax.map(per_dm, dms)
