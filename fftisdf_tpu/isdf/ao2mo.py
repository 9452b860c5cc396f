"""AO -> MO / embedding-space ERI transforms from the ISDF factorization.

Completes the capability the reference sketched but never finished (the
commented-out ``trans_2e``, ``/root/reference/fftisdf.py:230-294``, libdmet
style): with the ISDF state (x_k, w_q), any orbital-basis ERI is three small
matmuls away, because the AO indices only enter through
x_{k,I,m} -> xmo_{k,I,i} = sum_m x_{k,I,m} C_{k,m,i}.
"""
from __future__ import annotations

import numpy as np
import jax

from fftisdf_tpu.isdf.eri import assemble_eri
from fftisdf_tpu.utils.device import to_device, jit_take

_proj = jax.jit(lambda x, c: x @ c)


def mo_eri(df, mo_coeffs, kidx, wq=None):
    """MO ERI for one momentum-conserving quadruple.

    mo_coeffs: (C1, C2, C3, C4), each (nao, nmo_i) for the k-points of
    kidx = (k1, k2, k3, k4).  Returns (n1, n2, n3, n4):
    (i k1, j k2 | k k3, l k4) = sum_IJ w^q_IJ conj(xmo1_Ii) xmo2_Ij
                                             conj(xmo3_Jk) xmo4_Jl.

    ``wq``: alternative metric tensor (nk, nip, nip) over the same
    interpolation basis — e.g. df.get_wq_omega(...) for screened (SR/LR)
    integrals.  Defaults to the bare-Coulomb df.wq.
    """
    k1, k2, k3, k4 = kidx
    q = df.kconserv2()[k1, k2]
    assert df.kconserv3()[k1, k2, k3] == k4, "quadruple not conserving"
    xs = [_proj(jit_take(df.x_k, k), to_device(c, dtype=df.x_k.dtype))
          for k, c in zip(kidx, mo_coeffs)]
    return assemble_eri(jit_take(df.wq if wq is None else wq, int(q)), *xs)


def trans_2e(df, c_ao_lo=None):
    """Embedding-space (supercell-local-orbital) ERI tensor.

    c_ao_lo: (nk, nao, nemb) k-resolved AO->local-orbital coefficients
    (identity per k if None, i.e. k2gamma AO transformation — ref
    ``fftisdf.py:246-250``).  Returns the real (nemb, nemb, nemb, nemb)
    supercell ERI of the R=0 local orbitals:

      eri[ijkl] = (1/nk) sum_{k1 k2 k3} assemble(w^{q}, xlo...)  (k4 fixed by
      momentum conservation)

    normalized so that for nk=1 it reduces to the plain MO ERI.
    """
    nk = df.nkpt
    nao = df.x_k.shape[2]
    if c_ao_lo is None:
        c_ao_lo = np.broadcast_to(np.eye(nao), (nk, nao, nao))
    c = to_device(np.asarray(c_ao_lo).astype(complex))
    nemb = c.shape[2]
    k3c = df.kconserv3()
    xlo = [_proj(jit_take(df.x_k, k), jit_take(c, k).astype(df.x_k.dtype))
           for k in range(nk)]
    terms = []
    for k1 in range(nk):
        for k2 in range(nk):
            q = df.kconserv2()[k1, k2]
            for k3 in range(nk):
                k4 = int(k3c[k1, k2, k3])
                terms.append(assemble_eri(jit_take(df.wq, int(q)),
                                          xlo[k1], xlo[k2],
                                          xlo[k3], xlo[k4]))
    # accumulate under jit: one fused sum instead of nk^2 eager adds
    return jax.jit(lambda ts: sum(ts[1:], ts[0]) / nk)(terms)
