"""ERI assembly from the ISDF factorization.

eri[m,n,k,l] = sum_IJ w^q_IJ conj(x1_{I,m}) x2_{I,n} conj(x3_{J,k}) x4_{J,l}
(ref ``/root/reference/fftdf-with-k.py:231``), with q = k2 - k1 (mod G).
Structured as two pair contractions around the (nip, nip) metric so the device
sees three large matmuls instead of a 5-tensor einsum.
"""
from __future__ import annotations

import jax


@jax.jit
def assemble_eri(w_q, x1, x2, x3, x4):
    """Orbital counts may differ per slot (e.g. occ/virt blocks in MP2)."""
    nip = x1.shape[0]
    n1, n2, n3, n4 = (x.shape[1] for x in (x1, x2, x3, x4))
    t12 = (x1.conj()[:, :, None] * x2[:, None, :]).reshape(nip, n1 * n2)
    t34 = (x3.conj()[:, :, None] * x4[:, None, :]).reshape(nip, n3 * n4)
    eri = t12.T @ (w_q @ t34)
    return eri.reshape(n1, n2, n3, n4)
