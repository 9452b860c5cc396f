"""Exact plane-wave J/K builders (FFTDF-equivalent oracle).

In-repo equivalent of PySCF ``FFTDF.get_jk`` at k-points — the slow exact
method the reference benchmarks ISDF against (``/root/reference/
fftisdf.py:442-443``: "FFTDF JK" timing, and the vj/vk error prints at
``:468-473``).  Cost O(nk^2 nao^2 ng log ng) per K build; serves as the
accuracy oracle in tests and the baseline side of bench.py.

Density-matrix convention: dm[k]_{mn} with electron density
    n(r) = (1/nk) sum_k sum_{mn} dm[k]_{mn} phi_{k,m}(r) conj(phi_{k,n}(r)).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.linalg.fft import fft3, ifft3
from fftisdf_tpu.linalg.coulomb import get_coulG, _coulG_vec, check_trunc


# auto row_block: HBM budget of one bra-row block's pair-density + FFT
# temps in the exchange sweep (docstring and code share this one number)
_ROW_BLOCK_BUDGET_B = 2.0e9


def get_j_kpts(cell, dm_kpts, ao_kpts, mesh=None, ao_band=None, omega=0.0,
               trunc=None):
    """Hartree matrix vj[k] from AO values ao_kpts (nk, ng, nao).

    ``ao_band`` (nb, ng, nao): integrate the Hartree potential of the mesh
    density against band-kpoint AOs instead (returns (nb, nao, nao)); the
    potential itself is k-independent, so bands need no new Poisson solve.

    ``omega``: range-separated kernel (erf for omega>0, erfc for omega<0;
    linalg.coulomb convention) — the exact oracle for the ISDF omega path.

    ``trunc``: real-space Coulomb truncation ("0d"/"2d" spec; linalg.coulomb
    convention) — the exact oracle for low-dimensional systems."""
    mesh = cell.mesh if mesh is None else mesh
    fmesh = tuple(int(m) for m in mesh)
    nk, ng, nao = ao_kpts.shape
    dm = jnp.asarray(dm_kpts)
    # no np round-trip: this is traced when a caller (e.g. scf.grad) wraps
    # the whole energy in one jit
    coulG = jnp.asarray(get_coulG(cell, mesh=mesh, omega=omega, trunc=trunc),
                        dtype=jnp.real(ao_kpts).dtype)
    w = cell.vol / ng
    ao_out = ao_kpts if ao_band is None else ao_band

    @jax.jit
    def _j(dm, ao_kpts, ao_out, coulG):
        n_g = jnp.einsum("kgm,kmn,kgn->g", ao_kpts, dm, ao_kpts.conj()) / nk
        vcoul = ifft3(fft3(n_g, fmesh) * coulG, fmesh)
        return w * jnp.einsum("kgm,g,kgn->kmn", ao_out.conj(), vcoul,
                              ao_out)

    return _j(dm, ao_kpts, ao_out, coulG)


def get_k_kpts(cell, dm_kpts, ao_kpts, kpts, mesh=None, coords=None,
               pair_chunk=256, ao_band=None, kpts_band=None,
               g0_thresh=1e-12, g0_argmin_thresh=None, omega=0.0,
               trunc=None, row_block=None):
    """Exchange matrix vk[k1] from AO values; exact pairwise Poisson solves.

    The nk^2 (k1, k2) pairs run through a compiled ``lax.map`` body
    (nao^2 batched 3D FFTs per pair), dispatched in chunks of ``pair_chunk``
    pairs so no single device kernel runs unboundedly long (large-nk runs
    fault the device otherwise), and reduced on device.

    ``row_block``: bra-AO rows per inner step.  The pair density
    (ng, nao^2) is the memory wall at production cutoffs (NiO dzvp ke=200:
    250047 x 3844 complex64 = 7.7 GB, with FFT temps 2-3x that — the
    device allocator, and hence the remote AOT compile, fails outright);
    the body therefore sweeps bra rows in blocks of ``row_block``
    (auto: ``_ROW_BLOCK_BUDGET_B`` bytes of per-block pair-density+FFT
    temps), an exact
    reorganization of the same sums.

    ``ao_band``/``kpts_band`` (nb, ng, nao)/(nb, 3): compute vk at band
    k-points instead — pairs become (band kb, mesh k2) and the result is
    (nb, nao, nao).  The density matrix always lives on the mesh kpts.

    ``g0_thresh``: Coulomb kernel samples with |q+G|^2 below this are
    excluded.  On the mesh the default 1e-12 removes exactly the singular
    q+G = 0 term (the exxdiv=None convention).

    ``g0_argmin_thresh`` (band paths): for off-mesh band points no sample is
    exactly zero, but one falls arbitrarily close to the BZ singularity and
    produces O(1/|delta|^2 / nk) artifacts.  When set, *exactly the
    argmin-|q+G|^2 sample* of each (row, mesh) pair is excluded iff its
    |q+G|^2 is strictly below this threshold.  Callers pass
    (minimum q-lattice plane spacing dmin)^2: at mesh points the rule then
    reduces exactly to dropping the q+G = 0 term (off-diagonal pairs have
    argmin = dmin^2, not strictly below), while off-mesh it excludes exactly
    one sample for any folded q closer than dmin to the singular lattice —
    in particular everywhere between the inscribed sphere and the
    Wigner-Seitz boundary, where a fixed (dmin/2)^2 *radius* rule excluded
    nothing and flipped the exclusion count 0/1 across the BZ (round-1
    advisor finding).  Argmin selection (not a radius) is what keeps the
    count at one near Wigner-Seitz corners, where several images tie.

    ``omega``: range-separated kernel (erf for omega>0, erfc for omega<0;
    linalg.coulomb convention).  The SR kernel's q+G=0 sample is the finite
    limit pi/omega^2, applied at exactly-zero samples (|q+G|^2 <= g0_thresh);
    the LR divergence is dropped like the bare kernel's.

    ``trunc``: real-space Coulomb truncation (linalg.coulomb convention).
    A truncated kernel is finite everywhere, so the g0/argmin exclusion
    machinery does not apply (the finite q+G=0 value is physical and kept)."""
    omega = float(omega)
    trunc = check_trunc(trunc, omega)
    mesh = cell.mesh if mesh is None else mesh
    fmesh = tuple(int(m) for m in mesh)
    if coords is None:
        coords = cell.gen_uniform_grids(mesh)
    nk, ng, nao = ao_kpts.shape
    dm = jnp.asarray(dm_kpts)
    kpts_d = jnp.asarray(np.asarray(kpts), dtype=jnp.real(ao_kpts).dtype)
    if ao_band is None:
        ao_row, kpts_row, nrow = ao_kpts, kpts_d, nk
    else:
        ao_row = ao_band
        kpts_row = jnp.asarray(np.asarray(kpts_band).reshape(-1, 3),
                               dtype=jnp.real(ao_kpts).dtype)
        nrow = ao_band.shape[0]
    coords_d = jnp.asarray(np.asarray(coords), dtype=jnp.real(ao_kpts).dtype)
    gv = jnp.asarray(cell.get_Gv(fmesh), dtype=jnp.real(ao_kpts).dtype)
    w = cell.vol / ng

    if row_block is None:
        # per-bra-row footprint: pair-density block + FFT work + v, all
        # complex (~3 ng*nao-sized temps); one shared budget constant
        # (chosen so the bench's core config stays single-block — blocking
        # is for production cutoffs where the full pair density cannot
        # exist)
        itemsize = 8 if jnp.real(ao_kpts).dtype == jnp.float32 else 16
        per_row = 3 * ng * nao * itemsize
        row_block = max(1, min(nao,
                               int(_ROW_BLOCK_BUDGET_B // max(per_row, 1))))
    row_block = int(min(row_block, nao))
    nmb = -(-nao // row_block)
    nao_pad = nmb * row_block

    def pair_body(idx, ao_row, ao_kpts, dm):
        k1 = idx // nk
        k2 = idx % nk
        ao1 = jax.lax.dynamic_index_in_dim(ao_row, k1, 0, keepdims=False)
        ao2 = jax.lax.dynamic_index_in_dim(ao_kpts, k2, 0, keepdims=False)
        dm2 = jax.lax.dynamic_index_in_dim(dm, k2, 0, keepdims=False)
        q = kpts_d[k2] - kpts_row[k1]
        eiqr = jnp.exp(1j * (coords_d @ q))
        gk = gv + q[None, :]
        if trunc is not None:
            coulG = _coulG_vec(gk, 0.0, trunc)
        else:
            absg2 = jnp.sum(gk * gk, axis=1)
            keep = absg2 > g0_thresh
            if g0_argmin_thresh is not None:
                imin = jnp.argmin(absg2)
                near = (jnp.arange(absg2.shape[0]) == imin) & (
                    absg2[imin] < g0_argmin_thresh)
                keep = keep & ~near
            coulG = jnp.where(keep,
                              4.0 * jnp.pi / jnp.where(keep, absg2, 1.0),
                              0.0)
            if omega > 0:   # long-range (erf); divergence dropped as bare
                coulG = coulG * jnp.exp(-absg2 / (4.0 * omega * omega))
            elif omega < 0:  # short-range (erfc); finite pi/omega^2 limit
                coulG = jnp.where(
                    absg2 > g0_thresh,
                    coulG * (1.0 - jnp.exp(-absg2 / (4.0 * omega * omega))),
                    jnp.pi / (omega * omega))
        u = jnp.einsum("ls,gs->gl", dm2, ao2.conj())
        # bra rows in blocks: exact reorganization of
        # einsum("gml,gl,gn->mn", v_full, u, ao1) — see docstring
        ao1p = (ao1 if nao_pad == nao
                else jnp.pad(ao1, ((0, 0), (0, nao_pad - nao))))

        def m_block(mb):
            a1 = jax.lax.dynamic_slice_in_dim(ao1p, mb * row_block,
                                              row_block, axis=1)
            rho = (a1.conj()[:, :, None] * ao2[:, None, :]).reshape(ng, -1)
            work = fft3((rho * eiqr.conj()[:, None]).T, fmesh) * coulG
            v = (ifft3(work, fmesh) * eiqr[None, :]).T.reshape(
                ng, row_block, nao)
            t = jnp.einsum("gml,gl->gm", v, u)
            return jnp.einsum("gm,gn->mn", t, ao1)

        if nmb == 1:
            vk1 = m_block(jnp.asarray(0))
        else:
            vk1 = jax.lax.map(m_block, jnp.arange(nmb)).reshape(
                nao_pad, nao)[:nao]
        return (w / nk) * vk1

    npair = nrow * nk
    chunk = min(pair_chunk, npair)

    # complex device arrays go in as jit *arguments*, not closure constants
    @jax.jit
    def map_chunk(idx, ao_row, ao_kpts, dm):
        return jax.lax.map(lambda i: pair_body(i, ao_row, ao_kpts, dm), idx)

    parts = []
    for p0 in range(0, npair, chunk):
        idx = jnp.arange(p0, min(p0 + chunk, npair))
        parts.append(map_chunk(idx, ao_row, ao_kpts, dm))
    contribs = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    return jnp.sum(contribs.reshape(nrow, nk, nao, nao), axis=1)


def get_jk_kpts(cell, dm_kpts, ao_kpts, kpts, mesh=None, coords=None,
                with_j=True, with_k=True, omega=0.0, trunc=None):
    """(vj, vk) exact plane-wave build; either may be None if not requested."""
    vj = (get_j_kpts(cell, dm_kpts, ao_kpts, mesh, omega=omega, trunc=trunc)
          if with_j else None)
    vk = (get_k_kpts(cell, dm_kpts, ao_kpts, kpts, mesh, coords, omega=omega,
                     trunc=trunc)
          if with_k else None)
    return vj, vk
