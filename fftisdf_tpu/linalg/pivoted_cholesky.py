"""Pivoted (rank-revealing) Cholesky factorization in pure JAX.

Native replacement for PySCF's ``scipy_helper.pivoted_cholesky`` (LAPACK
``dpstrf``-style), used by the reference for interpolation-point selection
(``/root/reference/fftisdf.py:381-382``, ``isdf.py:44-45``,
``k_least_square.py:160-170``).

The greedy pivot loop is inherently sequential; the accelerator-friendly formulation
below keeps everything in original index order (no in-place row/column
permutations, which XLA hates): maintain the Schur-complement diagonal ``d``
and the factor rows ``L[j, :]``; each step is one argmax + one gather + one
(K, n) matvec + rank-1 diagonal update inside ``lax.fori_loop``.  Cost
O(K^2 n), bandwidth-bound on the L matmul — fine for the parent-grid sizes
(n ~ 3-10k) this is used on.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("max_rank", "keep_indefinite"))
def _pivoted_cholesky_impl(a, tol, max_rank: int, keep_indefinite: bool):
    n = a.shape[0]
    rdtype = jnp.real(a).dtype
    d0 = jnp.real(jnp.diagonal(a)).astype(rdtype)

    def body(j, state):
        d, L, piv, dmax_hist = state
        i = jnp.argmax(d).astype(jnp.int32)
        dmax = d[i]
        # residual of row i: a[i, :] - sum_m conj(L[m, i]) L[m, :]
        col = a[i, :]
        corr = L[:, i].conj() @ L
        lj = (col - corr) / jnp.sqrt(jnp.maximum(dmax, 1e-300).astype(rdtype))
        # once dmax <= 0 (numerical exhaustion) the factor row is frozen to
        # zero either way; with keep_indefinite the *pivot* is still emitted
        # (and the point retired) — the selection consumer wants max_rank
        # well-spread points even past the fp noise rank, where the stale
        # residual diagonal is still the best available spreading criterion
        ok = dmax > 0
        lj = jnp.where(ok, lj, jnp.zeros_like(lj))
        d = d - jnp.real(lj * lj.conj())
        retire = ok if not keep_indefinite else True
        d = d.at[i].set(jnp.where(retire, -jnp.inf, d[i]))
        L = L.at[j].set(lj)
        piv = piv.at[j].set(jnp.where(ok | keep_indefinite, i, -1))
        dmax_hist = dmax_hist.at[j].set(dmax)
        return d, L, piv, dmax_hist

    L0 = jnp.zeros((max_rank, n), dtype=a.dtype)
    piv0 = jnp.full((max_rank,), -1, dtype=jnp.int32)
    hist0 = jnp.zeros((max_rank,), dtype=rdtype)
    d, L, piv, hist = jax.lax.fori_loop(0, max_rank, body, (d0, L0, piv0, hist0))
    rank = jnp.sum((hist > tol).astype(jnp.int32))
    return L, piv, rank, hist


def pivot_selection(a, max_rank=None, tol=0.0):
    """Pivot indices for point *selection* on noise-limited dtypes: always
    returns ``max_rank`` distinct pivots (greedy residual-diagonal order,
    continuing past the fp rank), plus the detected numerical rank."""
    a = jnp.asarray(a)
    n = a.shape[0]
    max_rank = n if max_rank is None else int(min(max_rank, n))
    tol = jnp.asarray(tol, dtype=jnp.real(a).dtype)
    _, piv, rank, hist = _pivoted_cholesky_impl(a, tol, max_rank,
                                                keep_indefinite=True)
    return piv, rank, hist


def pivoted_cholesky_np(a, tol=None, max_rank=None):
    """Host f64 greedy pivoted Cholesky (same contract as the jax version).
    Used for setup-stage selection when the device dtype is f32."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    k = n if max_rank is None else int(min(max_rank, n))
    d = np.ascontiguousarray(np.real(np.diagonal(a)).copy())
    if tol is None:
        tol = n * np.finfo(np.float64).eps * max(d.max(), 0.0)
    L = np.zeros((k, n))
    piv = np.full(k, -1, dtype=np.int64)
    hist = np.zeros(k)
    for j in range(k):
        i = int(np.argmax(d))
        dmax = d[i]
        hist[j] = dmax
        if dmax <= 0:
            break
        lj = (a[i, :] - L[:j, i] @ L[:j, :]) / np.sqrt(dmax)
        d -= lj * lj
        d[i] = -np.inf
        L[j] = lj
        piv[j] = i
    rank = int(np.sum(hist > tol))
    return L, piv, rank, hist


def pivoted_cholesky_pairgram_np(flat, nk, max_rank, tol=None, block=96):
    """Matrix-free blocked greedy pivoted Cholesky of the SQUARED pair
    gram ``x4 = (Re(flat flat^H))**2 / nk`` — never forms the ng0 x ng0
    matrix.

    ``flat`` is the (ng0, ncol) complex (or real) AO matrix whose rows are
    grid points and whose columns run over (k, ao) — exactly the operand
    the dense host path fed to SYRK; any TRS k-weighting must already be
    folded into the columns (sqrt(w) scaling).  The gram entry is
    ``x4[g,h] = (Re <flat[g], flat[h]>)^2 / nk``.

    Returns ``(piv, rank, hist)`` with the same semantics as
    :func:`pivoted_cholesky_np` (pivots in selection order, numerical rank
    by the dpstrf-style ``tol``, Schur-diagonal history).  The pivot
    SEQUENCE equals the dense greedy algorithm's up to floating-point
    tie-breaking: candidates are taken from the live Schur diagonal in
    blocks, their gram rows are generated on the fly (one zgemm panel),
    corrected against the existing factor (one dgemm), and a candidate is
    only accepted while its updated diagonal is still the global argmax —
    otherwise the block is abandoned and re-selected, so the greedy
    invariant is exact.

    Cost: O(max_rank * ng0 * ncol) for the generated rows plus
    O(max_rank^2 * ng0) for the corrections — both dgemm-shaped — versus
    the dense path's O(ng0^2 * ncol) gram that dominated selection at
    production pools (a 23^3 host pool on one core).
    Memory: the (max_rank, ng0) factor instead of the ng0^2 gram.
    """
    flat = np.ascontiguousarray(flat)
    ng0, ncol = flat.shape
    k = int(min(max_rank, ng0))
    iscomplex = np.iscomplexobj(flat)
    if iscomplex:
        fre = np.ascontiguousarray(flat.real)
        fim = np.ascontiguousarray(flat.imag)
    else:
        fre = np.ascontiguousarray(flat, dtype=np.float64)
        fim = None
    # diagonal of x4: row norms squared, squared
    nrm2 = np.einsum("gc,gc->g", fre, fre)
    if fim is not None:
        nrm2 += np.einsum("gc,gc->g", fim, fim)
    d = (nrm2 * nrm2) / nk
    if tol is None:
        tol = ng0 * np.finfo(np.float64).eps * max(d.max(), 0.0)
    L = np.zeros((k, ng0))
    piv = np.full(k, -1, dtype=np.int64)
    hist = np.zeros(k)
    j = 0
    while j < k:
        if not np.isfinite(d).any() or d.max() <= 0:
            break
        b = min(block, k - j)
        # candidate block: current top-b of the live Schur diagonal
        cand = np.argpartition(d, -b)[-b:]
        cand = cand[np.argsort(d[cand])[::-1]]
        # their x4 rows, matrix-free: (Re <flat[c], flat[.]>)^2 / nk
        g = fre[cand] @ fre.T
        if fim is not None:
            g += fim[cand] @ fim.T
        np.multiply(g, g, out=g)
        g /= nk
        # correct against the existing factor: one dgemm panel
        if j:
            g -= L[:j, cand].T @ L[:j, :]
        pos = {int(c): i for i, c in enumerate(cand)}
        taken = 0
        while j < k and taken < b:
            i = int(np.argmax(d))
            dmax = d[i]
            if dmax <= 0:
                j = k  # numerical exhaustion: mirror the dense path's break
                break
            if i not in pos:
                # a non-candidate point now dominates the diagonal (its
                # value rose past the block's survivors is impossible —
                # diagonals only fall — but the candidates' values FELL
                # below it): re-select the block, greedy order preserved
                break
            hist[j] = dmax
            row = g[pos[i]]
            lj = row / np.sqrt(dmax)
            d -= lj * lj
            d[i] = -np.inf
            L[j] = lj
            piv[j] = i
            # within-block correction for the remaining candidates
            g -= np.outer(lj[cand], lj)
            j += 1
            taken += 1
    rank = int(np.sum(hist > tol))
    return piv, rank, hist


def pivoted_cholesky(a, tol=None, max_rank=None):
    """Greedy pivoted Cholesky of a hermitian PSD matrix.

    Returns ``(L, piv, rank, diag_hist)`` where ``L`` is ``(max_rank, n)`` with
    rows in *original* column order (``a ~= L^H L`` when complete), ``piv`` the
    pivot indices in selection order, ``rank`` the number of pivots whose
    Schur diagonal exceeded ``tol``, and ``diag_hist[j]`` the pivot magnitude
    at step j (``diag_hist[rank]`` is the error estimate the reference logs,
    ``fftisdf.py:387``).

    ``tol=None`` uses the dpstrf-style default ``n * eps * max(diag)``.
    """
    a = jnp.asarray(a)
    n = a.shape[0]
    if max_rank is None:
        max_rank = n
    max_rank = int(min(max_rank, n))
    if tol is None:
        eps = jnp.finfo(jnp.real(a).dtype).eps
        tol = n * eps * jnp.max(jnp.abs(jnp.real(jnp.diagonal(a))))
    tol = jnp.asarray(tol, dtype=jnp.real(a).dtype)
    return _pivoted_cholesky_impl(a, tol, max_rank, keep_indefinite=False)
