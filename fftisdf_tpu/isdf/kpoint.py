"""FFT-ISDF with k-point sampling: the framework's flagship object.

Accelerator-native re-design of the reference's build pipeline
(``/root/reference/fftisdf.py:22-131,296-410``); same capability, different
architecture:

- interpolation-point selection on a coarse parent grid via pivoted Cholesky
  of the squared AO gram matrix (ref ``fftisdf.py:357-388``);
- the k<->supercell "stripe" trick for all quartic objects: transform k-space
  blocks to translational-image space with the unitary phase DFT, square
  elementwise, transform back (derived and unit-verified by the reference in
  ``fftisdf-supercell-{1..5}.py``; re-derived independently in
  tests/test_stripe_identities.py);
- grid-swept right-hand side: instead of the reference's Python/C block loop
  spilling to an HDF5 swap (``fftisdf.py:60-87``), the grid axis streams
  through ``lax.map`` on device, and on multi-chip meshes shards over devices
  (fftisdf_tpu.parallel);
- per-q fitting solve + FFT Coulomb kernel -> w_q (ref ``fftisdf.py:97-124``)
  batched with ``lax.map`` over the q axis (sharded over devices when
  available).

The built state is the pair ``(x_k, w_q)`` — (nkpt, nip, nao) interpolation
vectors and (nkpt, nip, nip) Coulomb metrics — which fully determines J, K and
all ERIs (ref ``fftisdf.py:125-128``); it is the serializable artifact.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.lattice import kpoints as kpt_mod
from fftisdf_tpu.basis.eval import make_evaluator
from fftisdf_tpu.linalg.pivoted_cholesky import pivoted_cholesky
from fftisdf_tpu.linalg.solvers import (
    fitting_half_operator, half_factor_data, half_apply, finish_apply)
from fftisdf_tpu.linalg.fft import fft3
from fftisdf_tpu.linalg.coulomb import get_coulG_batched
from fftisdf_tpu.utils.logging import Logger
from fftisdf_tpu.utils.device import to_device, jit_take, czeros


# f64 HOST selection guard (see _select_once): past the cap selection
# falls back to the f32 device path whose scrambled pivot ordering is the
# accuracy failure the host path exists to fix — the auto-densify loop
# therefore never crosses this boundary (measured: a 29^3 auto-densified
# pool on the f32 device path served a 300x WORSE energy than the 18^3
# f64-host pool it replaced).  Round 5 replaced the dense SYRK-gram +
# unblocked pivot loop (O(ng0^2 ncol), the round-4 126.5 s wall at 23^3)
# with the matrix-free blocked factorization
# (linalg.pivoted_cholesky_pairgram_np, O(probe ng0 (ncol + probe)) all
# dgemm-shaped) plus the native screened AO evaluator, so the cap is now
# a COST MODEL (host_select_max_ng0), not a fixed point count: measured
# anchors on the 1-core host at the NiO dzvp production config (nk=64,
# probe=2860, ncol=4464): eval 15.5 s + factor 69 s at 29^3.  The
# absolute ceiling below only backstops the model (and is the
# test-monkeypatch point).
HOST_SELECT_MAX_NG0 = 262144           # hard ceiling (64^3)
HOST_SELECT_FLOP_BUDGET = 2.5e12       # ~3 min at the measured ~12 GF/s
HOST_SELECT_MEM_BUDGET_B = 4e9         # the (probe, ng0) f64 factor


def host_select_max_ng0(cell, kpts, c0, use_trs=True):
    """Largest selection pool the f64 host path accepts, from the cost
    model of the matrix-free blocked pivoted Cholesky: generated-row +
    correction dgemms cost 2 * probe * ng0 * (ncol + probe) flops with
    ncol = 2 * nku * nao real columns, capped by the flop budget, the
    factor's memory, and the absolute ceiling."""
    nk = len(kpts)
    nao = cell.nao_nr()
    nku = nk
    if use_trs:
        mirror = _trs_mirror(cell, kpts)
        if not (mirror < 0).any():
            nku = sum(1 for k in range(nk) if k <= mirror[k])
    probe = int(min(c0, 1e6) * nao * 1.15) + 8
    ncol = 2 * nku * nao
    cap_flops = HOST_SELECT_FLOP_BUDGET / (2.0 * probe * (ncol + probe))
    cap_mem = HOST_SELECT_MEM_BUDGET_B / (8.0 * probe)
    return int(min(HOST_SELECT_MAX_NG0, cap_flops, cap_mem))


class PoolSaturationWarning(UserWarning):
    """Interpolation-point selection is candidate-pool limited: the
    requested compression sits within 10% of the parent grid's numerical
    pair-density rank, so raising ``c0`` buys almost nothing — densify
    ``m0`` (or use ``m0='auto'``, which densifies itself)."""


_saturation_warned = set()   # one warning per (m0, nip) per process


def auto_selection_mesh(cell, nip_target, pool_factor=2.5, k0=None,
                        floor=(15, 15, 15)):
    """Cutoff-derived, basis-scaled selection (parent) mesh.

    The reference's lstsq prototype derives its selection grid from an
    energy cutoff that scales with the cell — ``gmesh =
    pbctools.cutoff_to_mesh(lv, k0)`` (``/root/reference/
    fftdf-with-k-lstsq.py:32``, knob ``k0`` at ``:20,210``).  Two modes:

    - ``k0`` given: the reference's knob verbatim —
      ``cell.cutoff_to_mesh(k0)``, no floor.
    - ``k0=None`` (auto): the smallest cutoff whose mesh carries at least
      ``pool_factor * nip_target`` candidate points (so the pivoted-
      Cholesky pool is never the accuracy limiter — the round-3 finding:
      at the production config the reference's fixed 15^3 pool saturates
      at nip=2480 and c0 stops buying accuracy, while a 19^3 pool halves
      the served J error), elementwise-maxed with ``floor`` (the
      reference's fixed default, ``fftisdf.py:304``) so small systems
      keep the dense default mesh and legacy behavior.

    Deriving the mesh through ``cutoff_to_mesh`` (not a bare cube root)
    keeps the per-axis density proportional to the reciprocal lattice —
    anisotropic cells get anisotropic pools, exactly like the reference's
    ``cutoff_to_mesh(lv, k0)``.
    """
    if k0 is not None:
        return tuple(int(v) for v in cell.cutoff_to_mesh(float(k0)))
    target = float(pool_factor) * float(nip_target)
    ke_hi = 1.0
    while np.prod(cell.cutoff_to_mesh(ke_hi)) < target and ke_hi < 1e6:
        ke_hi *= 2.0
    ke_lo = ke_hi / 2.0
    for _ in range(40):
        ke_mid = 0.5 * (ke_lo + ke_hi)
        if np.prod(cell.cutoff_to_mesh(ke_mid)) >= target:
            ke_hi = ke_mid
        else:
            ke_lo = ke_mid
    m = np.asarray(cell.cutoff_to_mesh(ke_hi))
    if floor is not None:
        m = np.maximum(m, np.asarray(floor))
    return tuple(int(v) for v in m)


def _trs_mirror(cell, kpts):
    """Index of -k in the k list (mod G) per k; -1 where unpaired."""
    s = cell.get_scaled_kpts(np.asarray(kpts))
    return np.array([kpt_mod.member(-s[q], s, strict=False)
                     for q in range(len(s))])


def select_interpolation_points(cell, kpts, m0, c0, dtype=jnp.float64,
                                select_tol=None, log=None,
                                host_f64=None, auto_densify=False,
                                max_densify=2, use_trs=True,
                                keep_tol=None):
    """Pivoted-Cholesky selection of interpolation points on the parent grid.

    Returns (x_k (nk, nip, nao) device array, mask (nip,) host array, rank,
    m0_used).  Mirrors the contract of ``fftisdf.py:357-388``: the
    pair-density gram ``x4 = (sum_k X_k X_k^H)^2 / nk`` on the coarse m0
    grid is pivoted; keep ``nip = min(nao*c0, rank)`` pivots.  Host-syncs
    the pivots once (setup step) so downstream shapes are static.

    ``auto_densify=True`` (the ``m0='auto'`` path): when the saturation
    detector fires — nip within 10% of the pool's numerical rank — the
    selection mesh is densified (pool x2 per retry, up to ``max_densify``
    retries) and selection re-runs, so accuracy is never silently capped
    by the candidate pool.  With an explicit m0 the legacy behavior is
    kept: one :class:`PoolSaturationWarning` per (m0, nip).
    """
    m0 = tuple(int(v) for v in m0)
    prev_rank = -1
    for attempt in range(max_densify + 1):
        out = _select_once(cell, kpts, m0, c0, dtype=dtype,
                           select_tol=select_tol, log=log,
                           host_f64=host_f64, use_trs=use_trs,
                           keep_tol=keep_tol)
        x_k, mask, rank, saturated, ng0, nip = out
        if not saturated:
            break
        if rank <= prev_rank:
            # densifying bought no rank: the PHYSICAL pair-density space
            # is exhausted (true full-rank fit), not the candidate pool —
            # more points cannot help, and no warning is due
            break
        prev_rank = rank
        if auto_densify and attempt < max_densify:
            # pool x2: each axis grows by 2^(1/3), snapped up
            m0_new = tuple(int(np.ceil(v * 2.0 ** (1.0 / 3.0)))
                           for v in m0)
            ng0_cap = host_select_max_ng0(cell, kpts, c0, use_trs=use_trs)
            if (dtype != jnp.float64 and host_f64 is not True
                    and np.prod(m0_new) > ng0_cap):
                # densifying further would push selection off the f64 host
                # path onto the f32 device path, which LOSES accuracy
                # (scrambled pivot ordering) — a denser pool is worthless
                # without f64 ordering, so stop here
                (log or Logger()).info(
                    "select: pool still saturated (nip=%d vs rank %d on "
                    "ng0=%d) but m0 %s -> %s would exceed the f64 host-"
                    "selection guard (%d points) — keeping the f64-ordered "
                    "pool", nip, rank, ng0, m0, m0_new, ng0_cap)
                break
            (log or Logger()).info(
                "select: pool saturated (nip=%d vs rank %d on ng0=%d) — "
                "densifying m0 %s -> %s", nip, rank, ng0, m0, m0_new)
            m0 = m0_new
            continue
        key = (m0, nip)
        if key not in _saturation_warned:
            _saturation_warned.add(key)
            import warnings

            warnings.warn(
                f"interpolation-point selection is pool-saturated: "
                f"nip={nip} vs parent-grid rank {rank} (ng0={ng0}). "
                f"Accuracy is limited by the m0={m0} candidate pool, not "
                "by c0 — increase m0 (or use m0='auto') for more "
                "accuracy.", PoolSaturationWarning, stacklevel=3)
        break
    return x_k, mask, rank, m0


@jax.jit
def pair_gram_sq(x0):
    """Squared pair-density gram of device selection: (nk, ng0, nao) ->
    (ng0, ng0) real, (Re sum_km conj(x[k,g,m]) x[k,h,m])^2 / nk."""
    x2 = jnp.einsum("kgm,khm->gh", x0.conj(), x0).real
    return (x2 * x2) / x0.shape[0]


def _select_once(cell, kpts, m0, c0, dtype=jnp.float64, select_tol=None,
                 log=None, host_f64=None, use_trs=True, keep_tol=None):
    """One selection pass at a fixed parent mesh; see
    :func:`select_interpolation_points` for the contract.  Returns
    (x_k, mask, rank, saturated, ng0, nip)."""
    log = log or Logger()
    t0 = time.perf_counter()
    coords0 = cell.gen_uniform_grids(m0)
    ng0_est = int(np.prod(m0))
    if host_f64 is None:
        # default: on f32 devices run the SELECTION in f64 on the host.
        # Pivot *ordering* degrades measurably in f32 — the greedy Schur
        # diagonal is noise past the first few hundred pivots, and the
        # scrambled tail picks near-duplicate points that ill-condition the
        # fit metric (NiO 4x4x4 szv ke=100 c0=40: f32 device selection
        # gave about twice the vj error of f64 host selection).
        # The one-time host cost is bounded by the host_select_max_ng0
        # cost model (matrix-free factorization + native screened eval).
        host_f64 = (dtype != jnp.float64
                    and ng0_est <= host_select_max_ng0(cell, kpts, c0,
                                                       use_trs=use_trs))
    trs_scatter = None
    if host_f64:
        from fftisdf_tpu.basis.eval import eval_ao_numpy
        from fftisdf_tpu.linalg.pivoted_cholesky import (
            pivoted_cholesky_pairgram_np)

        # TRS halving (x_{-k} = conj(x_k), exact for real AOs): evaluate
        # only the canonical k half — eval_ao_numpy and the SYRK gram are
        # the two selection costs on the 1-core host and both halve — and
        # weight conjugate pairs by 2 in the gram (their Re contributions
        # are equal); the full-k x at the selected points is reconstructed
        # below by conjugate scatter.  ``use_trs=False`` disables the
        # halving here too, so the knob yields a TRS-assumption-free
        # selection oracle (advisor round-4 item).
        nk = len(kpts)
        mirror = _trs_mirror(cell, kpts)
        if use_trs and not (mirror < 0).any():
            ksel = np.array([k for k in range(nk) if k <= mirror[k]])
        else:
            ksel = np.arange(nk)
        if len(ksel) < nk:
            wk = np.where(mirror[ksel] == ksel, 1.0, 2.0)
            pos = {int(k): i for i, k in enumerate(ksel)}
            # every non-canonical k must map to a canonical mirror; a logic
            # error here must raise, not silently scatter sector 0
            trs_scatter = (
                jnp.asarray([pos[k] if k in pos else pos[int(mirror[k])]
                             for k in range(nk)]),
                jnp.asarray([k not in pos for k in range(nk)]))
        else:
            wk = np.ones(nk)
        x0_np = eval_ao_numpy(cell, coords0, np.asarray(kpts)[ksel])
        nku, ng0, nao = x0_np.shape
        # matrix-free blocked greedy factorization of the squared pair
        # gram x4 = (Re sum_km conj(x[k,g,m]) x[k,h,m])^2 / nk: only the
        # PIVOTS' gram rows are ever generated (one zgemm panel per pivot
        # block), so the dense O(ng0^2 ncol) gram that dominated selection
        # at production pools is gone — 23^3 NiO dzvp selection measured
        # 126.5 s (round 4, SYRK gram + unblocked pivots) -> ~45 s, and
        # 29^3 (infeasible before) runs in ~85 s
        flat = np.ascontiguousarray(
            np.transpose(x0_np, (1, 0, 2)).reshape(ng0, nku * nao))
        w_cols = np.repeat(np.sqrt(wk), nao)
        flat *= w_cols[None, :]
        max_rank = min(int(min(c0, 1e6) * nao), ng0)
        # factor ~15% past the requested rank: `rank` is otherwise capped
        # at max_rank and candidate-pool saturation (rank deficiency of
        # the m0 grid, the dzvp accuracy limiter) is undetectable
        probe = min(int(max_rank * 1.15) + 8, ng0)
        piv, rank, hist = pivoted_cholesky_pairgram_np(
            flat, nk, probe, tol=select_tol)
        del flat
        rank_cap = probe
        x0 = to_device(x0_np, dtype=jnp.complex128
                       if dtype == jnp.float64 else jnp.complex64)
    else:
        fn = make_evaluator(cell, kpts=kpts, dtype=dtype)
        x0 = fn(jnp.asarray(coords0, dtype=dtype))  # (nk, ng0, nao)
        nk, ng0, nao = x0.shape
        x4 = pair_gram_sq(x0)
        max_rank = min(int(min(c0, 1e6) * nao), ng0)
        if dtype != jnp.float64:
            # f32 rank *detection* is noise-limited: the Schur diagonal can
            # go non-positive long before the true rank (observed: NiO
            # m0=11 stops at 189 of 520).  Selection therefore always takes
            # max_rank greedy pivots (continuing past the fp rank); the
            # redundant directions are damped by the ridge fit.
            from fftisdf_tpu.linalg.pivoted_cholesky import pivot_selection

            piv, rank_fp, hist = pivot_selection(
                x4, max_rank=max_rank,
                tol=0.0 if select_tol is None else select_tol)
            if log.verbose >= 5:  # int() is a host fetch
                log.debug("select: f32 fp-rank %d of %d pivots (cap-based "
                          "selection keeps all)", int(rank_fp), max_rank)
            rank = max_rank
            rank_cap = max_rank
        else:
            _, piv, rank, hist = pivoted_cholesky(x4, max_rank=max_rank,
                                                  tol=select_tol)
            rank_cap = max_rank
    piv = np.asarray(piv)
    rank = int(rank)
    nip = min(int(nao * c0), rank)
    if keep_tol is not None:
        # near-null-pivot guard: at pair-space rank exhaustion the last
        # pivots sit at the selection tolerance (hist ~ 1e-12 of the
        # leading pivot) — pure noise directions in an f32 serve, and the
        # ridge fit amplifies them catastrophically (measured: the
        # (c0=60, auto-31^3) dzvp point on the 2x2x2 sub-mesh served
        # vk_maxerr 3.7e3 with them, 2.4e-2 without).  Keep only pivots
        # whose Schur diagonal exceeds keep_tol * hist[0].
        hist_np = np.asarray(hist)
        nip_keep = int(np.sum(hist_np > float(keep_tol)
                              * max(float(hist_np[0]), 0.0)))
        if nip_keep < nip:
            (log or Logger()).info(
                "select: keep_tol=%.1e trims %d near-null pivots "
                "(nip %d -> %d)", keep_tol, nip - nip_keep, nip, nip_keep)
            nip = max(nip_keep, 1)
    mask = piv[:nip]
    # candidate-pool saturation detector: the requested compression is
    # within 10% of the parent grid's numerical pair-density rank, so
    # raising c0 buys almost nothing — densify m0 instead (measured at NiO
    # dzvp ke=200: m0 15^3 -> 19^3 HALVES the served J error at fixed
    # c0=40; PARITY.md production-accuracy notes).  The caller decides
    # whether to densify (m0='auto') or warn (explicit m0).
    saturated = nip >= 0.9 * rank and rank < rank_cap
    if log.verbose >= 3:  # residual fetch only when the line is printed
        hist = np.asarray(hist)
        err = float(hist[min(nip, len(hist) - 1)])
        log.info("select_interpolation_points: ng0=%d rank=%d nip=%d "
                 "pivot-residual=%.2e (%.2fs)", ng0, rank, nip, err,
                 time.perf_counter() - t0)
    x_k = _mask_rows(x0, jnp.asarray(mask))
    if trs_scatter is not None:
        # conjugate-scatter the canonical k half back to the full k axis
        x_k = _scatter_trs(x_k, *trs_scatter)
    return x_k, mask, rank, saturated, ng0, nip


@jax.jit
def _eiqr_kernel(coords, kpts):
    """e^{i q.r} phases (nq, ngrid), built on device (no host complex)."""
    t = coords @ kpts.T
    return jax.lax.complex(jnp.cos(t), jnp.sin(t)).T


@jax.jit
def _stripe_quartic(x_k, phase):
    """x4_k[q] via the stripe trick: k -> image space, elementwise square,
    back to k (ref fftisdf.py:38-48).  Equals (1/sqrt(nk)) * the normal
    matrix A^q = sum_k x2_k (.) x2_{q-k}; the same global scale appears in the
    RHS, so the fit is unchanged."""
    nk, nip, _ = x_k.shape
    x2_k = jnp.einsum("kIm,kJm->kIJ", x_k.conj(), x_k)
    x2_s = jnp.einsum("Rk,kIJ->RIJ", phase, x2_k)
    x4_s = (x2_s.real ** 2).astype(x2_s.dtype)  # imag is 0 up to roundoff
    x4_k = jnp.einsum("Rk,RIJ->kIJ", phase.conj(), x4_s)
    return x4_k


def _rhs_block(f_k, x_k, phase):
    """RHS contribution of one grid block: y_k (nk, bg, nip).

    fx_k = conj(f_k) x_k^T per k; stripe, square, back with phase.T (no conj:
    the y sector label satisfies k' = -q - k, see the derivation in
    tests/test_stripe_identities.py and ref fftisdf.py:72-87)."""
    fx_k = jnp.einsum("kgm,kIm->kgI", f_k.conj(), x_k)
    fx_s = jnp.einsum("Rk,kgI->RgI", phase, fx_k)
    y_s = (fx_s.real ** 2).astype(fx_s.dtype)
    y_k = jnp.einsum("Rk,RgI->kgI", phase, y_s)
    return y_k


def _sector_wq(x4_q, y_q, coulG_q, eiqr, mesh, vol, ngrid,
               solver="lstsq", rcond=1e-10, refine=None, signed=False):
    """One momentum sector: w_q from the fit + FFT Coulomb kernel,
    metric-side form.

    The reference solves for the full fitting functions first —
    z_q = A_q^{-1} B_q with B_q = y_q^T (nip x ngrid) — and then contracts
    w_q = (K_q z_q^T)^T z_q^H through the FFT Coulomb operator K_q
    (``fftisdf.py:108-121``).  Since every solver variant here is a fixed
    *hermitian* linear operator S_q (Jacobi-preconditioned truncated-eigh /
    ridge, incl. iterative refinement — see linalg.solvers), the same w_q
    factors as

        w_q = S_q (B_q K_q^T B_q^H) S_q

    computed through the *split* operator S_q = H^H H (see
    linalg.solvers.fitting_half_operator): G = H B_q costs one
    O(nip^2 * ngrid) pass, the Coulomb kernel acts on G's rows (same FFTs as
    before), the inner metric G K_q^T G^H is one more pass, and everything
    else (H^H . H, the refinement polynomial) is nip x nip.  That is ~2
    O(nip^2*ngrid) passes instead of the reference formulation's ~6 (solve,
    refinement, final contraction all on the full RHS), at the same
    cond(A)^1 error amplification — forming B K B^H *without* the half
    factor and applying S twice would square the condition number (verified
    by the 1e-10 full-rank gates in tests/test_isdf_kpoint.py).

    ``signed=True``: the kernel may carry NEGATIVE samples (the 2D-truncated
    kernel's finite q+G=0 value is -2 pi rc^2, and off-mesh band-point
    shifts make more samples negative — linalg.coulomb); the metric is then
    the indefinite split |K|^{1/2} sign(K) |K|^{1/2}, one extra scaled
    operand in the gram.  Static: the 3D/0D kernels are PSD and keep the
    cheaper single-operand form."""
    half, finish, rank = fitting_half_operator(x4_q, method=solver,
                                               rcond=rcond, refine=refine)
    g = half(y_q.T)                             # (nip, ngrid) = H B
    # Parseval: G K_q^T G^H == (vol/ngrid^2) Gf diag(coulG) Gf^H with
    # Gf = FFT[G e^{-iqr}] row-wise — the inverse FFT and the second phase
    # multiplication of the real-space form (ref fftisdf.py:113-121) cancel
    # inside the hermitian gram and are never computed.
    gf = fft3(g * eiqr.conj()[None, :], mesh)
    # PSD split of the (nonnegative) Coulomb kernel: ONE scaled operand in
    # the gram instead of two live O(nip*ngrid) buffers
    h = gf * jnp.sqrt(jnp.abs(coulG_q) * (vol / ngrid**2))
    if signed:
        hs = h * jnp.sign(coulG_q)[None, :]
        w_q = finish(hs @ h.conj().T)
    else:
        w_q = finish(h @ h.conj().T)
    return w_q, rank


@partial(jax.jit, static_argnames=("solver", "mesh", "vol", "ngrid",
                                   "refine", "signed"))
def _solve_coulomb_q(x4_q, y_q, coulG_q, eiqr, mesh, vol, ngrid,
                     solver="lstsq", rcond=1e-10, refine=None, signed=False):
    return _sector_wq(x4_q, y_q, coulG_q, eiqr, mesh, vol, ngrid,
                      solver=solver, rcond=rcond, refine=refine,
                      signed=signed)


# Module-level jitted build stages: stable function identities keep the
# in-memory jit cache warm across repeated builds (closures defined inside
# build() would re-trace and re-load executables from the persistent cache
# on every call — measured at ~8s/build on a single-core host for NiO 4x4x4).
_take_rows = jax.jit(lambda a, i: a[i])
_take_cols = jax.jit(lambda a, i: a[:, i])
_weight_cols = jax.jit(lambda a, i, w: a[:, i] * w[None, :])
_mask_rows = jax.jit(lambda a, m: a[:, m, :])
_scatter_trs = jax.jit(lambda w, o, c: jnp.where(
    c[:, None, None], jnp.conj(w[o]), w[o]))
# scale = vol/ngrid^2 computed on host (f64): ngrid^2 overflows int32.
# abs, not max(.,0): truncated 2D kernels carry a finite NEGATIVE q+G=0
# sample whose magnitude must survive the PSD-style split — its sign is
# restored as a rank-1 gram correction in _sector_gram (neg_cols).
_sqrt_kernel = jax.jit(lambda cg, scale: jnp.sqrt(jnp.abs(cg) * scale))
# donated in-place sector write into the preallocated w_q buffer (a
# python-list + concatenate doubled the w_q footprint right at the end of
# the build — observed OOM at production sizes)
_wq_write = jax.jit(lambda buf, w, i: jax.lax.dynamic_update_slice(
    buf, w[None].astype(buf.dtype), (i, 0, 0)), donate_argnums=(0,))


@partial(jax.jit, static_argnames=("with_j", "with_k", "single", "kmesh"))
def _serve_jk(x_k, w0, ws, dm, *, with_j, with_k, single, kmesh):
    """J/K from a (w0, ws) metric pair (module-level: stable jit cache)."""
    from fftisdf_tpu.isdf import jk as jk_mod

    if single:
        dm = dm[None]
    vj = jk_mod.get_j_kpts(x_k, w0, dm) if with_j else None
    vk = jk_mod.get_k_kpts_img(x_k, ws, dm, kmesh) if with_k else None
    if single:
        vj = None if vj is None else vj[0]
        vk = None if vk is None else vk[0]
    return vj, vk


# The build pipeline runs as FOUR separate executables per sector chunk
# (factors -> grid sweep -> in-place spectral transform -> per-sector
# gram) rather than one fused jit: XLA's static buffer assignment keeps
# loop-body temporaries of every phase alive for the whole program, so
# the fused form pays several GB of "fragmentation" at production sizes
# (a 12.4 GB live set compiled to a 16.8-17.2 GB program).  Split, each
# small program is allocated independently and only the g planes cross
# the boundaries (donated into the spectral stage, so they are
# transformed with zero extra plane allocations); the extra host
# dispatches are ~40 ms per chunk against multi-second stages.


@partial(jax.jit, static_argnames=("nq", "solver", "rcond", "refine"))
def _chunk_factors(x_k, phase_full, qs, *, nq, solver, rcond, refine):
    """Per-sector split-operator factors for one chunk: the quartic normal
    matrices are (re)computed in-pipeline from x_k (nip^2 work; keeping
    the full (nk, nip, nip) tensor resident across chunks costs GBs of
    headroom at production sizes)."""
    x4_c = _stripe_quartic(x_k, phase_full)[qs]    # transient (nq, nip, nip)
    return jax.vmap(lambda a: half_factor_data(
        a, method=solver, rcond=rcond, refine=refine)[1])(x4_c)


def _sweep_chunk_body(coords_p, x_k, phase_full, phase_cols, data_c, *, fn,
                      kind, nip_pad):
    """RHS grid sweep for one chunk of momentum sectors (ref HOT LOOP 1,
    fftisdf.py:72-87), streaming each grid block straight through the
    half solve: the accumulated O(nq * nip * ngrid) tensor is g = H B
    directly and the raw RHS y never exists.

    Plain (un-jitted) body: the single-chip wrapper ``_sweep_chunk`` jits
    it; the sharded build (parallel.build) runs the SAME body per device
    inside ``shard_map`` over its local grid blocks — one implementation
    for both paths (round-3 verdict item #2).

    On TRS-paired meshes both callers pass the CANONICAL K HALF here:
    ``x_k``/``fn`` over the k <= mirror(k) subset and ``phase_full`` the
    weight-folded effective stripe phase (``_trs_sweep_inputs``); the
    image axis R and everything downstream are unchanged.

    The stripe square y_s stays REAL through the sweep (it *is* real —
    casting it complex, as a naive einsum chain does, doubles the HBM
    traffic of the sweep's largest intermediate on a bandwidth-bound
    stage), and the stripe/projection contractions run as real gemms at
    half the complex MACs (a stacked-K single-gemm variant materializes
    the concat).

    g is accumulated IN ITS FINAL (nq, nip_pad, ngrid_pad) LAYOUT as two
    real f32 planes (fori_loop carry, blocks written in place): a
    stacked-block lax.map output makes the consumer's row gather relayout
    the whole array (+4.7 GB of copies at production sizes), which the
    final layout avoids — the sector program then reads rows with plain
    contiguous dynamic slices.  Rows nip..nip_pad stay zero
    (the row-block pairwise gram needs uniform blocks)."""
    nq = phase_cols.shape[1]
    nblk, blk = coords_p.shape[:2]
    rdt = x_k.real.dtype

    def body(i, g):
        g_re, g_im = g
        c = jax.lax.dynamic_index_in_dim(coords_p, i, keepdims=False)
        f_k = fn(c)
        fx_k = jnp.einsum("kgm,kIm->kgI", f_k.conj(), x_k)
        # real part of the stripe transform only (the imaginary part is
        # discarded by the square)
        fx_s = (jnp.einsum("Rk,kgI->RgI", phase_full.real, fx_k.real)
                - jnp.einsum("Rk,kgI->RgI", phase_full.imag, fx_k.imag))
        y_s = fx_s ** 2                            # REAL (nimg, blk, nip)
        y_c = (jnp.einsum("Rq,RgI->qIg", phase_cols.real, y_s)
               + 1j * jnp.einsum("Rq,RgI->qIg", phase_cols.imag, y_s)
               ).astype(fx_k.dtype)
        gb = jax.vmap(lambda d, b: half_apply(kind, d, b))(data_c, y_c)
        at = (0, 0, i * blk)
        return (jax.lax.dynamic_update_slice(g_re, gb.real, at),
                jax.lax.dynamic_update_slice(g_im, gb.imag, at))

    g0 = (jnp.zeros((nq, nip_pad, nblk * blk), rdt),
          jnp.zeros((nq, nip_pad, nblk * blk), rdt))
    return jax.lax.fori_loop(0, nblk, body, g0)


_sweep_chunk = partial(jax.jit, static_argnames=("fn", "kind", "nip_pad"))(
    _sweep_chunk_body)


def _trs_sweep_inputs(cell, kpts, mirror, x_k, phase, dtype):
    """TRS-halved producer inputs (fn, x, stripe-phase) for the RHS sweep.

    Real AOs make f_{-k} = conj(f_k) exact (the Bloch phase e^{ikT} is the
    only k-dependence), hence z_{-k} = conj(z_k) for the projected pair
    factor z_k = f_k^* x_k the sweep builds — so the real image stripe
    y_s[R] = Re sum_k p[R,k] z_k needs only the canonical half of the k
    axis, a conjugate pair contributing 2 Re(p z).  Folding that weight
    into an effective stripe phase keeps ``_sweep_chunk_body`` byte-for-
    byte unchanged: the body already computes P.real @ Re z - P.imag @
    Im z = sum_k w_k Re(p_k z_k).  The AO evaluation, the z projection
    gemm and the stripe gemm — the three producer costs the sweep re-pays
    on EVERY chunk pass over the grid — all halve (64 -> 36 k at 4x4x4).

    Returns ``None`` for a mesh without full time-reversal pairing
    (e.g. shifted): such meshes already run the unhalved path everywhere.
    """
    nk = len(mirror)
    if (np.asarray(mirror) < 0).any():
        return None
    ksel = np.array([k for k in range(nk) if k <= mirror[k]])
    if len(ksel) == nk:
        return None
    wk = np.where(mirror[ksel] == ksel, 1.0, 2.0)
    fn_u = make_evaluator(cell, kpts=np.asarray(kpts)[ksel], dtype=dtype)
    ks_j = jnp.asarray(ksel)
    rdt = jnp.float64 if dtype == jnp.float64 else jnp.float32
    return (fn_u, _take_rows(x_k, ks_j),
            _weight_cols(phase, ks_j, jnp.asarray(wk, dtype=rdt)))


def _spectral_body(g_re, g_im, eiqr_c, sqk_c, *, mesh, ngrid, rblk):
    """Overwrite the swept g planes IN PLACE (donated) with the
    sqrt-Coulomb-scaled spectrum h_q = sqrt(coulG_q vol/ngrid^2)
    FFT[g_q e^{-iqr}], sector by sector in row slabs of ``rblk``.

    Plain body shared with the sharded build (sector axis local there).

    This factors the Coulomb metric through the PSD split (coulG >= 0)
    M_q = h_q h_q^H — so every row is FFT'd exactly ONCE per build (the
    earlier pairwise row-block gram recomputed them (nrb+1)/2 times, and
    the row FFT is bandwidth/permute-bound, far further from peak than
    the gram gemm).  Donation means the spectrum costs zero extra
    planes: the FFT workspace of one slab is the only temp.  Row/column slices are STATIC (python-unrolled slabs:
    dynamic slice starts on a tiled array inside lax loops made XLA
    relayout-copy whole 2.4 GB planes); pad columns ngrid..ngrid_pad are
    zero-filled so the downstream gram can contract the full padded
    width, and pad rows nip..nip_pad stay zero through the FFT."""
    nq, nip_pad, ngrid_pad = g_re.shape
    rblk = min(rblk, nip_pad)
    nrb = nip_pad // rblk
    padw = ngrid_pad - ngrid
    for q in range(nq):
        ph_c = eiqr_c[q].conj()
        sq = sqk_c[q]
        for r in range(nrb):
            r0 = r * rblk
            rows = jax.lax.complex(g_re[q, r0:r0 + rblk, :ngrid],
                                   g_im[q, r0:r0 + rblk, :ngrid])
            spec = fft3(rows * ph_c[None, :], mesh) * sq[None, :]
            at = (q, r0, 0)
            g_re = jax.lax.dynamic_update_slice(
                g_re, jnp.pad(spec.real, ((0, 0), (0, padw)))[None], at)
            g_im = jax.lax.dynamic_update_slice(
                g_im, jnp.pad(spec.imag, ((0, 0), (0, padw)))[None], at)
    return g_re, g_im


_spectral_inplace = partial(jax.jit, static_argnames=("mesh", "ngrid",
                                                      "rblk"),
                            donate_argnums=(0, 1))(_spectral_body)


def _sector_gram_body(g_re, g_im, data_q, *, q, rblk, kind, neg_cols=(),
                      sign=None):
    """One momentum sector's w_q from the in-place spectral planes (ref
    HOT LOOP 2, fftisdf.py:97-124): the Coulomb-metric gram
    M_q = h_q h_q^H over the padded grid width (pad columns are zero),
    then the finish polynomial.

    Only the upper block triangle is formed (the lower is mirrored:
    ~(nrb+1)/(2 nrb) of the full gram MACs) and each block runs as FOUR
    REAL gemms straight off the f32 planes — no complex slab is ever
    materialized, halving the bytes the bandwidth-bound contraction
    streams.  ``q`` is static: the executable is reused across chunks
    and every slab read is a static contiguous slice.

    ``neg_cols``: static grid-column indices where the Coulomb kernel is
    NEGATIVE (truncated 2D kernels: the finite q+G=0 sample -2 pi rc^2).
    The planes hold |coulG|^{1/2}-scaled spectra (_sqrt_kernel uses abs),
    so each such column j contributes +a a^H to the gram where the true
    metric wants -a a^H; the exact fix is the rank-1 subtraction of
    2 a a^H per column (linalg.coulomb module docstring).

    ``sign``: dynamic alternative to ``neg_cols`` — a (ngrid_pad,) +-1 row
    scaling the LEFT gram operand, forming the indefinite metric
    M = H diag(sign) H^H directly (still hermitian, the triangle mirror
    holds).  Used by the sharded build, where every device runs the same
    program and per-sector static column indices are impossible; costs one
    extra elementwise pass over each left slab.  Mutually exclusive with
    ``neg_cols``."""
    nq, nip_pad, ngrid_pad = g_re.shape
    nip = data_q[0].shape[-1]
    rblk = min(rblk, nip_pad)
    nrb = nip_pad // rblk
    assert sign is None or not neg_cols

    def slab(r):
        r0 = r * rblk
        return g_re[q, r0:r0 + rblk, :], g_im[q, r0:r0 + rblk, :]

    def cgram(a, b):
        (re_i, im_i), (re_j, im_j) = a, b
        if sign is not None:
            re_i, im_i = re_i * sign[None, :], im_i * sign[None, :]
        return jax.lax.complex(re_i @ re_j.T + im_i @ im_j.T,
                               im_i @ re_j.T - re_i @ im_j.T)

    # upper block triangle only (the lower is mirrored)
    blocks = [[None] * nrb for _ in range(nrb)]
    for i in range(nrb):
        si = slab(i)
        blocks[i][i] = cgram(si, si)
        for j in range(i + 1, nrb):
            blocks[i][j] = cgram(si, slab(j))
        for j in range(i):
            blocks[i][j] = jnp.zeros_like(blocks[i][i])
    m_u = jnp.block(blocks)[:nip, :nip]
    blk_of = jnp.arange(nip) // rblk
    on_diag = blk_of[:, None] == blk_of[None, :]
    m_q = m_u + m_u.conj().T - jnp.where(on_diag, m_u, 0)
    for j in neg_cols:
        a = jax.lax.complex(g_re[q, :nip, j], g_im[q, :nip, j])
        m_q = m_q - 2.0 * a[:, None] * a.conj()[None, :]
    return finish_apply(kind, data_q, m_q), data_q[-1]


_sector_gram = partial(jax.jit, static_argnames=("q", "rblk", "kind",
                                                 "neg_cols"))(
    _sector_gram_body)


def clear_build_caches():
    """Evict the compiled build-stage executables.

    ``_sweep_chunk`` is keyed on the (static) AO evaluator, whose cache
    lives on the cell: per-geometry rebuild loops (e.g. the scf.optimize
    isdf path, which builds a fresh FFTISDF on a fresh cell every step)
    create a new static identity per geometry, so without eviction compiled
    executables accumulate in the global jit cache over a long relaxation
    (round-1 advisor finding).  Call once per geometry before the rebuild;
    the entries of the new build itself stay warm across its chunks."""
    _chunk_factors.clear_cache()
    _sweep_chunk.clear_cache()
    _spectral_inplace.clear_cache()
    _sector_gram.clear_cache()
    _solve_coulomb_q.clear_cache()


@dataclass
class FFTISDF:
    """Interpolative separable density fitting with FFT Coulomb kernels.

    Drop-in analog of the reference's ``InterpolativeSeparableDensityFitting``
    (``fftisdf.py:296``): configure, ``build()``, then ``get_jk(dm)`` /
    ``get_eri(...)``.

    Knobs (mirroring ``fftisdf.py:297-306`` and the prototype kwargs):
      c0       — interpolation points per AO (default 20.0; driver used 40.0)
      m0       — parent (selection) mesh: 'auto' (default — cutoff-derived
                 and basis-scaled so the candidate pool is never the
                 accuracy limiter, auto-densifying when the saturation
                 detector fires; see :func:`auto_selection_mesh`) or an
                 explicit tuple (the reference's fixed (15, 15, 15),
                 ``fftisdf.py:304``)
      k0       — selection-mesh energy cutoff in Ha (the reference lstsq
                 prototype's knob, ``fftdf-with-k-lstsq.py:20``); sets
                 m0 = cell.cutoff_to_mesh(k0) when m0='auto'
      solver   — 'ridge' (Tikhonov+Cholesky, default: backward-stable and
                 eigh-free, 40-150x more accurate than spectral truncation
                 in f32) | 'lstsq' | 'pinv' | 'svd' (the reference's
                 variants, SURVEY 2a#7-10)
      rcond    — spectral cutoff of the fitting solve
      blksize  — grid-streaming block length
    """
    cell: object
    kpts: np.ndarray
    c0: float = 20.0
    m0: object = "auto"        # 'auto' (cutoff-derived, auto-densifying)
                               # | explicit tuple (ref default (15,15,15))
    k0: float = None           # selection cutoff in Ha ('auto' mode only;
                               # the ref lstsq knob fftdf-with-k-lstsq.py:20)
    m0_pool: float = 2.5       # 'auto': candidate pool >= m0_pool * nip
    m0_floor: tuple = (15, 15, 15)  # 'auto': elementwise mesh floor (the
                               # reference's fixed default)
    solver: str = "ridge"      # ridge (default) | lstsq | pinv | svd
    rcond: float = None        # None: dtype-aware (1e-10 f64, 1e-5 f32)
    refine: int = None         # refinement steps; None: dtype-aware (0/1)
    select_tol: float = None   # pivot threshold; ref isdf.py:45 uses 1e-20
    select_keep: float = None  # relative Schur-diagonal floor: trim pivots
    #                            below select_keep * hist[0] (near-null
    #                            guard at rank exhaustion; None = keep all)
    blksize: int = 16384
    max_memory_gb: float = 12.0  # device-memory budget driving sector
    #                              chunking (fixed; not read from the device)
    use_trs: bool = True       # exploit w_{-q} = conj(w_q) in the build,
    #                            and x_{-k} = conj(x_k) in host selection;
    #                            False disables BOTH (TRS-free oracle)
    trunc: object = None       # Coulomb truncation for low-dimensional
                               # systems: None (3D periodic) | "0d" | "2d"
                               # (auto rc from the cell) | ("0d"|"2d", rc).
                               # Truncated kernels are even in q+G, so TRS
                               # halving still applies (linalg.coulomb).
    select_host_f64: bool = None  # None: f64 host selection on f32 devices
                               # (pivot ordering degrades in f32: measured
                               # 2x vj accuracy on NiO c0=40; device path
                               # kept for f64 and huge parent grids).
                               # True/False force either path.
    dtype: object = None       # None: f64 on CPU (x64), f32 otherwise.
                               # NB explicit f64 on an f32-only device would
                               # silently truncate arrays while keeping f64
                               # numerics knobs (rcond/refine/selection) — a
                               # NaN factory; the auto default prevents it.
    verbose: int = 3
    validate: bool = False     # debug: check stripe-reality invariants
                               # (the asserts at ref fftisdf.py:43,81)
    profile_build: bool = False  # per-stage wall-clock attribution
                               # (selection/factors/sweep/spectral/gram):
                               # inserts a device sync after every
                               # stage, which SERIALIZES the async dispatch
                               # pipeline — use for attribution runs, not
                               # for headline timings.  Results land in
                               # self._stage_s.

    # built state
    x_k: object = None          # (nk, nip, nao)
    wq: object = None           # (nk, nip, nip)
    mask: np.ndarray = None     # (nip,) parent-grid pivot indices
    kmesh: np.ndarray = None
    _log: Logger = field(default=None, repr=False)

    def __post_init__(self):
        from fftisdf_tpu.utils.device import ensure_f32_matmul_precision

        ensure_f32_matmul_precision()
        if self.dtype is None:
            self.dtype = (jnp.float64 if jax.default_backend() == "cpu"
                          and jax.config.jax_enable_x64 else jnp.float32)
        if self.rcond is None:
            # spectral cutoff must sit above the eigensolver's noise floor:
            # f32 eigenvalues carry O(eps_f32 * wmax) errors that a 1e-10
            # cutoff would keep and amplify by 1/w
            self.rcond = 1e-10 if self.dtype == jnp.float64 else 1e-5
        if self.refine is None:
            # refinement in the metric-side build is O(nip^3) — free next to
            # the O(nip^2 ngrid) passes.  2 steps reach the f32 pipeline
            # floor (measured: c0=40 J err 5.3e-5 / 1.4e-5 / 5.3e-6 at
            # refine 0/1/2; step 3 gives <1.4x more)
            self.refine = 0 if self.dtype == jnp.float64 else 2
        if isinstance(self.trunc, str):
            from fftisdf_tpu.linalg.coulomb import trunc_for_cell

            self.trunc = trunc_for_cell(self.cell, self.trunc)
        self.kpts = np.asarray(self.kpts)
        self.kmesh = np.asarray(kpt_mod.kpts_to_kmesh(self.cell, self.kpts))
        self._log = Logger(self.verbose)
        # resolve the selection mesh: 'auto'/None derives it from the
        # requested rank (and auto-densifies on saturation at build time);
        # an explicit tuple is kept verbatim (reference-parity knob)
        self._m0_auto = self.m0 is None or (isinstance(self.m0, str)
                                            and self.m0 == "auto")
        if self._m0_auto:
            self.m0 = auto_selection_mesh(
                self.cell, self.c0 * self.cell.nao_nr(),
                pool_factor=self.m0_pool, k0=self.k0, floor=self.m0_floor)
        else:
            self.m0 = tuple(int(v) for v in self.m0)
        self._kconserv2 = None
        self._kconserv3 = None

    # ------------------------------------------------------------------
    @property
    def nkpt(self):
        return len(self.kpts)

    @property
    def nip(self):
        return None if self.x_k is None else self.x_k.shape[1]

    @property
    def w0(self):
        return None if self.wq is None else self.wq[0]

    @property
    def phase(self):
        return kpt_mod.get_phase(self.cell, self.kpts, self.kmesh)

    def kconserv2(self):
        if self._kconserv2 is None:
            self._kconserv2 = kpt_mod.get_kconserv2(self.cell, self.kpts)
        return self._kconserv2

    def kconserv3(self):
        if self._kconserv3 is None:
            self._kconserv3 = kpt_mod.get_kconserv3(self.cell, self.kpts)
        return self._kconserv3

    # ------------------------------------------------------------------
    def build(self):
        """Build (x_k, w_q).

        Memory architecture (the decision the reference's HDF5 swap papered
        over, SURVEY.md section 7 hard part #6): the RHS tensor
        y (nk, ngrid, nip) may exceed HBM for production systems.  When the
        estimate exceeds ``max_memory_gb``, momentum sectors are processed in
        chunks: the grid sweep re-runs per chunk (AO evaluation repeated,
        HBM bounded by |chunk| * ngrid * nip).  On multi-chip meshes, use
        fftisdf_tpu.parallel.build_sharded which shards y over devices
        instead.
        """
        cell, kpts = self.cell, self.kpts
        log = self._log
        cdtype = jnp.complex128 if self.dtype == jnp.float64 else jnp.complex64
        t_all = time.perf_counter()

        t_sel = time.perf_counter()
        x_k, mask, rank, m0_used = select_interpolation_points(
            cell, kpts, self.m0, self.c0, dtype=self.dtype,
            select_tol=self.select_tol, log=log,
            host_f64=self.select_host_f64, auto_densify=self._m0_auto,
            use_trs=self.use_trs, keep_tol=self.select_keep)
        self._t_select = time.perf_counter() - t_sel
        self.m0 = m0_used   # densified mesh: mask indexes into THIS grid
        self.mask = mask
        self.x_k = x_k

        phase = to_device(self.phase, dtype=cdtype)
        # (the quartic normal matrices are computed in-pipeline per chunk —
        # keeping the (nk, nip, nip) tensor resident costs GBs at
        # production sizes)
        if self.validate:
            x2_k = jnp.einsum("kIm,kJm->kIJ", x_k.conj(), x_k)
            imag_max = float(jnp.max(jnp.abs(
                jnp.einsum("Rk,kIJ->RIJ", phase, x2_k).imag)))
            tol_real = 1e-10 if self.dtype == jnp.float64 else 1e-4
            assert imag_max < tol_real * max(1.0, float(
                jnp.max(jnp.abs(x2_k)))), (
                f"stripe reality violated: imag {imag_max:.2e} "
                "(k-mesh inconsistent with lattice?)")
            log.debug("validate: x2 stripe imag max %.2e", imag_max)

        self.wq = self._metric_pass(omega=0.0)
        self._ws = None     # image-space serve metric: recomputed lazily
        self._wq_omega = {}  # screened (range-separated) metric cache
        log.info("build: total %.2fs", time.perf_counter() - t_all)
        return self

    def _metric_pass(self, omega=0.0):
        """One full metric construction over the built interpolation basis:
        RHS grid sweep + per-sector solve / FFT kernel / gram, chunked to
        the HBM budget, for the Coulomb kernel selected by ``omega``
        (0 = full; see linalg.coulomb for the erf/erfc convention).

        ``build()`` calls this with the full kernel to produce ``self.wq``;
        :meth:`get_wq_omega` re-runs it with a screened kernel, reusing the
        selection and interpolation vectors (w_q is linear in the kernel, so
        a screened metric differs ONLY in the spectral scale — the sweep and
        fit are identical).  Returns the (nk, nip, nip) metric tensor."""
        cell, kpts = self.cell, self.kpts
        log = self._log
        cdtype = jnp.complex128 if self.dtype == jnp.float64 else jnp.complex64
        itemsize = 16 if self.dtype == jnp.float64 else 8
        x_k = self.x_k
        nk, nip, nao = x_k.shape
        phase = to_device(self.phase, dtype=cdtype)

        coords = cell.gen_uniform_grids()
        ngrid = coords.shape[0]
        mesh = tuple(int(m) for m in cell.mesh)
        y_gb = nk * ngrid * nip * itemsize / 1e9
        per_sector_gb = ngrid * nip * itemsize / 1e9
        # (Caching the AO values across chunks was tried and lost: the
        # coarser chunking it forces costs more than the re-evaluation.)
        # time-reversal symmetry (needed by the memory model below —
        # the w_q buffer holds canonical sectors only): w_{-q} = conj(w_q)
        # (real AOs), so only canonical sectors (q <= mirror(q)) need the
        # solve+FFT stage; the rest are mirrored.
        s_kpts = cell.get_scaled_kpts(kpts)
        mirror = np.array([kpt_mod.member(-s_kpts[q], s_kpts, strict=False)
                           for q in range(nk)])
        if (mirror < 0).any():
            # a mesh without full time-reversal pairing (e.g. shifted):
            # degrade to the full-sector path instead of raising (same
            # policy as isdf.autodiff)
            mirror = np.arange(nk)
        if self.use_trs:
            qsel = np.array([q for q in range(nk) if q <= mirror[q]])
        else:
            qsel = np.arange(nk)
        nsec = len(qsel)

        # Per-stage peak model.  The four build executables are allocated
        # independently (see the split-pipeline note above _chunk_factors),
        # so each stage's peak is the g planes + the persistents + its own
        # largest temps:
        #   persistents — preallocated w_q, x_k, chunk factors, kernels;
        #   factors     — x4_c + solve workspace, ~nip^2 each;
        #   sweep       — one grid block's fx_k/stripe/projection chain;
        #   spectral    — one rblk row slab's FFT working set (Bluestein
        #                 padding on non-power-of-two meshes costs a few x
        #                 the slab itself — the 4x factor is measured);
        #   gram        — two slab-pair operand copies + the m/finish
        #                 nip^2 temps.
        # blk beyond ~512 buys nothing on f32 (the sweep gemm rates are
        # blk-independent — measured 33 TF/s at 622 and 1310); larger rblk
        # trims per-slab dispatch/copy overheads only (every row is FFT'd
        # exactly once regardless — _spectral_inplace).
        budget_gb = self.max_memory_gb - max(0.05 * self.max_memory_gb, 0.4)
        nimg = nk
        persist_gb = ((nsec + 4) * nip * nip + nk * nip * nao
                      + 2 * nsec * ngrid) * itemsize / 1e9

        # the sweep's producer chain (AO eval, z projection, stripe) runs
        # on the TRS-canonical k half when the mesh pairs
        # (_trs_sweep_inputs); the image-space stripe/square stay full
        nk_sw = nsec if (self.use_trs and nsec < nk) else nk

        def peak_gb(nq, blk, rblk):
            planes = nq * per_sector_gb
            factors = (3 * nq + 2) * nip * nip * itemsize / 1e9
            sweep = blk * ((nk_sw + nk) * nip + nk_sw * nao
                           + 2 * nq * nip) * itemsize / 1e9
            spectral = 4.0 * rblk * ngrid * itemsize / 1e9
            gram = (2 * rblk * ngrid + 3 * nip * nip) * itemsize / 1e9
            return (planes + persist_gb
                    + max(factors, sweep, spectral, gram))

        # sectors-per-sweep dominates (each extra sector halves/thirds the
        # number of grid sweeps), so qchunk is fitted at the minimum block
        # sizes first, then blk/rblk grow into what is left
        qchunk = 1
        for nq in range(2, nk + 1):
            if peak_gb(nq, 256, 128) > budget_gb:
                break
            qchunk = nq
        qchunk = min(qchunk, nsec)
        blk = min(self.blksize, 512, ngrid) if self.dtype != jnp.float64 \
            else min(self.blksize, ngrid)
        while blk > 256 and peak_gb(qchunk, blk, 128) > budget_gb:
            blk -= 128
        rblk = 128
        for cand in range(128, min(nip, 2048) + 127, 128):
            if peak_gb(qchunk, blk, cand) > budget_gb:
                break
            rblk = cand
        # snap to balanced 8-row-aligned (sublane) blocks covering nip
        nrb = -(-nip // min(rblk, nip))
        rblk = -(-(-(-nip // nrb)) // 8) * 8
        log.info("build: nk=%d nip=%d nao=%d ngrid=%d (y: %.2f GB, "
                 "qchunk=%d blk=%d rblk=%d peak~%.1f GB)", nk, nip, nao,
                 ngrid, y_gb, qchunk, blk, rblk,
                 peak_gb(qchunk, blk, rblk))

        t_set = time.perf_counter()
        # sweep producers on the TRS-canonical k half when the mesh pairs
        # (the g planes and everything downstream are per-SECTOR and
        # unaffected; see _trs_sweep_inputs)
        sweep_in = (_trs_sweep_inputs(cell, kpts, mirror, x_k, phase,
                                      self.dtype) if self.use_trs else None)
        if sweep_in is None:
            sweep_in = (make_evaluator(cell, kpts=kpts, dtype=self.dtype),
                        x_k, phase)
        fn, x_sw, phase_sw = sweep_in
        nblk = -(-ngrid // blk)
        pad = nblk * blk - ngrid
        coords_p = jnp.asarray(np.concatenate(
            [coords, np.zeros((pad, 3))], axis=0).reshape(nblk, blk, 3),
            dtype=self.dtype)

        # Coulomb kernels and q-phases are computed on device from small
        # inputs (Gv, coords, kpts) rather than pushed from the host.
        gv = jnp.asarray(cell.get_Gv(mesh), dtype=self.dtype)
        kpts_d = jnp.asarray(kpts, dtype=self.dtype)
        coulG = get_coulG_batched(cell, kpts_d, gv, dtype=self.dtype,
                                  omega=omega, trunc=self.trunc)
        coords_d = jnp.asarray(coords, dtype=self.dtype)
        eiqr = _eiqr_kernel(coords_d, kpts_d).astype(cdtype)
        vol = float(cell.vol)
        log.debug("build: setup (evaluator, coulG, phases) %.2fs",
                  time.perf_counter() - t_set)

        # ---- RHS sweep (ref HOT LOOP 1, fftisdf.py:72-87) + per-sector
        # solve/FFT (ref HOT LOOP 2, fftisdf.py:97-124), chunked over q,
        # through the module-level jitted stage pipeline (stable jit
        # cache): factors -> grid sweep (g = H B accumulated as real
        # planes) -> donated in-place spectral transform -> per-sector
        # triangular gram + finish.
        t0 = time.perf_counter()
        # persistent-footprint hygiene for production sizes: keep only the
        # canonical-sector slices on device while the chunks run (the full
        # 64-sector x4/eiqr plus accumulated w_q parts otherwise eat the
        # headroom the in-chunk FFT pipeline needs — observed OOM at NiO
        # ke=200/c0=40 right at the post-chunk concatenate)
        qsel_j = jnp.asarray(qsel)
        coulG_sel = _take_rows(coulG, qsel_j)
        eiqr_sel = _take_rows(eiqr, qsel_j)
        del coulG, eiqr
        kind = "ridge" if self.solver == "ridge" else "eigh"
        sqk_sel = _sqrt_kernel(coulG_sel, vol / ngrid**2)
        # truncated 2D kernels carry a finite negative q+G=0 sample that
        # the abs-based split strips the sign from; find the affected
        # columns per canonical sector (host: one tiny count fetch, then
        # one bool row per affected sector — in practice only q=0)
        neg_cols_sel = [()] * nsec
        if self.trunc is not None:
            nneg = np.asarray(jnp.sum(coulG_sel < 0, axis=1))
            for i in np.flatnonzero(nneg):
                neg_cols_sel[i] = tuple(
                    int(j) for j in
                    np.flatnonzero(np.asarray(coulG_sel[i] < 0)))
        wq_sel = czeros((nsec, nip, nip), cdtype)
        rank_parts = []
        # per-stage wall-clock attribution (profile_build): blocking on
        # every stage's output serializes the dispatch queue so the deltas
        # are real stage times, not dispatch latencies
        prof = {"factors": 0.0, "sweep": 0.0, "spectral": 0.0, "gram": 0.0}

        def _tick(name, t0, arr):
            if self.profile_build:
                jax.block_until_ready(arr)
            prof[name] += time.perf_counter() - t0
            return time.perf_counter()

        for q0 in range(0, nsec, qchunk):
            q1 = min(q0 + qchunk, nsec)
            tc = time.perf_counter()
            data_c = _chunk_factors(
                x_k, phase, jnp.asarray(qsel[q0:q1]), nq=q1 - q0,
                solver=self.solver, rcond=self.rcond, refine=self.refine)
            tc = _tick("factors", tc, jax.tree_util.tree_leaves(data_c)[0])
            g_re, g_im = _sweep_chunk(
                coords_p, x_sw, phase_sw, _take_cols(phase, qsel_j[q0:q1]),
                data_c, fn=fn, kind=kind, nip_pad=nrb * rblk)
            tc = _tick("sweep", tc, g_re)
            g_re, g_im = _spectral_inplace(
                g_re, g_im, eiqr_sel[q0:q1], sqk_sel[q0:q1],
                mesh=mesh, ngrid=ngrid, rblk=rblk)
            tc = _tick("spectral", tc, g_re)
            for iq in range(q1 - q0):
                data_q = jax.tree_util.tree_map(lambda a: a[iq], data_c)
                wq_q, rank_q = _sector_gram(
                    g_re, g_im, data_q, q=iq, rblk=rblk, kind=kind,
                    neg_cols=neg_cols_sel[q0 + iq])
                wq_sel = _wq_write(wq_sel, wq_q, q0 + iq)
                rank_parts.append(rank_q)
            _tick("gram", tc, wq_sel)
            del g_re, g_im, data_c
        if self.use_trs and len(qsel) < nk:
            # scatter canonical sectors and their conjugate mirrors
            pos_of = {int(q): i for i, q in enumerate(qsel)}
            order = np.empty(nk, dtype=np.int64)
            conj_flag = np.zeros(nk, dtype=bool)
            for q in range(nk):
                if q in pos_of:
                    order[q] = pos_of[q]
                else:
                    order[q] = pos_of[int(mirror[q])]
                    conj_flag[q] = True
            wq = _scatter_trs(wq_sel, jnp.asarray(order),
                              jnp.asarray(conj_flag))
        else:
            wq = wq_sel
        # NB: w_q is NOT symmetrized: on even FFT meshes the discrete
        # Coulomb operator carries a small skew part from the unmatched -N/2
        # frequency, and the exact plane-wave oracle shares it -- symmetrizing
        # would trade oracle consistency for cosmetic hermiticity.
        # One host fetch for all chunk ranks (it doubles as the queue
        # drain for the timing log).
        ranks = np.asarray(jnp.concatenate(
            [jnp.atleast_1d(r) for r in rank_parts]))
        # introspection for benchmarking/roofline accounting (bench.py)
        self._nsec_solved = len(qsel)
        self._nchunks = -(-len(qsel) // qchunk)
        self._rblk = rblk
        self._stage_s = {k: round(v, 3) for k, v in prof.items()}
        if self.profile_build:
            log.info("build: stage attribution %s (+ selection %.2fs)",
                     self._stage_s, getattr(self, "_t_select", float("nan")))
        log.info("build: %d/%d sectors solved in %d chunk(s), fit ranks %s "
                 "(%.2fs)", len(qsel), nk, self._nchunks, ranks[:8],
                 time.perf_counter() - t0)
        return wq

    # ------------------------------------------------------------------
    def get_jk(self, dm_kpts, with_j=True, with_k=True, exxdiv=None,
               omega=None, kpts_band=None):
        if omega is not None and float(omega) != 0.0:
            # range separation — a guard in the reference
            # (fftisdf.py:392); here served from a screened metric built
            # over the SAME interpolation basis (get_wq_omega)
            if exxdiv is not None:
                raise NotImplementedError(
                    "exxdiv with omega: the probe-charge Madelung constant "
                    "of a screened kernel differs from the bare one — "
                    "not implemented")
            if kpts_band is not None:
                raise NotImplementedError("omega with kpts_band")
            return self._get_jk_metric(
                dm_kpts, self.get_wq_omega(omega),
                self.get_ws_omega(omega) if with_k else None,
                with_j=with_j, with_k=with_k)
        if exxdiv not in (None, "ewald"):
            # the reference guards ALL exxdiv out (fftisdf.py:395); 'ewald'
            # (probe-charge Madelung correction) is supported beyond it
            raise NotImplementedError(f"exxdiv={exxdiv!r} not supported")
        if kpts_band is not None:
            # served from the product state via per-pair re-fits (the
            # reference guards this out, fftisdf.py:194; round-2 item #7)
            if exxdiv is not None:
                raise NotImplementedError(
                    "exxdiv with kpts_band: the Madelung correction needs "
                    "the density at the band point (mesh points only) — "
                    "apply it at the SCF layer (scf.hf does)")
            from fftisdf_tpu.isdf.bands import get_jk_bands

            vj_b, vk_b = get_jk_bands(self, dm_kpts, kpts_band,
                                      with_j=with_j, with_k=with_k)
            return vj_b, vk_b
        vj, vk, dm = self._get_jk_metric(
            dm_kpts, self.wq, self.get_ws() if with_k else None,
            with_j=with_j, with_k=with_k, _return_dm=True)
        if exxdiv == "ewald" and with_k:
            # get_ovlp_kpts builds in self.dtype, so s1e already matches the
            # wq complex dtype (no eager cast needed)
            from fftisdf_tpu.isdf import jk as jk_mod

            vk = jk_mod.add_ewald_exx(vk, self.get_ovlp(), dm,
                                      self.madelung())
        return vj, vk

    def _get_jk_metric(self, dm_kpts, wq, ws, with_j=True, with_k=True,
                       _return_dm=False):
        """J/K serve against an explicit metric pair (wq, ws) — shared by
        the bare-Coulomb and the range-separated (omega) paths."""
        assert self.x_k is not None, "call build() first"
        import numpy as _np
        single = _np.asarray(dm_kpts).ndim == 3 if not isinstance(
            dm_kpts, jnp.ndarray) else dm_kpts.ndim == 3
        dm = to_device(dm_kpts, dtype=wq.dtype)
        kmesh = tuple(int(m) for m in self.kmesh)
        # ws is a dummy when K is skipped (the branch is static, it is
        # never read)
        vj, vk = _serve_jk(self.x_k, wq[0], ws if ws is not None else wq[0],
                           dm, with_j=with_j, with_k=with_k, single=single,
                           kmesh=kmesh)
        if _return_dm:
            return vj, vk, dm
        return vj, vk

    def get_wq_omega(self, omega):
        """Screened (range-separated) Coulomb metric wq^omega over the same
        interpolation basis, cached per omega.  See linalg.coulomb for the
        erf (omega>0) / erfc (omega<0) convention; the first call per omega
        pays one metric pass (the grid sweep + per-sector solve/FFT —
        selection and x_k are reused)."""
        key = float(omega)
        cache = getattr(self, "_wq_omega", None)
        if cache is None:
            cache = self._wq_omega = {}
        if key not in cache:
            assert self.x_k is not None, "call build() first"
            self._log.info("building screened metric (omega=%g)", key)
            cache[key] = {"wq": self._metric_pass(omega=key), "ws": None}
        return cache[key]["wq"]

    def get_ws_omega(self, omega):
        """Image-space form of :meth:`get_wq_omega` (cached)."""
        key = float(omega)
        wq_o = self.get_wq_omega(omega)
        entry = self._wq_omega[key]
        if entry["ws"] is None:
            from fftisdf_tpu.isdf import jk as jk_mod

            entry["ws"] = jk_mod.wq_to_ws(
                wq_o, tuple(int(m) for m in self.kmesh))
        return entry["ws"]

    def get_ws(self):
        """Image-space Coulomb metric ws = Re(phase @ wq) sqrt(nk), cached.

        Density-independent serve state: real (nimg, nip, nip) — half the
        bytes of wq — computed once per build so each SCF iteration's K pays
        only the two density-side k-axis FFTs (isdf.jk.get_k_kpts_img)."""
        if getattr(self, "_ws", None) is None:
            from fftisdf_tpu.isdf import jk as jk_mod

            self._ws = jk_mod.wq_to_ws(
                self.wq, tuple(int(m) for m in self.kmesh))
        return self._ws

    def madelung(self):
        """Probe-charge Madelung constant of the BvK supercell (cached).
        With a truncated kernel this is the Riemann-sum-vs-integral defect
        of the TRUNCATED kernel (scf.integrals.madelung_trunc; exactly 0
        for 0d — the compact spherical kernel has no leading finite-size
        exchange error)."""
        if getattr(self, "_madelung", None) is None:
            from fftisdf_tpu.scf.integrals import madelung as _mad
            from fftisdf_tpu.scf.integrals import madelung_trunc as _madt

            self._madelung = (_madt(self.cell, self.kmesh, self.trunc)
                              if self.trunc is not None
                              else _mad(self.cell, self.kmesh))
        return self._madelung

    def get_ovlp(self):
        """Overlap S_k on the FFT-grid quadrature (cached; streamed build)."""
        if getattr(self, "_s1e", None) is None:
            from fftisdf_tpu.scf.integrals import get_ovlp_kpts

            self._s1e = get_ovlp_kpts(self.cell, self.kpts, dtype=self.dtype,
                                      blksize=self.blksize)
        return self._s1e

    def get_eri(self, kidx, compact=False):
        """ERI tensor for the momentum-conserving quadruple kidx=(k1,k2,k3,k4)
        (ref consumer: fftdf-with-k.py:231)."""
        from fftisdf_tpu.isdf.eri import assemble_eri

        k1, k2, k3, k4 = kidx
        q = self.kconserv2()[k1, k2]
        assert self.kconserv3()[k1, k2, k3] == k4, "quadruple not conserving"
        take = lambda i: jit_take(self.x_k, i)
        return assemble_eri(jit_take(self.wq, int(q)), take(k1), take(k2),
                            take(k3), take(k4))

    # ------------------------------------------------------------------
    def save(self, path):
        from fftisdf_tpu.utils import serialization

        serialization.save_isdf_state(path, self)

    @classmethod
    def load(cls, path, cell, kpts):
        from fftisdf_tpu.utils import serialization

        return serialization.load_isdf_state(path, cls, cell, kpts)


ISDF = FFTISDF
