"""Fitting-equation solvers: the four variants the reference prototypes.

The ISDF fit solves ``A z = B`` with ``A = x4_q`` (nip x nip hermitian PSD)
and ``B = y_q^T`` (nip x ngrid), per momentum sector q.  The reference tried
four solvers (SURVEY.md section 2a #7-10):

- ``lstsq``  — LAPACK gelsy (``/root/reference/fftisdf.py:108``)
- ``pinv``   — Moore-Penrose (``fftdf-with-k.py:92-95``)
- ``svd``    — rank-truncated SVD (``fftdf-with-k-svd.py:147-164``)
- ``whiten`` — SVD-whitening of the interpolation vectors so the solve is
  diagonal (``fftdf-with-k-svd-backup.py:84-105,173-176``)

On the device all four reduce to one eigendecomposition of the hermitian
``A`` (XLA eigh) followed by matmuls; ``gelsy``'s column-pivoted QR has no
advantage over eigh for hermitian systems, so eigh is the canonical kernel.
The framework's default is ``ridge`` (Tikhonov + Cholesky): eigh-free and,
with refinement, 40-150x more accurate than spectral truncation in f32.
``whiten`` is exposed through :func:`whiten_basis` (it rotates x_k instead
of solving).

Two operator forms share one factorization layer:
- full operators (:func:`fitting_operator` / :func:`solve_fitting`) apply
  S = A^-1-like to a right-hand side;
- the split form (:func:`fitting_half_operator`, S = H^H H) lets the
  metric-side w_q assembly in isdf.kpoint touch the O(nip^2 ngrid) RHS only
  twice while keeping cond(A)^1 error amplification.
"""
from __future__ import annotations

import jax
import jax.ad_checkpoint
import jax.numpy as jnp

# checkpoint policy for rematerializing fitting-solve pipelines: recompute
# the O(nip*ngrid) tensors, SAVE the O(nip^2) solve factorizations (their
# recompute-rounding is amplified by the solve's 1/rcond conditioning)
FIT_FACTOR_POLICY = jax.checkpoint_policies.save_only_these_names(
    "fit_factor")


def _save_in_remat(x, name="fit_factor"):
    """checkpoint_name that accepts complex arrays (the underlying
    reduce_precision tag is float-only: tag re/im separately)."""
    if jnp.iscomplexobj(x):
        return jax.lax.complex(
            jax.ad_checkpoint.checkpoint_name(jnp.real(x), name),
            jax.ad_checkpoint.checkpoint_name(jnp.imag(x), name))
    return jax.ad_checkpoint.checkpoint_name(x, name)


def _real_dtype(a):
    return (jnp.float64 if a.dtype in (jnp.complex128, jnp.float64)
            else jnp.float32)


def _default_refine(a, refine):
    if refine is None:
        return 0 if _real_dtype(a) == jnp.float64 else 1
    return refine


def _jacobi(a):
    """Two-sided diagonal (Jacobi) scaling: (d, dinv, D a D) with
    D = diag(a)^-1/2, noise-guarded.  Collapses the amplitude-driven part of
    the condition number before factorization.

    Rows whose diagonal sits at the roundoff floor (< n*eps*dmax — the
    absolute noise of a gram-like accumulation) are DROPPED (d=0): their
    off-diagonals violate Cauchy-Schwarz by noise alone, and scaling them by
    1/sqrt(noise) makes the scaled matrix indefinite at O(1) — Cholesky then
    NaNs, which poisons reverse-mode sweeps even through unused sectors.
    Kept rows are additionally clamped to the |a_ij| <= sqrt(a_ii a_jj)
    Cauchy-Schwarz bound (|scaled| <= 1), a noise-level projection for any
    exactly-PSD matrix."""
    dscale = jnp.real(jnp.diagonal(a))
    dmax = jnp.max(jnp.abs(dscale))
    eps = jnp.finfo(dscale.dtype).eps
    dok = dscale > (a.shape[-1] * eps) * dmax
    d = jnp.where(dok, 1.0 / jnp.sqrt(jnp.where(dok, dscale, 1.0)), 0.0)
    dinv = jnp.where(dok, jnp.sqrt(jnp.where(dok, dscale, 1.0)), 0.0)
    a_s = a * d[:, None] * d[None, :]
    # stop_gradient: |.| is non-smooth at 0 (reverse-mode NaN) and the clamp
    # only ever rescales noise-level entries
    a_s = a_s / jnp.maximum(1.0, jax.lax.stop_gradient(jnp.abs(a_s)))
    return d, dinv, a_s


def _ridge_factor(a, rcond):
    """Cholesky factor of D a D + lam*I.  Returns (d, dinv, chol, lam).

    The factor is tagged with ``checkpoint_name("fit_factor")``: callers
    that wrap the fitting solve in ``jax.checkpoint`` must use the policy
    :data:`FIT_FACTOR_POLICY` so the factor is SAVED, not recomputed — the
    solve has cond ~ 1/rcond, and a bitwise-different rematerialized factor
    perturbs the vjp by eps/rcond (measured 2e-5 absolute on f64 gradients)."""
    d, dinv, a_s = _jacobi(a)
    lam0 = rcond * jnp.max(jnp.real(jnp.diagonal(a_s)))
    # PSD guard: the Jacobi-scaled gram is PSD in exact arithmetic, but at
    # f32 its eigenvalue noise floor (~ n eps lam_max) can sit BELOW
    # -lam0 = -rcond for heavily compressed (rank-deficient) quartics, and
    # whether a marginal gram crosses depends on the backend's accumulation
    # order (observed: CPU f32 fine, accelerator f32 Cholesky all-NaN at diamond
    # c0=40).  Escalate lam by 10x until the shifted Cholesky is finite —
    # stop_gradient keeps the scalar search out of reverse sweeps (lam is
    # a regularizer; its sensitivity is not part of the functional), so
    # while_loop never needs a reverse rule.
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    # stop_gradient on the loop INPUTS: no differentiated value may flow
    # into a while_loop (it has no reverse rule)
    a_sg = jax.lax.stop_gradient(a_s)

    def _finite(lam):
        c = jnp.linalg.cholesky(a_sg + lam * eye)
        return jnp.all(jnp.isfinite(c.real) & jnp.isfinite(c.imag))

    lam, nesc = jax.lax.while_loop(
        lambda st: jnp.logical_and(~_finite(st[0]), st[1] < 8),
        lambda st: (st[0] * 10.0, st[1] + 1),
        (jax.lax.stop_gradient(lam0), jnp.asarray(0, jnp.int32)))
    # one extra decade of margin when escalation fired: if lam landed just
    # above |w_min| the refinement factor g = lam/(w+lam) would exceed 1 on
    # the noise direction and the polynomial would AMPLIFY it; at 10x
    # margin g <= 10/9 and refine=2 costs at most ~23% on pure noise
    lam = jnp.where(nesc > 0, lam * 10.0, lam)
    a_r = a_s + lam * eye
    chol = _save_in_remat(jnp.linalg.cholesky(a_r))
    return d, dinv, chol, lam


def _eigh_factor(a, rcond, rank, precondition):
    """Truncated eigh of (optionally Jacobi-scaled) a.
    Returns (d, w, v, keep) with keep the retained-eigenvalue mask."""
    if precondition:
        d, _, a_s = _jacobi(a)
    else:
        d = jnp.ones(a.shape[-1], dtype=_real_dtype(a))
        a_s = a
    w, v = jnp.linalg.eigh(a_s)
    # saved (not rematerialized) under FIT_FACTOR_POLICY — see _ridge_factor
    w = _save_in_remat(w)
    v = _save_in_remat(v)
    wmax = jnp.max(jnp.abs(w))
    rc = a.shape[-1] * jnp.finfo(w.dtype).eps if rcond is None else rcond
    keep = w > rc * wmax
    if rank is not None:
        # additionally cap the rank: keep the `rank` largest eigenvalues
        idx = jnp.argsort(w)[::-1]
        kmask = jnp.zeros_like(keep).at[idx[:rank]].set(True)
        keep = jnp.logical_and(keep, kmask)
    return d, w, v, keep


def _with_refinement(apply_base, a, refine):
    """Wrap a base solve with fixed-precision iterative refinement.

    The resulting operator S_r = S + S(I - aS) + ... is hermitian whenever
    the base S is (each term is a product of hermitian factors arranged
    symmetrically), which the metric-side w_q assembly in
    isdf.kpoint relies on."""

    def apply(rhs):
        z = apply_base(rhs)
        for _ in range(refine):
            z = z + apply_base(rhs - a @ z)
        return z

    return apply


def hermitian_operator(a, rcond=None, rank=None, precondition=True,
                       refine=None):
    """Truncated-eigh solve operator for hermitian PSD a.

    Numerical hardening for f32 devices (where the pair-density normal
    matrices are severely ill-conditioned): Jacobi preconditioning +
    fixed-precision iterative refinement (default 1 step on f32, correcting
    the truncated-eigh solve against the original matrix).

    Returns (apply(rhs) -> z, numerical_rank); apply is a hermitian linear
    operator."""
    refine = _default_refine(a, refine)
    d, w, v, keep = _eigh_factor(a, rcond, rank, precondition)
    winv = jnp.where(keep, 1.0 / jnp.where(keep, w, 1.0), 0.0)

    def apply_inv(rhs):
        rhs = d[:, None] * rhs
        out = v @ (winv[:, None] * (v.conj().T @ rhs))
        return d[:, None] * out

    return (_with_refinement(apply_inv, a, refine),
            jnp.sum(keep.astype(jnp.int32)))


def hermitian_solve(a, b, rcond=None, rank=None, precondition=True,
                    refine=None):
    """Solve a z = b for hermitian PSD a via eigh with spectral truncation.
    See :func:`hermitian_operator`.  Returns (z, numerical_rank)."""
    apply_inv, rank_out = hermitian_operator(
        a, rcond=rcond, rank=rank, precondition=precondition, refine=refine)
    return apply_inv(b), rank_out


def ridge_operator(a, rcond=1e-10, refine=None):
    """Tikhonov-regularized Cholesky solve operator:
    apply(b) = (a + rcond*amax*I)^-1 b (+ refinement).

    The smooth counterpart of spectral truncation: weak directions are damped
    instead of cut.  One potrf + two triangular solves — much cheaper than
    eigh.  Jacobi preconditioning and optional
    iterative refinement as in hermitian_operator.  Returns
    (apply, rank=n); apply is a hermitian linear operator."""
    refine = _default_refine(a, refine)
    d, _, chol, _ = _ridge_factor(a, rcond)

    def apply_inv(rhs):
        rhs = d[:, None] * rhs
        u = jax.scipy.linalg.solve_triangular(chol, rhs, lower=True)
        out = jax.scipy.linalg.solve_triangular(
            chol.conj().T, u, lower=False)
        return d[:, None] * out

    return (_with_refinement(apply_inv, a, refine),
            jnp.asarray(a.shape[-1], dtype=jnp.int32))


def ridge_solve(a, b, rcond=1e-10, refine=None):
    """Solve via :func:`ridge_operator`.  Returns (z, rank)."""
    apply_inv, rank = ridge_operator(a, rcond=rcond, refine=refine)
    return apply_inv(b), rank


def half_factor_data(a, method="lstsq", rcond=1e-10, rank=None,
                     precondition=True, refine=None):
    """Array-only (vmap/batch-friendly) form of the split fitting operator.

    Returns ``(kind, data)``: ``kind`` is a static string ('ridge' or
    'eigh') for :func:`half_apply` / :func:`finish_apply`, and ``data`` is
    a pytree of arrays — the same math as :func:`fitting_half_operator`
    but with no closures, so callers can ``jax.vmap`` the factorization
    over momentum sectors and stream ``half_apply`` over grid blocks (the
    memory-lean production build pipeline in isdf.kpoint).

    data = (d, f1, f2, p, rank) with
      ridge:       f1 = chol,  f2 = unused-eye,  p = refinement polynomial
      eigh-family: f1 = v,     f2 = sqw (diag),  p = identity
    """
    refine = _default_refine(a, refine)
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=a.dtype)
    if method == "ridge":
        d, dinv, chol, lam = _ridge_factor(a, rcond)
        p = eye
        if refine:
            t = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
            t = jax.scipy.linalg.solve_triangular(chol.conj().T, t,
                                                  lower=False)
            g = lam * (d[:, None] * t * dinv[None, :])
            term = eye
            for _ in range(refine):
                term = term @ g
                p = p + term
        return "ridge", (d, chol, eye, p,
                         jnp.asarray(n, dtype=jnp.int32))
    if method in ("lstsq", "pinv", "eigh", "svd"):
        d, w, v, keep = _eigh_factor(a, rcond, rank,
                                     precondition and method != "svd")
        sqw = jnp.sqrt(jnp.where(keep, 1.0 / jnp.where(keep, w, 1.0), 0.0))
        return "eigh", (d, v, sqw.astype(_real_dtype(a)), eye,
                        jnp.sum(keep.astype(jnp.int32)))
    raise ValueError(f"unknown solver {method!r}")


def half_apply(kind, data, b):
    """H b for b (nip, m) — see :func:`half_factor_data`."""
    d, f1, f2, p, _ = data
    if kind == "ridge":
        return jax.scipy.linalg.solve_triangular(
            f1, d[:, None] * b, lower=True)
    return f2[:, None] * (f1.conj().T @ (d[:, None] * b))


def finish_apply(kind, data, m_in):
    """P (H^H m_in H) P^H — see :func:`half_factor_data`."""
    d, f1, f2, p, _ = data
    if kind == "ridge":
        t = jax.scipy.linalg.solve_triangular(f1.conj().T, m_in,
                                              lower=False)
        t = jax.scipy.linalg.solve_triangular(f1.conj().T, t.conj().T,
                                              lower=False)
        w0 = d[:, None] * t.conj().T * d[None, :]
    else:
        t = f1 @ (f2[:, None] * m_in * f2[None, :]) @ f1.conj().T
        w0 = d[:, None] * t * d[None, :]
    return p @ w0 @ p.conj().T


def fitting_half_operator(a, method="lstsq", rcond=1e-10, rank=None,
                          precondition=True, refine=None):
    """Split form of the fitting-solve operator: S = H^H H.

    Returns ``(half, finish, rank)`` with
      half(b)      = H b                      (nip x m gemm / tri-solve)
      finish(m_in) = P (H^H m_in H) P^H       (all nip x nip)
    where P = sum_{j=0..refine} (I - S0 A)^j is the iterative-refinement
    polynomial (S_refined = P S0, and S_r M S_r = P (S0 M S0) P^H).

    Purpose (see isdf.kpoint._sector_wq): w_q = S M S with
    M = B K B^H must NOT be computed by forming M and applying S twice —
    ||M|| ~ ||A||^2 ||Xi K Xi|| while ||w|| is O(1), so M's formation
    roundoff is amplified by cond(A)^2.  Routing each B through the half
    factor H keeps every intermediate at O(cond(A)^(1/2)) amplification per
    side (cond(A)^1 total — the same as the reference's solve-then-contract
    path) while still touching the O(nip^2 * ngrid) data only twice.

    NB for spectral-truncation methods (lstsq/pinv/eigh/svd) refinement is
    forced to 0: in exact arithmetic S0 A S0 == S0 (refinement is a no-op
    for a truncated inverse); its only role in the full-RHS path is
    correcting eigh rounding, which has no stable nip x nip polynomial form.
    Ridge keeps refinement (the lam bias is what it removes), computed
    analytically: I - S0 A == lam * D (C C^H)^{-1} D^{-1} — forming S0 @ A
    and subtracting numerically would carry eps*cond(A) cancellation garbage
    in f32.
    """
    refine = _default_refine(a, refine)

    if method == "ridge":
        d, dinv, chol, lam = _ridge_factor(a, rcond)

        def half(b):  # H b = C^{-1} D b
            return jax.scipy.linalg.solve_triangular(
                chol, d[:, None] * b, lower=True)

        def sandwich(m_in):  # H^H m_in H = D C^{-H} m_in C^{-1} D
            t = jax.scipy.linalg.solve_triangular(
                chol.conj().T, m_in, lower=False)          # C^{-H} m_in
            t = jax.scipy.linalg.solve_triangular(
                chol.conj().T, t.conj().T, lower=False)    # C^{-H} m^H C^{-1}
            return d[:, None] * t.conj().T * d[None, :]

        def gmat():  # I - S0 A, analytic (see docstring)
            eye = jnp.eye(a.shape[-1], dtype=a.dtype)
            t = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
            t = jax.scipy.linalg.solve_triangular(
                chol.conj().T, t, lower=False)
            return lam * (d[:, None] * t * dinv[None, :])

        rank_out = jnp.asarray(a.shape[-1], dtype=jnp.int32)
    elif method in ("lstsq", "pinv", "eigh", "svd"):
        refine = 0
        d, w, v, keep = _eigh_factor(a, rcond, rank,
                                     precondition and method != "svd")
        sqw = jnp.sqrt(jnp.where(keep, 1.0 / jnp.where(keep, w, 1.0), 0.0))

        def half(b):  # H b = SW V^H D b
            return sqw[:, None] * (v.conj().T @ (d[:, None] * b))

        def sandwich(m_in):  # H^H m_in H = D V SW m_in SW V^H D
            t = v @ (sqw[:, None] * m_in * sqw[None, :]) @ v.conj().T
            return d[:, None] * t * d[None, :]

        rank_out = jnp.sum(keep.astype(jnp.int32))
    else:
        raise ValueError(f"unknown solver {method!r}")

    if refine:
        # P = sum_{j=0..refine} (I - S0 A)^j, built once at O(nip^3);
        # S_refined = P S0 and S_r M S_r = P (S0 M S0) P^H
        g = gmat()
        p = jnp.eye(a.shape[-1], dtype=a.dtype)
        term = p
        for _ in range(refine):
            term = term @ g
            p = p + term

        def finish(m_in):
            w0 = sandwich(m_in)
            return p @ w0 @ p.conj().T
    else:
        def finish(m_in):
            return sandwich(m_in)

    return half, finish, rank_out


def fitting_operator(a, method="lstsq", rcond=1e-10, rank=None,
                     precondition=True, refine=None):
    """Hermitian solve operator for the fitting normal matrix; dispatches
    over the reference's solver variants like :func:`solve_fitting` but
    returns (apply, rank) so callers can exploit operator structure — the
    metric-side w_q assembly applies it to nip x nip matrices instead of the
    nip x ngrid RHS (isdf.kpoint._sector_wq)."""
    if method in ("lstsq", "pinv", "eigh"):
        return hermitian_operator(a, rcond=rcond, rank=rank,
                                  precondition=precondition, refine=refine)
    if method == "svd":
        # SVD of a hermitian PSD matrix == eigh; the reference's variant
        # truncates the raw (unpreconditioned) spectrum and does not refine
        return hermitian_operator(a, rcond=rcond, rank=rank,
                                  precondition=False, refine=0)
    if method == "ridge":
        return ridge_operator(a, rcond=rcond, refine=refine)
    raise ValueError(f"unknown solver {method!r}")


def solve_fitting(a, b, method="lstsq", rcond=1e-10, rank=None,
                  precondition=True, refine=None):
    """Dispatch over the reference's solver variants; all device-native.

    a: (nip, nip) hermitian PSD; b: (nip, m).  Returns (z, rank).
    """
    apply_inv, rank_out = fitting_operator(
        a, method=method, rcond=rcond, rank=rank,
        precondition=precondition, refine=refine)
    return apply_inv(b), rank_out


def whiten_basis(x_k, x4_k, rcond=1e-10):
    """SVD-whitening variant: rotate interpolation vectors into the
    eigenbasis of x4 so downstream solves become diagonal scalings
    (ref ``fftdf-with-k-svd-backup.py:84-105``).

    x_k: (nk, nip, nao); x4_k: (nk, nip, nip).
    Returns (x_rot (nk, nip, nao), scale (nk, nip)): the fitting solve for
    sector q is then ``z_q = scale[q][:, None] * y_rot_q^T``.
    """
    w, v = jnp.linalg.eigh(x4_k)  # batched over k
    keep = w > rcond * jnp.max(w, axis=-1, keepdims=True)
    winv = jnp.where(keep, 1.0 / jnp.where(keep, w, 1.0), 0.0)
    x_rot = jnp.einsum("kIm,kIJ->kJm", x_k, v.conj())
    return x_rot, winv
