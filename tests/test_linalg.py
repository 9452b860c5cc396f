import numpy as np
import jax.numpy as jnp

from fftisdf_tpu.linalg import pivoted_cholesky, fft3, ifft3, get_coulG, solve_fitting
from fftisdf_tpu.linalg.solvers import whiten_basis


def random_psd(n, rank, seed=0, cplx=False):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((rank, n))
    if cplx:
        b = b + 1j * rng.standard_normal((rank, n))
    return b.conj().T @ b


def test_pivoted_cholesky_full_rank():
    a = random_psd(30, 30, cplx=True)
    L, piv, rank, hist = pivoted_cholesky(a)
    L, piv, rank = np.asarray(L), np.asarray(piv), int(rank)
    assert rank == 30
    # reconstruction: a == L^H L (rows in original order)
    np.testing.assert_allclose(L.conj().T @ L, a, atol=1e-9)
    # pivot magnitudes decreasing
    hist = np.asarray(hist)
    assert (np.diff(hist) <= 1e-9).all()


def test_pivoted_cholesky_low_rank():
    a = random_psd(40, 7)
    L, piv, rank, hist = pivoted_cholesky(a, tol=1e-10)
    assert int(rank) == 7
    np.testing.assert_allclose(
        np.asarray(L[:7]).conj().T @ np.asarray(L[:7]), a, atol=1e-8
    )
    # pivots are distinct
    piv = np.asarray(piv[:7])
    assert len(set(piv.tolist())) == 7


def test_pivoted_cholesky_max_rank_cap():
    a = random_psd(25, 25)
    L, piv, rank, hist = pivoted_cholesky(a, max_rank=10)
    assert L.shape == (10, 25)
    assert int(rank) == 10


def test_fft3_roundtrip_and_planewave():
    mesh = (4, 5, 6)
    n = np.prod(mesh)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    y = ifft3(fft3(jnp.asarray(x), mesh), mesh)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-12)
    # delta function -> constant spectrum
    d = np.zeros(n)
    d[0] = 1.0
    np.testing.assert_allclose(np.asarray(fft3(jnp.asarray(d + 0j), mesh)), 1.0)


def test_coulG_basic():
    from fftisdf_tpu.lattice.cell import Cell

    cell = Cell(a=np.eye(3) * 5.0, atom=[("He", (0, 0, 0))], basis="sto-3g",
                pseudo=None, mesh=np.array([4, 4, 4]), unit="bohr").build()
    cg = np.asarray(get_coulG(cell))
    assert cg[0] == 0.0  # G=0 zeroed (exxdiv=None)
    gv = cell.get_Gv()
    absG2 = np.einsum("gi,gi->g", gv, gv)
    np.testing.assert_allclose(cg[1:], 4 * np.pi / absG2[1:], atol=1e-12)
    # shifted kernel has no zero entries for q inside the BZ
    q = cell.reciprocal_vectors()[0] / 4
    cgq = np.asarray(get_coulG(cell, q=q))
    assert (cgq > 0).all()


def test_solve_fitting_variants():
    rng = np.random.default_rng(2)
    a = random_psd(20, 20, cplx=True)
    b = rng.standard_normal((20, 7)) + 1j * rng.standard_normal((20, 7))
    z_ref = np.linalg.solve(a, b)
    for method in ("lstsq", "pinv", "svd"):
        z, rank = solve_fitting(jnp.asarray(a), jnp.asarray(b), method=method)
        np.testing.assert_allclose(np.asarray(z), z_ref, atol=1e-8,
                                   err_msg=method)
        assert int(rank) == 20


def test_solve_fitting_singular():
    # rank-deficient system: residual-consistent solutions; the
    # unpreconditioned eigh solve reproduces the SVD minimum-norm solution
    a = random_psd(15, 6, cplx=True)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((15, 2)) + 1j * rng.standard_normal((15, 2))
    b = a @ x0
    z1, r1 = solve_fitting(jnp.asarray(a), jnp.asarray(b), method="lstsq",
                           rcond=1e-10, precondition=False)
    z1p, r1p = solve_fitting(jnp.asarray(a), jnp.asarray(b), method="lstsq",
                             rcond=1e-10)
    z2, r2 = solve_fitting(jnp.asarray(a), jnp.asarray(b), method="svd",
                           rcond=1e-10)
    assert int(r1) == 6 and int(r2) == 6 and int(r1p) == 6
    np.testing.assert_allclose(np.asarray(a @ z1), np.asarray(b), atol=1e-8)
    np.testing.assert_allclose(np.asarray(a @ z1p), np.asarray(b), atol=1e-8)
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z2), atol=1e-8)


def test_fitting_half_operator_identity():
    """w = S (B K B^H) S assembled through the split operator S = H^H H
    (half/finish) must match the solve-then-contract path z = S B,
    w = z K z^H — including the refinement polynomial — on an
    ill-conditioned PSD matrix (the cond(A)^2-amplification regression that
    motivated the half form; see isdf.kpoint._sector_wq)."""
    from fftisdf_tpu.linalg.solvers import fitting_operator, fitting_half_operator

    rng = np.random.default_rng(0)
    n, m = 40, 90
    x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    u = np.linalg.qr(x)[0]
    a = (u * 10.0 ** rng.uniform(-12, 0, n)) @ u.conj().T
    b = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    kdiag = rng.uniform(0, 2, m)

    for method, refine in (("ridge", 0), ("ridge", 1), ("ridge", 2),
                           ("lstsq", 0), ("svd", 0)):
        ap, rk = fitting_operator(jnp.asarray(a), method=method, rcond=1e-8,
                                  refine=refine)
        z = np.asarray(ap(jnp.asarray(b)))
        w_ref = (z * kdiag) @ z.conj().T
        half, finish, rk2 = fitting_half_operator(
            jnp.asarray(a), method=method, rcond=1e-8, refine=refine)
        g = np.asarray(half(jnp.asarray(b)))
        w_new = np.asarray(finish(jnp.asarray((g * kdiag) @ g.conj().T)))
        scale = abs(w_ref).max()
        # identical operators; rounding differs at ~eps * cond^(1/2)
        assert abs(w_new - w_ref).max() < 3e-7 * scale, (method, refine)
        assert int(rk) == int(rk2)


def test_whiten_basis():
    # whitened solve == direct solve of x4 z = y
    rng = np.random.default_rng(4)
    nk, nip, nao = 3, 10, 4
    x_k = rng.standard_normal((nk, nip, nao)) + 1j * rng.standard_normal((nk, nip, nao))
    x4 = np.stack([random_psd(nip, nip, seed=s, cplx=True) for s in range(nk)])
    x_rot, winv = whiten_basis(jnp.asarray(x_k), jnp.asarray(x4))
    # check the rotation diagonalizes: v^H x4 v = diag(w)
    y = rng.standard_normal((nk, nip, 5)) + 1j * rng.standard_normal((nk, nip, 5))
    for q in range(nk):
        z_ref = np.linalg.solve(x4[q], y[q])
        # whitened: z_rot = winv * (v^H y); back-rotate via v
        w, v = np.linalg.eigh(x4[q])
        z_rot = np.asarray(winv[q])[:, None] * (v.conj().T @ y[q])
        np.testing.assert_allclose(v @ z_rot, z_ref, atol=1e-8)


def test_pivoted_cholesky_np_matches_jax():
    from fftisdf_tpu.linalg.pivoted_cholesky import pivoted_cholesky_np

    a = random_psd(40, 12, seed=7)
    L1, p1, r1, h1 = pivoted_cholesky(jnp.asarray(a), max_rank=20)
    L2, p2, r2, h2 = pivoted_cholesky_np(a, max_rank=20)
    assert int(r1) == r2
    assert np.array_equal(np.asarray(p1)[:r2], p2[:r2])
    np.testing.assert_allclose(np.asarray(h1)[:r2], h2[:r2], rtol=1e-10)


def test_ridge_factor_survives_indefinite_f32_gram():
    """PSD guard: an f32 gram whose eigenvalue noise floor sits below
    -rcond (observed on an accelerator at heavy compression: backend accumulation
    order tips the scaled quartic indefinite and Cholesky returns all-NaN)
    must factor finitely via the adaptive-lambda escalation, keep a
    near-exact solve on the healthy subspace, and stay differentiable."""
    import jax
    from fftisdf_tpu.linalg.solvers import half_factor_data, solve_fitting

    rng = np.random.default_rng(7)
    n = 48
    q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    w = np.linspace(0.3, 2.0, n)
    w[0] = -3e-5                      # below -rcond*diagmax, noise-scale
    a = (q * w) @ q.conj().T
    a32 = jnp.asarray((a + a.conj().T) / 2, dtype=jnp.complex64)
    _, data = half_factor_data(a32, method="ridge", rcond=1e-5, refine=2)
    chol = data[1]
    assert bool(jnp.isfinite(chol.real).all() & jnp.isfinite(chol.imag).all())
    b = jnp.asarray(rng.standard_normal((n, 3))
                    + 1j * rng.standard_normal((n, 3)), dtype=jnp.complex64)
    z, _ = solve_fitting(a32, b, method="ridge", rcond=1e-5)
    res = np.asarray(a32 @ z - b)
    res_h = (q[:, 1:] @ q[:, 1:].conj().T) @ res   # healthy subspace
    # floor: the noise direction carries ~|b|/lam of junk (1e3 at the
    # escalated lam ~ 1e-3), and the f32 matmul of the residual leaks
    # eps * lam_max * |junk| ~ 1e-3 of it into the healthy subspace —
    # the gate is NaN-freeness plus a healthy solve at that leakage scale
    assert np.abs(res_h).max() < 5e-2

    def loss(m):
        return jnp.sum(jnp.abs(solve_fitting(m, b, method="ridge",
                                             rcond=1e-5)[0]) ** 2).real

    g = jax.grad(loss)(a32)
    assert bool(jnp.isfinite(g.real).all() & jnp.isfinite(g.imag).all())


def test_pivoted_cholesky_pairgram_matrix_free():
    """The matrix-free blocked factorization (the round-5 host selection
    engine) reproduces the dense greedy algorithm's pivot SEQUENCE, rank
    and Schur-diagonal history exactly (no symmetry ties in a random
    problem), including on a rank-deficient pair gram."""
    from fftisdf_tpu.linalg.pivoted_cholesky import (
        pivoted_cholesky_np, pivoted_cholesky_pairgram_np)

    rng = np.random.default_rng(7)
    ng0, ncol, nk = 500, 40, 4
    flat = (rng.standard_normal((ng0, ncol))
            + 1j * rng.standard_normal((ng0, ncol)))
    x2 = (flat @ flat.conj().T).real
    x4 = x2 * x2 / nk
    for k in (60, 300):
        _, piv_d, rank_d, hist_d = pivoted_cholesky_np(x4, max_rank=k)
        piv_m, rank_m, hist_m = pivoted_cholesky_pairgram_np(
            flat, nk, k, block=29)
        assert np.array_equal(piv_d[:k], piv_m[:k])
        assert rank_d == rank_m
        np.testing.assert_allclose(hist_m, hist_d,
                                   rtol=1e-12, atol=1e-12 * hist_d.max())
    # rank-deficient: x4 = (Re u u^H)^2 has bounded rank << ng0; the
    # matrix-free rank detection must agree with the dense oracle
    u = (rng.standard_normal((ng0, 7)) + 1j * rng.standard_normal((ng0, 7)))
    x2l = (u @ u.conj().T).real
    _, piv_d, rank_d, hist_d = pivoted_cholesky_np(x2l * x2l / nk,
                                                   max_rank=200)
    piv_m, rank_m, hist_m = pivoted_cholesky_pairgram_np(u, nk, 200)
    assert rank_d == rank_m
    assert np.array_equal(piv_d[:rank_d], piv_m[:rank_d])
