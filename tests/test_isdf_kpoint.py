"""k-point FFT-ISDF gates against the exact plane-wave oracle.

Mirrors the reference's validation strategy (SURVEY.md section 4):
- full-rank ISDF reproduces exact ERIs to 1e-10 (ref isdf.py:154-164),
- compressed ISDF reproduces ERIs to 1e-4 over momentum-conserving
  quadruples (ref fftdf-with-k.py:235-237),
- ISDF vj/vk match exact plane-wave vj/vk (ref fftisdf.py:441-473),
- the solver variants agree with each other,
- save/load round-trip.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from fftisdf_tpu.lattice.cell import Cell
from fftisdf_tpu.basis.eval import eval_ao_kpts
from fftisdf_tpu.isdf import FFTISDF
from fftisdf_tpu.pw import get_eri_from_ao, get_jk_kpts
from fftisdf_tpu.lattice import kpoints as kpt_mod


@pytest.fixture(scope="module")
def he2():
    cell = Cell(
        a=np.diag([5.0, 5.0, 7.0]),
        atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
        basis="sto-3g",
        pseudo=None,
        mesh=np.array([15, 15, 21]),
        unit="bohr",
        precision=1e-12,
    ).build()
    kpts = cell.get_kpts([1, 1, 2])
    coords = cell.gen_uniform_grids()
    ao = np.asarray(eval_ao_kpts(cell, coords, kpts))
    return cell, kpts, coords, ao


@pytest.fixture(scope="module")
def he2_isdf_full(he2):
    cell, kpts, coords, ao = he2
    # selection on the full grid, nip >> pair-space rank, tight tolerances ->
    # exact fit (the reference's exactness regime: isdf.py:45 tol=1e-20)
    df = FFTISDF(cell, kpts, c0=50.0, m0=tuple(cell.mesh), verbose=0,
                 select_tol=1e-20, rcond=1e-13)
    return df.build()


def trs_dm(cell, kpts, nao, seed=0, nset=1):
    """Random hermitian density matrices with time-reversal symmetry
    dm[-k] = conj(dm[k]) (the physical condition the K stripe trick needs)."""
    rng = np.random.default_rng(seed)
    nk = len(kpts)
    s = cell.get_scaled_kpts(kpts)
    dm = rng.standard_normal((nset, nk, nao, nao)) \
        + 1j * rng.standard_normal((nset, nk, nao, nao))
    dm = dm + dm.conj().transpose(0, 1, 3, 2)
    for k in range(nk):
        km = kpt_mod.member(-s[k], s)
        if km < k:
            continue
        avg = (dm[:, k] + dm[:, km].conj()) / 2
        dm[:, k] = avg
        dm[:, km] = avg.conj()
    return dm


def test_full_rank_eri_exact(he2, he2_isdf_full):
    cell, kpts, coords, ao = he2
    df = he2_isdf_full
    k2c = df.kconserv2()
    k3c = df.kconserv3()
    nk = len(kpts)
    for k1 in range(nk):
        for k2 in range(nk):
            for k3 in range(nk):
                k4 = k3c[k1, k2, k3]
                q = kpts[k2] - kpts[k1]
                eri_ref = np.asarray(get_eri_from_ao(
                    cell, (ao[k1], ao[k2], ao[k3], ao[k4]), q, coords))
                eri_sol = np.asarray(df.get_eri((k1, k2, k3, k4)))
                err = abs(eri_sol - eri_ref).max()
                assert err < 1e-10, f"({k1},{k2},{k3},{k4}): {err:.2e}"


def test_full_rank_jk_exact(he2, he2_isdf_full):
    cell, kpts, coords, ao = he2
    df = he2_isdf_full
    nao = ao.shape[2]
    dm = trs_dm(cell, kpts, nao)
    vj_ref, vk_ref = get_jk_kpts(cell, jnp.asarray(dm[0]), jnp.asarray(ao), kpts)
    vj, vk = df.get_jk(dm[0])
    assert abs(np.asarray(vj) - np.asarray(vj_ref)).max() < 1e-9
    assert abs(np.asarray(vk) - np.asarray(vk_ref)).max() < 1e-9


def test_compressed_eri_gate(he2):
    """ALL nk^3 momentum-conserving quadruples, exactly like the reference's
    validation loop (fftdf-with-k.py:218-235), at its 1e-4 gate."""
    cell, kpts, coords, ao = he2
    # compressed: parent grid + modest c0; gate at the reference's 1e-4
    df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 13), verbose=0).build()
    k3c = df.kconserv3()
    nk = len(kpts)
    for k1 in range(nk):
        for k2 in range(nk):
            for k3 in range(nk):
                k4 = k3c[k1, k2, k3]
                q = kpts[k2] - kpts[k1]
                eri_ref = np.asarray(get_eri_from_ao(
                    cell, (ao[k1], ao[k2], ao[k3], ao[k4]), q, coords))
                eri_sol = np.asarray(df.get_eri((k1, k2, k3, k4)))
                err = abs(eri_sol - eri_ref).max()
                assert err < 1e-4, f"({k1},{k2},{k3},{k4}): {err:.2e}"


@pytest.mark.slow
def test_compressed_eri_gate_diamond_dzvp():
    """Compressed-ERI gate on diamond gth-dzvp — a basis with d functions,
    matching the reference's lstsq-driver fixture (fftdf-with-k-lstsq.py:
    191-210); sweeps all nk^3 quadruples at the 1e-4 gate."""
    from fftisdf_tpu.lattice import structure

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-dzvp",
                             pseudo="gth-pade", ke_cutoff=40.0)
    kpts = cell.get_kpts([1, 1, 2])
    coords = cell.gen_uniform_grids()
    ao = np.asarray(eval_ao_kpts(cell, coords, kpts))
    df = FFTISDF(cell, kpts, c0=20.0, verbose=0).build()
    k3c = df.kconserv3()
    nk = len(kpts)
    scale = None
    for k1 in range(nk):
        for k2 in range(nk):
            for k3 in range(nk):
                k4 = k3c[k1, k2, k3]
                q = kpts[k2] - kpts[k1]
                eri_ref = np.asarray(get_eri_from_ao(
                    cell, (ao[k1], ao[k2], ao[k3], ao[k4]), q, coords))
                if scale is None:
                    scale = abs(eri_ref).max()
                eri_sol = np.asarray(df.get_eri((k1, k2, k3, k4)))
                err = abs(eri_sol - eri_ref).max()
                assert err < 1e-4 * max(1.0, scale), \
                    f"({k1},{k2},{k3},{k4}): {err:.2e}"


def test_solver_variants_agree(he2):
    # compare the physical output (ERIs), not w_q: components of w in the
    # near-null space of the fit are solver-dependent but contract to zero
    # against the pair functions
    cell, kpts, coords, ao = he2
    eris = {}
    for solver in ("lstsq", "pinv", "svd"):
        df = FFTISDF(cell, kpts, c0=8.0, m0=(9, 9, 13), solver=solver,
                     verbose=0).build()
        eris[solver] = np.asarray(df.get_eri((0, 1, 1, 0)))
    np.testing.assert_allclose(eris["lstsq"], eris["pinv"], atol=1e-10)
    np.testing.assert_allclose(eris["lstsq"], eris["svd"], atol=1e-6)


def test_save_load_roundtrip(tmp_path, he2, he2_isdf_full):
    cell, kpts, coords, ao = he2
    df = he2_isdf_full
    path = tmp_path / "isdf_state.npz"
    df.save(path)
    df2 = FFTISDF.load(path, cell, kpts)
    dm = trs_dm(cell, kpts, ao.shape[2])
    vj1, vk1 = df.get_jk(dm[0])
    vj2, vk2 = df2.get_jk(dm[0])
    np.testing.assert_allclose(np.asarray(vj1), np.asarray(vj2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(vk1), np.asarray(vk2), atol=1e-12)


def test_nonconserving_quadruple_raises(he2, he2_isdf_full):
    df = he2_isdf_full
    k3c = df.kconserv3()
    # find a non-conserving quadruple
    if k3c[0, 1, 0] != 0:
        with pytest.raises(AssertionError):
            df.get_eri((0, 1, 0, 0))


def test_chunked_build_matches_monolithic(he2):
    """A max_memory_gb budget small enough to force multi-chunk sweeps and
    the minimum grid block reproduces the single-chunk build (the streaming
    pipeline's accumulation order is the only difference — pure roundoff)."""
    cell, kpts, coords, ao = he2
    kpts3 = cell.get_kpts([1, 1, 3])
    kw = dict(c0=8.0, m0=(9, 9, 13), verbose=0)
    df1 = FFTISDF(cell, kpts3, **kw).build()
    per_sector_gb = (np.prod(cell.mesh) * df1.nip * 16) / 1e9
    df2 = FFTISDF(cell, kpts3, max_memory_gb=3 * per_sector_gb,
                  blksize=512, **kw).build()
    assert df2._nchunks > 1
    dm = trs_dm(cell, kpts3, df1.x_k.shape[2])[0]
    vj1, vk1 = df1.get_jk(dm)
    vj2, vk2 = df2.get_jk(dm)
    np.testing.assert_allclose(np.asarray(vj1), np.asarray(vj2), atol=1e-8)
    np.testing.assert_allclose(np.asarray(vk1), np.asarray(vk2), atol=1e-8)


def test_k_serve_fft_matches_phase(he2):
    """The FFT serve path (precomputed image-space metric ws + k-axis FFT
    transforms, isdf.jk.get_k_kpts_img) is algebraically identical to the
    dense phase-matrix contraction (get_k_kpts), on a non-trivial 3D k-mesh
    (1x3x2: two FFT axes, odd length on one)."""
    import jax
    from fftisdf_tpu.isdf import jk as jk_mod

    cell, kpts, coords, ao = he2
    kpts6 = cell.get_kpts([1, 3, 2])
    df = FFTISDF(cell, kpts6, c0=8.0, m0=(9, 9, 13), verbose=0).build()
    dm = jnp.asarray(trs_dm(cell, kpts6, df.x_k.shape[2], nset=2))
    phase = jnp.asarray(df.phase, dtype=df.wq.dtype)
    vk_phase = jk_mod.get_k_kpts(df.x_k, df.wq, phase, dm)
    kmesh = tuple(int(m) for m in df.kmesh)
    ws = jk_mod.wq_to_ws(df.wq, kmesh)
    # ws is exactly the real part of the phase contraction
    ws_ref = np.einsum("Rq,qIJ->RIJ", np.asarray(df.phase),
                       np.asarray(df.wq)).real * np.sqrt(len(kpts6))
    np.testing.assert_allclose(np.asarray(ws), ws_ref, atol=1e-10)
    vk_fft = jk_mod.get_k_kpts_img(df.x_k, ws, dm, kmesh)
    np.testing.assert_allclose(np.asarray(vk_fft), np.asarray(vk_phase),
                               atol=1e-10)


def test_trs_sector_mirroring(he2):
    """Builds with and without the w_{-q} = conj(w_q) shortcut agree; needs a
    k-mesh with non-self-conjugate sectors (1x1x3: q=1,2 mirror)."""
    cell, kpts, coords, ao = he2
    kpts3 = cell.get_kpts([1, 1, 3])
    df1 = FFTISDF(cell, kpts3, c0=8.0, m0=(9, 9, 13), verbose=0,
                  use_trs=True).build()
    df2 = FFTISDF(cell, kpts3, c0=8.0, m0=(9, 9, 13), verbose=0,
                  use_trs=False).build()
    # compare physical outputs (w_q near-null components are solve-path
    # dependent); every sector participates in K
    dm = trs_dm(cell, kpts3, df1.x_k.shape[2])[0]
    vj1, vk1 = df1.get_jk(dm)
    vj2, vk2 = df2.get_jk(dm)
    # agreement limited by eps/rcond path-dependence in the truncated solve
    # (~1e-6 at f64/rcond=1e-10), far below the 1e-4 compression error
    np.testing.assert_allclose(np.asarray(vj1), np.asarray(vj2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(vk1), np.asarray(vk2), atol=1e-6)
    k3c = df1.kconserv3()
    k4 = k3c[0, 1, 2]
    e1 = np.asarray(df1.get_eri((0, 1, 2, k4)))
    e2 = np.asarray(df2.get_eri((0, 1, 2, k4)))
    np.testing.assert_allclose(e1, e2, atol=1e-6)


def test_host_selection_trs_scatter(he2):
    """The host-f64 selection's TRS halving + conjugate scatter (the f32
    production selection path) returns x_k equal to direct full-k AO
    evaluation at the selected points — on a PAIRED mesh (1x1x3: k=1,2 are
    conjugate partners), where the scatter branch actually executes
    (advisor round-4 medium finding: this path had no gate)."""
    from fftisdf_tpu.isdf.kpoint import select_interpolation_points
    from fftisdf_tpu.basis.eval import eval_ao_numpy

    cell, kpts, coords, ao = he2
    kpts3 = cell.get_kpts([1, 1, 3])
    m0 = (9, 9, 13)
    x_t, mask, rank, _ = select_interpolation_points(
        cell, kpts3, m0, 6.0, dtype=jnp.float32, host_f64=True,
        use_trs=True)
    mask = np.asarray(mask)
    # the 1x1x3 mesh really exercises the scatter: k=1,2 are partners, so
    # the canonical half is shorter than nk (pivot SETS are not compared —
    # on an exact-rank pool the tail order is roundoff-tie dependent)
    # scatter vs direct full-k evaluation at the selected points, to
    # storage (complex64) precision
    coords0 = cell.gen_uniform_grids(m0)
    x_ref = eval_ao_numpy(cell, coords0, np.asarray(kpts3))[:, mask]
    scale = max(1.0, np.abs(x_ref).max())
    assert np.max(np.abs(np.asarray(x_t) - x_ref)) < 2e-7 * scale
    # and the TRS-free oracle evaluated at the SAME points agrees (the
    # halving changes summation order, not values)
    x_f, mask_f, _, _ = select_interpolation_points(
        cell, kpts3, m0, 6.0, dtype=jnp.float32, host_f64=True,
        use_trs=False)
    x_ref_f = eval_ao_numpy(cell, coords0,
                            np.asarray(kpts3))[:, np.asarray(mask_f)]
    assert np.max(np.abs(np.asarray(x_f) - x_ref_f)) < 2e-7 * scale


# ---------------------------------------------------------------------------
# Selection-mesh mechanism (round-4): cutoff-derived auto m0, auto-densify
# on pool saturation, and the saturation warning contract.

def test_auto_selection_mesh_contract(he2):
    """auto mode: floor respected, pool target monotone, k0 = the reference
    lstsq knob (fftdf-with-k-lstsq.py:32 cutoff_to_mesh(lv, k0))."""
    from fftisdf_tpu.isdf.kpoint import auto_selection_mesh

    cell, kpts, _, _ = he2
    # tiny target: the floor (reference default mesh) wins
    assert auto_selection_mesh(cell, 10) == (15, 15, 15)
    # large target: pool >= pool_factor * target, floor exceeded
    m_big = auto_selection_mesh(cell, 4000)
    assert np.prod(m_big) >= 2.5 * 4000
    assert all(b >= 15 for b in m_big)
    # monotone in the target
    m_sm = auto_selection_mesh(cell, 2000)
    assert np.prod(m_sm) <= np.prod(m_big)
    # anisotropy follows the lattice (he2 cell is 5 x 5 x 7 bohr: the long
    # axis carries proportionally more points)
    assert m_big[2] > m_big[0] == m_big[1]
    # explicit k0: exactly the cutoff-derived mesh, no floor
    assert auto_selection_mesh(cell, 0, k0=5.0) == tuple(
        int(v) for v in cell.cutoff_to_mesh(5.0))


def test_auto_densify_on_saturation(he2):
    """A starved starting pool (m0_floor (3,3,4): 36 candidates for a
    requested nip of 10*nao=20 on sto-3g He2) must densify itself until the
    detector clears, and df.m0 must record the mesh the mask indexes."""
    from fftisdf_tpu.isdf import jk as jk_mod

    cell, kpts, coords, ao = he2
    df = FFTISDF(cell, kpts, c0=10.0, m0="auto", m0_floor=(3, 3, 4),
                 verbose=0)
    m0_start = df.m0
    df.build()
    # served J/K finite and sane vs the exact oracle (loose: tiny pool)
    dm = trs_dm(cell, kpts, df.x_k.shape[2])[0]
    vj, vk = df.get_jk(dm)
    assert np.isfinite(np.asarray(vj)).all()
    # the recorded m0 is the FINAL mesh (mask must index into its grid)
    assert np.prod(df.m0) > int(np.asarray(df.mask).max())
    if df.m0 != m0_start:
        assert np.prod(df.m0) > np.prod(m0_start)


def test_pool_saturation_warning(he2):
    """Explicit (reference-parity) m0 keeps the legacy contract: one
    PoolSaturationWarning when the pool caps the requested compression."""
    import warnings as _w
    from fftisdf_tpu.isdf.kpoint import (PoolSaturationWarning,
                                         select_interpolation_points,
                                         _saturation_warned)

    cell, kpts, _, _ = he2
    _saturation_warned.clear()
    with pytest.warns(PoolSaturationWarning):
        select_interpolation_points(cell, kpts, (3, 3, 4), 10.0)
    # deduplicated: the same config warns once per process
    with _w.catch_warnings():
        _w.simplefilter("error", PoolSaturationWarning)
        select_interpolation_points(cell, kpts, (3, 3, 4), 10.0)
    _saturation_warned.clear()


def test_densify_respects_host_guard(he2, monkeypatch):
    """Auto-densify must never push the pool past the f64 host-selection
    guard on f32 devices: a pool the f32 device path orders is WORSE than
    a smaller f64-ordered one (measured on NiO: 300x worse energy)."""
    from fftisdf_tpu.isdf import kpoint as kp

    cell, kpts, _, _ = he2
    monkeypatch.setattr(kp, "HOST_SELECT_MAX_NG0", 80)
    x_k, mask, rank, m0 = kp.select_interpolation_points(
        cell, kpts, (3, 3, 4), 10.0, dtype=jnp.float32, auto_densify=True)
    # (3,3,4)=36 candidates saturate, but the next step (4,4,6)=96 would
    # cross the guard -> selection stays on the f64-ordered 36-point pool
    assert m0 == (3, 3, 4)


def test_select_keep_trims_near_null(he2):
    """select_keep trims pivots whose Schur diagonal sits below the
    relative floor; at pool rank exhaustion (c0 past the pair-space
    rank) the trimmed build still serves accurate J/K — the untrimmed
    near-null directions are what ill-conditions the fit (round-5 bench:
    vk blow-up to 3.7e3 at the dzvp c0=60/auto point)."""
    cell, kpts, coords, ao = he2
    # c0 huge: nip saturates at the pool rank, tail pivots are near-null
    df_all = FFTISDF(cell, kpts, c0=1e5, m0=(5, 5, 7), verbose=0).build()
    df_trim = FFTISDF(cell, kpts, c0=1e5, m0=(5, 5, 7), verbose=0,
                      select_keep=1e-9).build()
    assert df_trim.nip < df_all.nip
    dm = trs_dm(cell, kpts, df_all.x_k.shape[2])[0]
    vj_t, vk_t = df_trim.get_jk(dm)
    # oracle: exact plane-wave J/K
    from fftisdf_tpu.pw import get_jk_kpts
    vj_e, vk_e = get_jk_kpts(cell, np.asarray(dm), ao, kpts)
    sj = np.abs(np.asarray(vj_e)).max()
    assert np.abs(np.asarray(vj_t) - np.asarray(vj_e)).max() < 1e-5 * max(sj, 1)
    sk = np.abs(np.asarray(vk_e)).max()
    assert np.abs(np.asarray(vk_t) - np.asarray(vk_e)).max() < 1e-5 * max(sk, 1)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape", [(1, 64, 5), (3, 100, 7), (2, 300, 4),
                                   (16, 96, 40)])
def test_pair_gram_sq_matches_numpy(shape, dtype):
    """Device-selection gram vs a complex128 numpy reference."""
    from fftisdf_tpu.isdf.kpoint import pair_gram_sq

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(dtype)
    xr = x.astype(np.complex128)
    g = np.einsum("kgm,khm->gh", xr.conj(), xr).real
    ref = g * g / shape[0]
    out = np.asarray(pair_gram_sq(jnp.asarray(x)))
    assert out.shape == (shape[1], shape[1])
    assert out.dtype == (np.float32 if dtype == np.complex64 else np.float64)
    tol = 2e-5 if dtype == np.complex64 else 1e-12
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max())
