"""Device-resident SCF driver parity gates (CPU f64; the point of the
driver is avoiding host<->device transfers, but its *numbers* must match
the host driver exactly at convergence)."""
import numpy as np
import jax.numpy as jnp
import pytest

from fftisdf_tpu.lattice import structure
from fftisdf_tpu.isdf import FFTISDF
from fftisdf_tpu.scf import KRHF, KUHF
from fftisdf_tpu.scf.device import DeviceKRHF, DeviceKUHF


@pytest.fixture(scope="module")
def diamond_df():
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0).build()
    return cell, kpts, df


def test_device_krhf_matches_host(diamond_df):
    cell, kpts, df = diamond_df
    e0 = KRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10).kernel()
    mf = DeviceKRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
                    max_cycle=60)
    e1 = mf.kernel()
    assert mf.converged
    np.testing.assert_allclose(e1, e0, atol=3e-8)


def test_device_kuhf_smeared_matches_host(diamond_df):
    cell, kpts, df = diamond_df
    mf0 = KUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
               smearing=5e-3)
    e0 = mf0.kernel()
    mf1 = DeviceKUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
                     smearing=5e-3, max_cycle=60)
    e1 = mf1.kernel()
    assert mf0.converged and mf1.converged
    np.testing.assert_allclose(e1, e0, atol=3e-8)
    # entropy/free energy agree too
    np.testing.assert_allclose(mf1.e_free, mf0.e_free, atol=3e-8)


def test_device_dropped_overlap_directions():
    """Regression: with near-dependent basis functions some overlap
    directions are dropped; the penalized eigenvalues sort to the TOP of the
    spectrum, so occupation masks must key on eigenvalue magnitude, not on
    column position (the bug put zero occupation on the lowest orbitals)."""
    from fftisdf_tpu.lattice.cell import Cell, Shell

    # two nearly identical s shells per atom -> near-singular overlap
    shells = [Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4], [0.7]])),
              Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4 * (1 + 1e-7)], [0.7]]))]
    cell = Cell(
        a=np.diag([8.0, 8.0, 8.0]),
        atom=[("He", np.full(3, 4.0)),
              ("He", np.array([4.0, 4.0, 6.5]))],
        basis={"He": shells},
        pseudo=None,
        mesh=np.array([16] * 3),
        unit="bohr",
        precision=1e-12,
    ).build()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0).build()
    cutoff = 1e-4  # forces the near-null directions to be dropped
    from fftisdf_tpu.scf.device import orth_and_penalty

    mf0 = KRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
               ovlp_cutoff=cutoff)
    _, pen = orth_and_penalty(mf0.s1e, cutoff)
    assert (pen > 0).any(), "fixture no longer drops any direction"
    e0 = mf0.kernel()
    mf1 = DeviceKRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
                     ovlp_cutoff=cutoff, max_cycle=60)
    e1 = mf1.kernel()
    assert mf0.converged and mf1.converged
    np.testing.assert_allclose(e1, e0, atol=1e-7)
    # smeared variant drops directions too
    mf2 = DeviceKRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
                     ovlp_cutoff=cutoff, smearing=1e-3, max_cycle=60)
    e2 = mf2.kernel()
    assert mf2.converged
    np.testing.assert_allclose(e2, e0, atol=1e-6)


def test_device_kuhf_bias_symmetry_breaking():
    """Stretched H2 with the on-site bias: the device driver reproduces the
    host driver's broken-symmetry solution."""
    from fftisdf_tpu.lattice.cell import Cell, Shell

    cell = Cell(
        a=np.diag([10.0, 10.0, 14.0]),
        atom=[("H", (5.0, 5.0, 5.0)), ("H", (5.0, 5.0, 9.0))],
        basis={"H": [Shell(l=0, exps=np.array([1.0, 0.35]),
                           coeffs=np.eye(2))]},
        pseudo="gth-pade",
        mesh=np.array([24, 24, 32]),
        unit="bohr",
        precision=1e-12,
    ).build()
    kpts = np.zeros((1, 3))
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 11), verbose=0).build()
    mf0 = KUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-9,
               init_spin={0: +1.0, 1: -1.0}, spin_bias=0.5, bias_cycles=4)
    e0 = mf0.kernel()
    mf1 = DeviceKUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-9,
                     init_spin={0: +1.0, 1: -1.0}, spin_bias=0.5,
                     bias_cycles=4, max_cycle=60)
    e1 = mf1.kernel()
    assert mf0.converged and mf1.converged
    np.testing.assert_allclose(e1, e0, atol=1e-7)
    # moments broke symmetry the same way
    pop = np.real(np.einsum("skmn,knm->sm", mf1.dm, mf1.s1e))
    m0 = pop[0, :2].sum() - pop[1, :2].sum()
    assert abs(m0) > 0.8
