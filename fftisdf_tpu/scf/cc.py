"""k-point CCSD on the ISDF ERI factorization.

Spin-orbital coupled-cluster singles and doubles with full momentum
conservation ("k-blocked" amplitudes), consuming ERIs straight from the
ISDF state (x_k, w_q) — the deepest downstream consumer of the
factorization after KMP2 (scf.mp2) and RPA (scf.rpa).  The reference
repository has no correlated method at all; its furthest gesture in this
direction is the never-finished embedding transform
(``/root/reference/fftisdf.py:230-294``), which scf.isdf.ao2mo completes
and this module builds on.

Design:

- **Spin orbitals** [occ_a, occ_b, vir_a, vir_b] per k-point, so one code
  path serves restricted (KRHF/KRKS) and unrestricted (KUHF/KUKS)
  references — the spin structure enters only through delta masks on the
  integral blocks (and through the per-spin orbitals themselves for UHF).
- **k-blocked amplitudes**: t1[k][i,a] (singles conserve crystal
  momentum), t2[ki,kj,ka][i,j,a,b] with kb = ki + kj - ka fixed by
  conservation; integral blocks U[k1,k2,k3] = <p k1, q k2 || r k3, s k4>
  are assembled per momentum-conserving triple from three matmuls
  each (isdf.eri.assemble_eri via isdf.ao2mo.mo_eri).
- **Complex-safe equations.**  The classic Stanton-Gauss-Watts-Bartlett
  equations (JCP 94, 4334 (1991)) are written for real orbitals, where
  <pq||rs> = <rs||pq> hides conjugation choices.  Bloch orbitals are
  complex; each integral factor here is written in its *vertex-natural*
  index order — internal hole lines in the bra, internal particle lines
  in the ket, external particles in the bra, external holes in the ket —
  where the real-orbital equations and the complex ones coincide.  The
  single term this changes relative to the textbook form is the T2
  driving term, <ab||ij> = conj(<ij||ab>).  Every term (and this claim)
  is gated against a determinant-space oracle that evaluates
  <Phi_ex| e^-T H e^T |Phi_0> literally (Jordan-Wigner operator matrices,
  nilpotent e^T as a finite series) at random complex amplitudes and
  random Hermitian integrals: tests/test_cc.py.
- The whole iteration is one jitted function (trace-time Python loops
  over momentum blocks -> a flat XLA graph of small einsums; the device
  sees the O(nk^4) block contractions back-to-back).  Amplitude DIIS
  reuses the SCF drivers' Pulay machinery (scf.hf.DIIS).

Normalization: assemble_eri returns cell-normalized ERIs; supercell spin
orbitals are Bloch/sqrt(nk), so the supercell integrals are U/nk and the
returned correlation energy is divided by nk once more to be per cell
(verified by the k-mesh vs doubled-supercell consistency gate, the same
duality test scf.mp2 uses).

Scaling note: integral blocks are materialized per k-triple (full
nso^4); at production sizes a slice-resolved assembly (only the o/v
blocks each term needs, vvvv on the fly from the ISDF factors) is the
natural refinement — the factorized form makes that a local change.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fftisdf_tpu.isdf.ao2mo import mo_eri
from fftisdf_tpu.utils.device import to_device, to_host


# ----------------------------------------------------------------------
# spin-orbital setup
# ----------------------------------------------------------------------

def _spinorb_mo(mf):
    """Per-k spin-orbital coefficients (nao, nso), energies (nso,), spin
    labels, and the spin-orbital occupation count.

    Orbital order per k: [occ_alpha, occ_beta, vir_alpha, vir_beta].
    Insulating (integer, k-independent) occupations required.
    """
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    if mo_c.ndim == 3:                      # restricted: same spatial orbs
        mo_c = np.stack([mo_c, mo_c])
        mo_e = np.stack([mo_e, mo_e])
        mo_o = np.stack([mo_o / 2.0, mo_o / 2.0])
    nk = mo_c.shape[1]
    noccs = []
    for s in range(2):
        ns = [int(round(mo_o[s, k].sum())) for k in range(nk)]
        if any(abs(mo_o[s, k].sum() - ns[k]) > 1e-8 for k in range(nk)) \
                or len(set(ns)) != 1:
            raise NotImplementedError(
                "kccsd requires insulating (integer, k-independent) "
                "occupations; got per-k electron counts %s" % (ns,))
        noccs.append(ns[0])
    cs, es, spins = [], [], []
    for k in range(nk):
        cols, ene, sp = [], [], []
        for s in range(2):
            cols.append(mo_c[s, k][:, :noccs[s]])
            ene.append(mo_e[s, k][:noccs[s]])
            sp += [s] * noccs[s]
        for s in range(2):
            cols.append(mo_c[s, k][:, noccs[s]:])
            ene.append(mo_e[s, k][noccs[s]:])
            sp += [s] * (mo_c.shape[3] - noccs[s])
        cs.append(np.concatenate(cols, axis=1))
        es.append(np.concatenate(ene))
        spins.append(np.array(sp))
    return (np.array(cs), np.array(es), np.array(spins),
            noccs[0] + noccs[1])


def make_eris_dev(df, mf):
    """Antisymmetrized spin-orbital integral blocks, DEVICE-resident.

    Returns (U_dev, eo, ev, nocc) with U[k1,k2,k3][p,q,r,s] =
    <p k1, q k2 || r k3, s k4>, k4 = k1 + k2 - k3 (physicists' notation,
    cell normalization), eo/ev the occupied/virtual spin-orbital
    energies per k (host).  Assembly (per momentum triple: two
    three-matmul ERI contractions + spin masks + transposes) stays on
    device end to end — no per-block host round-trips (O(nk^3) complex
    transfers)."""
    cs, es, spins, nocc = _spinorb_mo(mf)
    nk = df.nkpt
    k3c = df.kconserv3()

    def kp(a, b, c):                        # index of k_a + k_b - k_c
        return int(k3c[a, c, b])

    @jax.jit
    def _block(d, x, md, mx):
        d = jnp.transpose(d, (0, 2, 1, 3)) * md    # (p,r,q,s)->(p,q,r,s)
        x = jnp.transpose(x, (0, 2, 3, 1)) * mx    # (p,s,q,r)->(p,q,r,s)
        return d - x

    blocks = []
    for k1 in range(nk):
        b2 = []
        for k2 in range(nk):
            b3 = []
            for k3 in range(nk):
                k4 = kp(k1, k2, k3)
                # direct <pq|rs> = chem (p k1, r k3 | q k2, s k4)
                d = mo_eri(df, (cs[k1], cs[k3], cs[k2], cs[k4]),
                           (k1, k3, k2, k4))
                # exchange <pq|sr> = chem (p k1, s k4 | q k2, r k3)
                x = mo_eri(df, (cs[k1], cs[k4], cs[k2], cs[k3]),
                           (k1, k4, k2, k3))
                md = ((spins[k1][:, None, None, None]
                       == spins[k3][None, None, :, None])
                      & (spins[k2][None, :, None, None]
                         == spins[k4][None, None, None, :]))
                mx = ((spins[k1][:, None, None, None]
                       == spins[k4][None, None, None, :])
                      & (spins[k2][None, :, None, None]
                         == spins[k3][None, None, :, None]))
                b3.append(_block(d, x, jnp.asarray(md), jnp.asarray(mx)))
            b2.append(b3)
        blocks.append(b2)
    U = jax.jit(lambda bs: jnp.stack(
        [jnp.stack([jnp.stack(b3) for b3 in b2]) for b2 in bs]))(blocks)
    return U, es[:, :nocc], es[:, nocc:], nocc


def make_eris(df, mf):
    """Host-array variant of :func:`make_eris_dev` (one bulk device->
    host pull), used by the host-side EOM-QP augmentation and tests."""
    U, eo, ev, nocc = make_eris_dev(df, mf)
    return np.asarray(to_host(U)), eo, ev, nocc


# ----------------------------------------------------------------------
# the CCSD iteration (spin-orbital, k-blocked, complex-safe)
# ----------------------------------------------------------------------

def _equations(nk, nocc, nvir, kp3):
    """Build ``resid(t1, t2, f, U) -> (r1, r2, e)``: the FULL CCSD
    residual R_mu = <Phi_mu| e^-T H e^T |0> (one-body diagonal included;
    at a canonical diagonal fock R = D * (t_new - t) of make_step) plus
    the correlation energy at the input amplitudes.

    ``f = (foo, fov, fvo, fvv)``: per-k one-body blocks passed as
    INDEPENDENT arguments (fvo = fov^dag for a physical Hermitian fock).
    Keeping them separate makes the residual holomorphic in every block,
    so Lagrangian densities come from jax.grad (see lambda_rdm).
    """
    o, v = slice(0, nocc), slice(nocc, nocc + nvir)
    kp3 = np.asarray(kp3)

    def kp(a, b, c):
        return int(kp3[a, b, c])

    def resid(t1, t2, f, U):
        foo, fov, fvo, fvv = f
        t1 = [t1[k] for k in range(nk)]
        ein = jnp.einsum

        def u(k1, k2, k3, s1, s2, s3, s4):
            return U[k1, k2, k3][s1, s2, s3, s4]

        # tau, tau-tilde (t1 contributions are momentum-diagonal)
        tau, tau_t = {}, {}
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    tt = t2[ki, kj, ka]
                    t1t1 = 0.0
                    if ka == ki:
                        t1t1 = t1t1 + ein("ia,jb->ijab", t1[ki], t1[kj])
                    if ka == kj:
                        t1t1 = t1t1 - ein("ib,ja->ijab", t1[ki], t1[kj])
                    tau[ki, kj, ka] = tt + t1t1
                    tau_t[ki, kj, ka] = tt + 0.5 * t1t1

        # ---- F intermediates (momentum-diagonal), full one-body ----
        f_ae, f_mi, f_me = [], [], []
        for k in range(nk):
            ae = fvv[k] - 0.5 * ein("ma,me->ae", t1[k], fov[k])
            mi = foo[k] + 0.5 * ein("ie,me->mi", t1[k], fov[k])
            me = fov[k]
            for km in range(nk):
                ae = ae + ein("mf,mafe->ae", t1[km],
                              u(km, k, km, o, v, v, v))
                mi = mi + ein("ne,mnie->mi", t1[km],
                              u(k, km, k, o, o, o, v))
                me = me + ein("nf,mnef->me", t1[km],
                              u(k, km, k, o, o, v, v))
                for kn in range(nk):
                    ae = ae - 0.5 * ein("mnaf,mnef->ae", tau_t[km, kn, k],
                                        u(km, kn, k, o, o, v, v))
                    mi = mi + 0.5 * ein("inef,mnef->mi", tau_t[k, km, kn],
                                        u(k, km, kn, o, o, v, v))
            f_ae.append(ae)
            f_mi.append(mi)
            f_me.append(me)

        # ---- T1 residual ----
        r1_out = []
        for k in range(nk):
            # driving <Phi_i^a|F|0> = f[a,i] — vertex-natural (vo block)
            r = (fvo[k].T
                 + ein("ie,ae->ia", t1[k], f_ae[k])
                 - ein("ma,mi->ia", t1[k], f_mi[k]))
            for km in range(nk):
                r = r + ein("imae,me->ia", t2[k, km, k], f_me[km])
                r = r - ein("nf,naif->ia", t1[km],
                            u(km, k, k, o, v, o, v))
                for ke in range(nk):
                    r = r - 0.5 * ein("imef,maef->ia", t2[k, km, ke],
                                      u(km, k, ke, o, v, v, v))
                for kn in range(nk):
                    ke = kp(km, kn, k)
                    r = r - 0.5 * ein("mnae,nmei->ia", t2[km, kn, k],
                                      u(kn, km, ke, o, o, v, o))
            r1_out.append(r)

        # ---- W intermediates ----
        # W_mnij, blocks [km,kn,ki] (kj fixed); raw then P_(ij)
        w_oooo_raw = {}
        for km in range(nk):
            for kn in range(nk):
                for ki in range(nk):
                    kj = kp(km, kn, ki)
                    x = ein("je,mnie->mnij", t1[kj],
                            u(km, kn, ki, o, o, o, v))
                    w_oooo_raw[km, kn, ki] = x
        w_oooo = {}
        for km in range(nk):
            for kn in range(nk):
                for ki in range(nk):
                    kj = kp(km, kn, ki)
                    x = (u(km, kn, ki, o, o, o, o)
                         + w_oooo_raw[km, kn, ki]
                         - w_oooo_raw[km, kn, kj].transpose(0, 1, 3, 2))
                    for ke in range(nk):
                        x = x + 0.25 * ein(
                            "ijef,mnef->mnij", tau[ki, kj, ke],
                            u(km, kn, ke, o, o, v, v))
                    w_oooo[km, kn, ki] = x

        # W_abef, blocks [ka,kb,ke] (kf fixed); raw then P_(ab)
        w_vvvv_raw = {}
        for ka in range(nk):
            for kb in range(nk):
                for ke in range(nk):
                    w_vvvv_raw[ka, kb, ke] = ein(
                        "mb,amef->abef", t1[kb],
                        u(ka, kb, ke, v, o, v, v))
        w_vvvv = {}
        for ka in range(nk):
            for kb in range(nk):
                for ke in range(nk):
                    x = (u(ka, kb, ke, v, v, v, v)
                         - w_vvvv_raw[ka, kb, ke]
                         + w_vvvv_raw[kb, ka, ke].transpose(1, 0, 2, 3))
                    for km in range(nk):
                        x = x + 0.25 * ein(
                            "mnab,mnef->abef", tau[km, kp(ka, kb, km), ka],
                            u(km, kp(ka, kb, km), ke, o, o, v, v))
                    w_vvvv[ka, kb, ke] = x

        # W_mbej, blocks [km,kb,ke] (kj fixed)
        w_ovvo = {}
        for km in range(nk):
            for kb in range(nk):
                for ke in range(nk):
                    kj = kp(km, kb, ke)
                    x = (u(km, kb, ke, o, v, v, o)
                         + ein("jf,mbef->mbej", t1[kj],
                               u(km, kb, ke, o, v, v, v))
                         - ein("nb,mnej->mbej", t1[kb],
                               u(km, kb, ke, o, o, v, o))
                         - ein("jf,nb,mnef->mbej", t1[kj], t1[kb],
                               u(km, kb, ke, o, o, v, v)))
                    for kn in range(nk):
                        kf = kp(kj, kn, kb)
                        x = x - 0.5 * ein(
                            "jnfb,mnef->mbej", t2[kj, kn, kf],
                            u(km, kn, ke, o, o, v, v))
                    w_ovvo[km, kb, ke] = x

        # ---- T2 residual: raw pieces by permutational symmetry class ----
        f_be_t = [f_ae[k] - 0.5 * ein("mb,me->be", t1[k], f_me[k])
                  for k in range(nk)]
        f_mj_t = [f_mi[k] + 0.5 * ein("je,me->mj", t1[k], f_me[k])
                  for k in range(nk)]

        raw_ab, raw_ij, raw_ijab = {}, {}, {}
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    kb = kp(ki, kj, ka)
                    # P_(ab) class: + t2_ijae Ftilde_be  + t1_ie <ab||ej>'s
                    # partner is handled in the P_(ij) class; here strictly
                    # the terms antisymmetrized in (ab):
                    x = ein("ijae,be->ijab", t2[ki, kj, ka], f_be_t[kb])
                    x = x - ein("ma,mbij->ijab", t1[ka],
                                u(ka, kb, ki, o, v, o, o))
                    raw_ab[ki, kj, ka] = x
                    # P_(ij) class
                    y = -ein("imab,mj->ijab", t2[ki, kj, ka], f_mj_t[kj])
                    y = y + ein("ie,abej->ijab", t1[ki],
                                u(ka, kb, ki, v, v, v, o))
                    raw_ij[ki, kj, ka] = y
                    # P_(ij)P_(ab) class
                    z = -ein("ie,ma,mbej->ijab", t1[ki], t1[ka],
                             u(ka, kb, ki, o, v, v, o))
                    for km in range(nk):
                        ke = kp(ki, km, ka)
                        z = z + ein("imae,mbej->ijab", t2[ki, km, ka],
                                    w_ovvo[km, kb, ke])
                    raw_ijab[ki, kj, ka] = z

        t2_new = {}
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    kb = kp(ki, kj, ka)
                    # driving term <ab||ij> = conj(<ij||ab>) — the one
                    # complex correction to the textbook equations
                    r = u(ki, kj, ka, o, o, v, v).conj()
                    r = r + (raw_ab[ki, kj, ka]
                             - raw_ab[ki, kj, kb].transpose(0, 1, 3, 2))
                    r = r + (raw_ij[ki, kj, ka]
                             - raw_ij[kj, ki, ka].transpose(1, 0, 2, 3))
                    z = raw_ijab[ki, kj, ka]
                    r = r + (z
                             - raw_ijab[kj, ki, ka].transpose(1, 0, 2, 3)
                             - raw_ijab[ki, kj, kb].transpose(0, 1, 3, 2)
                             + raw_ijab[kj, ki, kb].transpose(1, 0, 3, 2))
                    for km in range(nk):
                        r = r + 0.5 * ein(
                            "mnab,mnij->ijab",
                            tau[km, kp(ki, kj, km), ka],
                            w_oooo[km, kp(ki, kj, km), ki])
                    for ke in range(nk):
                        r = r + 0.5 * ein(
                            "ijef,abef->ijab", tau[ki, kj, ke],
                            w_vvvv[ka, kb, ke])
                    t2_new[ki, kj, ka] = r

        # ---- energy at the INPUT amplitudes ----
        e = jnp.zeros((), U.dtype)
        for ki in range(nk):
            e = e + ein("ia,ia->", fov[ki], t1[ki])
            for kj in range(nk):
                e = e + 0.5 * ein("ijab,ia,jb->",
                                  u(ki, kj, ki, o, o, v, v),
                                  t1[ki], t1[kj])
                for ka in range(nk):
                    e = e + 0.25 * ein("ijab,ijab->",
                                       u(ki, kj, ka, o, o, v, v),
                                       t2[ki, kj, ka])
        return r1_out, t2_new, e

    return resid


def _equations_packed(nk, nocc, nvir, kp3, mesh=None,
                      include_drive=True):
    """Batched-gather formulation of ``_equations`` — identical math,
    accelerator-first shape.

    Every momentum block loop becomes one einsum over packed
    (nk, nk, nk, ...) tensors: aligned blocks contract directly; blocks
    whose k-labels are *derived* (via kp3) are materialized by XLA
    gathers from host-precomputed index tables.  The trace is O(#terms),
    independent of nk (the trace-loop reference `_equations` is
    O(nk^3 terms): >10 min XLA compiles at nk=8).  Equivalence with the
    reference implementation is a permanent gate (tests/test_cc.py).

    Memory note: four contractions gather an (nk^4, o^2 v^2) operand —
    ~270 MB at nk=8 / 16 spin orbitals (f64).  For larger nso, chunk the
    gathered axis with lax.map like make_t3_energy does.

    ``mesh``: a 1D device mesh (axis "d") shards every packed momentum
    tensor (amplitudes, integral slabs, W intermediates, residual) over
    its leading k axis via sharding constraints — GSPMD turns the
    kconserv gathers into collectives, and per-device memory scales as
    nk^3/ndev blocks.  N-vs-1-device agreement is gated on the 8-way CPU
    mesh (tests/test_parallel.py).
   
    ``include_drive=False`` drops the T2 driving term conj(<ij||ab>) —
    the ONE conj(U) in the residual — so the returned function is
    holomorphic in U; the 2-RDM machinery (lambda_rdm2) adds the
    driving's density contribution analytically.
    """
    o, v = slice(0, nocc), slice(nocc, nocc + nvir)
    KP = np.asarray(kp3)
    ar = np.arange(nk)
    X2, Y2 = ar[:, None], ar[None, :]
    X3, Y3, Z3 = ar[:, None, None], ar[None, :, None], ar[None, None, :]
    X4 = ar[:, None, None, None]
    Y4 = ar[None, :, None, None]
    Z4 = ar[None, None, :, None]
    W4 = ar[None, None, None, :]
    KPxyz = KP[X3, Y3, Z3]                  # kp(axis0, axis1, axis2)
    KPxyw4 = KP[X4, Y4, W4]                 # kp(x, y, w) on 4-axis grids
    KPxwz4 = KP[X4, W4, Z4]                 # kp(x, w, z)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        _sh = NamedSharding(mesh, PartitionSpec("d"))

        def cst(x):
            return jax.lax.with_sharding_constraint(x, _sh)
    else:
        def cst(x):
            return x

    def resid(t1, t2, f, U):
        foo = jnp.stack(list(f[0]))
        fov = jnp.stack(list(f[1]))
        fvo = jnp.stack(list(f[2]))
        fvv = jnp.stack(list(f[3]))
        T2 = cst(jnp.stack([jnp.stack([jnp.stack(
            [t2[a, b, c] for c in range(nk)]) for b in range(nk)])
            for a in range(nk)]))
        ein = jnp.einsum

        # pre-sliced integral slabs
        U = cst(U)
        Uoooo = cst(U[..., o, o, o, o])
        Uooov = cst(U[..., o, o, o, v])
        Uoovo = cst(U[..., o, o, v, o])
        Uoovv = cst(U[..., o, o, v, v])
        Uovov = cst(U[..., o, v, o, v])
        Uovvo = cst(U[..., o, v, v, o])
        Uovoo = cst(U[..., o, v, o, o])
        Uovvv = cst(U[..., o, v, v, v])
        Uvovv = cst(U[..., v, o, v, v])
        Uvvvo = cst(U[..., v, v, v, o])
        Uvvvv = cst(U[..., v, v, v, v])

        # ---- tau (t1 parts are momentum-diagonal: scatter-add) ----
        t1t1 = ein("kia,ljb->klijab", t1, t1)
        t1t1x = ein("kib,lja->klijab", t1, t1)
        tadd = jnp.zeros_like(T2)
        tadd = tadd.at[X2, Y2, X2].add(t1t1)
        tadd = tadd.at[X2, Y2, Y2].add(-t1t1x)
        tau = cst(T2 + tadd)
        tau_t = cst(T2 + 0.5 * tadd)

        # ---- F intermediates (k-diagonal, shape (nk, ...)) ----
        f_ae = (fvv - 0.5 * ein("kma,kme->kae", t1, fov)
                + ein("xmf,xkmafe->kae", t1, Uovvv[X2, Y2, X2])
                - 0.5 * ein("xykmnaf,xykmnef->kae", tau_t, Uoovv))
        f_mi = (foo + 0.5 * ein("kie,kme->kmi", t1, fov)
                + ein("yne,kymnie->kmi", t1, Uooov[X2, Y2, X2])
                + 0.5 * ein("kxyinef,kxymnef->kmi", tau_t, Uoovv))
        f_me = fov + ein("ynf,kymnef->kme", t1, Uoovv[X2, Y2, X2])

        # ---- T1 residual ----
        r1 = (jnp.swapaxes(fvo, 1, 2)
              + ein("kie,kae->kia", t1, f_ae)
              - ein("kma,kmi->kia", t1, f_mi)
              + ein("kximae,xme->kia", T2[X2, Y2, X2], f_me)
              - ein("ynf,yknaif->kia", t1, Uovov[X2, Y2, Y2])
              - 0.5 * ein("kxyimef,kxymaef->kia", T2,
                          Uovvv[Y3, X3, Z3])
              - 0.5 * ein("xykmnae,xyknmei->kia", T2,
                          Uoovo[Y3, X3, KPxyz]))

        # ---- W_mnij, blocks [x=km, y=kn, z=ki] (kj = kp(x,y,z)) ----
        kj_b = KPxyz
        t1_g = t1[kj_b]
        raw_o = ein("xyzje,xyzmnie->xyzmnij", t1_g, Uooov)
        w_oooo = cst(Uoooo + raw_o
                     - raw_o[X3, Y3, kj_b].transpose(0, 1, 2, 3, 4, 6, 5)
                     + 0.25 * ein("xyzwijef,xywmnef->xyzmnij",
                                  tau[Z4, kj_b[:, :, :, None], W4],
                                  Uoovv))

        # ---- W_abef, blocks [x=ka, y=kb, z=ke] ----
        raw_v = ein("ymb,xyzamef->xyzabef", t1, Uvovv)
        w_vvvv = cst(Uvvvv - raw_v
                     + jnp.swapaxes(raw_v, 0, 1).transpose(0, 1, 2, 4, 3,
                                                           5, 6)
                     + 0.25 * ein("xywmnab,xyzwmnef->xyzabef",
                                  tau[Z3, KPxyz, X3],
                                  Uoovv[W4, KPxyw4, Z4]))

        # ---- W_mbej, blocks [x=km, y=kb, z=ke] (kj = kp(x,y,z)) ----
        kf_g = KP[kj_b[:, :, :, None], W4, Y4]
        w_ovvo = cst(Uovvo
                     + ein("xyzjf,xyzmbef->xyzmbej", t1_g, Uovvv)
                     - ein("ynb,xyzmnej->xyzmbej", t1, Uoovo)
                     - ein("xyzjf,ynb,xyzmnef->xyzmbej", t1_g, t1,
                           Uoovv)
                     - 0.5 * ein("xyzwjnfb,xwzmnef->xyzmbej",
                                 T2[kj_b[:, :, :, None], W4, kf_g],
                                 Uoovv))

        # ---- T2 residual, blocks [x=ki, y=kj, z=ka] (kb = kp(x,y,z)) --
        kb_b = KPxyz
        f_be_t = f_ae - 0.5 * ein("kmb,kme->kbe", t1, f_me)
        f_mj_t = f_mi + 0.5 * ein("kje,kme->kmj", t1, f_me)
        raw_ab = (ein("xyzijae,xyzbe->xyzijab", T2, f_be_t[kb_b])
                  - ein("zma,xyzmbij->xyzijab", t1,
                        Uovoo[Z3, kb_b, X3]))
        raw_ij = (-ein("xyzimab,ymj->xyzijab", T2, f_mj_t)
                  + ein("xie,xyzabej->xyzijab", t1,
                        Uvvvo[Z3, kb_b, X3]))
        raw_z = (-ein("xie,zma,xyzmbej->xyzijab", t1, t1,
                      Uovvo[Z3, kb_b, X3])
                 + ein("xwzimae,xyzwmbej->xyzijab", T2,
                       w_ovvo[W4, kb_b[:, :, :, None], KPxwz4]))

        r2 = (cst(Uoovv.conj()) if include_drive
              else jnp.zeros_like(Uoovv))
        r2 = r2 + (raw_ab
                   - raw_ab[X3, Y3, kb_b].transpose(0, 1, 2, 3, 4, 6, 5))
        r2 = r2 + (raw_ij
                   - jnp.swapaxes(raw_ij, 0, 1).transpose(0, 1, 2, 4, 3,
                                                          5, 6))
        z_ab = raw_z[X3, Y3, kb_b]
        r2 = r2 + (raw_z
                   - jnp.swapaxes(raw_z, 0, 1).transpose(0, 1, 2, 4, 3,
                                                         5, 6)
                   - z_ab.transpose(0, 1, 2, 3, 4, 6, 5)
                   + jnp.swapaxes(z_ab, 0, 1).transpose(0, 1, 2, 4, 3,
                                                        6, 5))
        r2 = r2 + 0.5 * ein("xyzwmnab,xywmnij->xyzijab",
                            tau[W4, KPxyw4, Z4],
                            w_oooo[Z3, KPxyz, X3])
        r2 = r2 + 0.5 * ein("xywijef,xyzwabef->xyzijab", tau,
                            w_vvvv[Z4, kb_b[:, :, :, None], W4])

        # ---- energy at the input amplitudes ----
        e = (ein("kia,kia->", fov, t1)
             + 0.5 * ein("xyijab,xia,yjb->", Uoovv[X2, Y2, X2], t1, t1)
             + 0.25 * ein("xyzijab,xyzijab->", Uoovv, T2))

        r1_out = [r1[k] for k in range(nk)]
        r2_out = {(a, b, c): r2[a, b, c] for a in range(nk)
                  for b in range(nk) for c in range(nk)}
        return r1_out, r2_out, e

    return resid


def _hf_fock_so(df, mf):
    """Reference-determinant HF Fock (h + J - K) in the spin-orbital MO
    basis, J/K served from the ISDF state (integral-consistent with
    make_eris) at the converged density.  Enables CC on non-HF (KS)
    references: the full one-body blocks enter the equations and only
    the (real) diagonal goes into the denominators.  Returns
    (f_so (nk, nso, nso) host complex, nocc_so)."""
    cs, _, spins, nocc = _spinorb_mo(mf)
    dm = np.asarray(mf.dm)
    dms = np.stack([dm / 2.0, dm / 2.0]) if dm.ndim == 3 else dm
    exxdiv = getattr(mf, "exxdiv", None)
    vja, vka = df.get_jk(dms[0], exxdiv=exxdiv)
    vjb, vkb = df.get_jk(dms[1], exxdiv=exxdiv)
    vj = to_host(vja) + to_host(vjb)
    h1e = np.asarray(mf.h1e)
    focks = [h1e + vj - to_host(vka), h1e + vj - to_host(vkb)]
    nk, nao, nso = cs.shape
    f_so = np.zeros((nk, nso, nso), dtype=complex)
    for k in range(nk):
        for s in range(2):
            sel = np.where(spins[k] == s)[0]
            c = cs[k][:, sel]
            f_so[k][np.ix_(sel, sel)] = c.conj().T @ focks[s][k] @ c
    return f_so, nocc


def make_step(nk, nocc, nvir, kp3, eo, ev, f_so=None, mesh=None):
    """Build the jitted CCSD update ``step(t1, t2, U) -> (t1, t2, e)``.

    kp3[a,b,c] = index of k_a + k_b - k_c.  ``e`` is the supercell
    correlation energy at the *input* amplitudes (so the first call from
    the MP2 guess reports E_MP2).  U must already carry the supercell
    normalization (cell ERIs / nk).  With ``f_so=None`` (canonical
    reference) the one-body blocks handed to the equations are
    diag(eo/ev); a full ``f_so`` (nk, nso, nso) enables non-canonical /
    non-HF references — its off-diagonals enter the residual while
    eo/ev (its real diagonal) stay in the denominators.  The update is
    t + R/D (Jacobi on the full residual of the batched-gather
    ``_equations_packed``; ``_equations`` is the equivalent trace-loop
    reference implementation).
    """
    kp3 = np.asarray(kp3)

    def kp(a, b, c):
        return int(kp3[a, b, c])

    d1 = [eo[k][:, None] - ev[k][None, :] for k in range(nk)]
    d2 = {}
    for ki in range(nk):
        for kj in range(nk):
            for ka in range(nk):
                kb = kp(ki, kj, ka)
                d2[ki, kj, ka] = (
                    eo[ki][:, None, None, None]
                    + eo[kj][None, :, None, None]
                    - ev[ka][None, None, :, None]
                    - ev[kb][None, None, None, :])

    resid = _equations_packed(nk, nocc, nvir, kp3, mesh=mesh)

    def step(t1, t2, U):
        cplx = U.dtype
        if f_so is None:
            f = ([jnp.asarray(np.diag(eo[k])).astype(cplx)
                  for k in range(nk)],
                 [jnp.zeros((nocc, nvir), cplx) for _ in range(nk)],
                 [jnp.zeros((nvir, nocc), cplx) for _ in range(nk)],
                 [jnp.asarray(np.diag(ev[k])).astype(cplx)
                  for k in range(nk)])
        else:
            o, vs = slice(0, nocc), slice(nocc, nocc + nvir)
            f = ([jnp.asarray(f_so[k][o, o]).astype(cplx)
                  for k in range(nk)],
                 [jnp.asarray(f_so[k][o, vs]).astype(cplx)
                  for k in range(nk)],
                 [jnp.asarray(f_so[k][vs, o]).astype(cplx)
                  for k in range(nk)],
                 [jnp.asarray(f_so[k][vs, vs]).astype(cplx)
                  for k in range(nk)])
        r1, r2, e = resid(t1, t2, f, U)
        t1_new = jnp.stack([t1[k] + r1[k] / d1[k] for k in range(nk)])
        t2_new = {key: t2[key] + r2[key] / d2[key] for key in r2}
        return t1_new, t2_new, e

    return jax.jit(step)


_pack_jit = None


def _pack(t1, t2, nk):
    """Amplitudes -> ONE host vector: the concatenation runs under jit and
    crosses the host boundary as a single complex pull — O(1) transfers
    per DIIS cycle instead of O(nk^3)."""
    global _pack_jit
    if _pack_jit is None:
        _pack_jit = jax.jit(_pack_dev, static_argnums=2)
    return to_host(_pack_jit(t1, t2, nk))


def _unpack_dev(vec, nk, nocc, nvir):
    t1 = vec[:nk * nocc * nvir].reshape(nk, nocc, nvir)
    blk = nocc * nocc * nvir * nvir
    t2 = {}
    off = nk * nocc * nvir
    for ki in range(nk):
        for kj in range(nk):
            for ka in range(nk):
                t2[ki, kj, ka] = vec[off:off + blk].reshape(
                    nocc, nocc, nvir, nvir)
                off += blk
    return t1, t2


def kccsd(df, mf, conv_tol=1e-7, max_cycle=60, diis_space=8, verbose=0,
          return_amps=False, reference="auto", dev_mesh=None):
    """CCSD correlation energy per cell from a converged ``mf`` on the
    ISDF factorization ``df``.  Returns (e_corr, info).

    Spin-orbital formulation: restricted and unrestricted references run
    through the same code (KUHF support = different alpha/beta orbitals
    in the spin-orbital integral blocks).

    ``reference``: 'canonical' assumes diagonal fock = mo_energy (HF);
    'fock' rebuilds the reference-determinant HF fock from the ISDF
    state and runs the full-one-body equations — required for KS (KRKS/
    KUKS) references, where f has ov blocks; 'auto' picks 'fock' when
    ``mf.xc`` exists and is not 'hf'.  The correlation energy is then
    relative to the HF energy *functional at the reference determinant*
    (not the KS total energy); for a 2-electron system
    E_det(ref) + E_corr is reference-independent (= FCI) — gated.

    ``dev_mesh``: a 1D device mesh (axis "d") shards the packed momentum
    tensors over devices (GSPMD; see _equations_packed).
    """
    from fftisdf_tpu.scf.hf import DIIS

    if reference == "auto":
        reference = ("fock" if getattr(mf, "xc", "hf")
                     not in (None, "hf") else "canonical")
    nk = df.nkpt
    U, eo, ev, nocc = make_eris_dev(df, mf)
    f_so = None
    if reference == "fock":
        f_so, _ = _hf_fock_so(df, mf)
        eo = np.real(np.stack([np.diag(f_so[k])[:nocc]
                               for k in range(nk)]))
        ev = np.real(np.stack([np.diag(f_so[k])[nocc:]
                               for k in range(nk)]))
    nvir = ev.shape[1]
    if nocc == 0 or nvir == 0:
        return 0.0, {"converged": True, "niter": 0, "imag": 0.0,
                     "nocc": nocc}
    k3c = df.kconserv3()
    kp3 = np.empty((nk, nk, nk), dtype=np.int64)
    for a in range(nk):
        for b in range(nk):
            for c in range(nk):
                kp3[a, b, c] = k3c[a, c, b]

    step = make_step(nk, nocc, nvir, kp3, eo, ev, f_so=f_so,
                     mesh=dev_mesh)

    cdt = (jnp.complex128 if df.x_k.dtype == jnp.complex128
           else jnp.complex64)
    # supercell normalization + MP2 guess, all on device
    U_dev = jax.jit(lambda u: u.astype(cdt) / nk)(U)
    if dev_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        U_dev = jax.device_put(
            U_dev, NamedSharding(dev_mesh, PartitionSpec("d")))
    t1 = jnp.zeros((nk, nocc, nvir), cdt)

    @jax.jit
    def _guess(u):
        t2 = {}
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    kb = int(kp3[ki, kj, ka])
                    d = (eo[ki][:, None, None, None]
                         + eo[kj][None, :, None, None]
                         - ev[ka][None, None, :, None]
                         - ev[kb][None, None, None, :])
                    t2[ki, kj, ka] = (
                        jnp.conj(u[ki, kj, ka, :nocc, :nocc,
                                   nocc:, nocc:])
                        / jnp.asarray(d).astype(cdt))
        return t2

    t2 = _guess(U_dev)

    diis = DIIS(space=diis_space)
    unpack = jax.jit(_unpack_dev, static_argnums=(1, 2, 3))
    e_old = 0.0
    conv = False
    e = 0.0
    niter = 0
    dt_max = 0.0
    vec_old = _pack(t1, t2, nk)
    for it in range(max_cycle):
        t1n, t2n, e_dev = step(t1, t2, U_dev)
        e = complex(to_host(e_dev)) / nk     # per cell
        vec_new = _pack(t1n, t2n, nk)
        err = vec_new - vec_old
        # rms convergence: the max-norm stalls on a few oscillating
        # near-degenerate components (observed on small-gap diamond
        # meshes) long after the energy and the amplitude rms converged
        dt = float(np.linalg.norm(err) / np.sqrt(err.size))
        dt_max = float(np.max(np.abs(err)))
        vec_old = diis.update(vec_new, err)
        t1, t2 = unpack(to_device(vec_old, dtype=cdt), nk, nocc, nvir)
        niter = it + 1
        if verbose:
            print(f"cycle {niter}: e_corr={e.real:.10f} rms(dt)={dt:.2e} "
                  f"max={dt_max:.2e}")
        if dt < conv_tol and abs(e.real - e_old) < conv_tol:
            conv = True
            break
        e_old = e.real
    # energy at the final mixed amplitudes
    _, _, e_dev = step(t1, t2, U_dev)
    e = complex(to_host(e_dev)) / nk
    info = {"converged": conv, "niter": niter, "dt_max": dt_max,
            "imag": float(e.imag), "nocc": nocc, "reference": reference}
    if return_amps:
        info["t1"], info["t2"], info["U"] = t1, t2, U_dev
        info["eo"], info["ev"], info["kp3"] = eo, ev, kp3
    return float(e.real), info


# ----------------------------------------------------------------------
# EOM-EE-CCSD via the CCSD Jacobian
# ----------------------------------------------------------------------

def _pack_dev(t1, t2, nk):
    return jnp.concatenate(
        [t1.ravel()] + [t2[ki, kj, ka].ravel()
                        for ki in range(nk) for kj in range(nk)
                        for ka in range(nk)])


def eomee(df, mf, conv_tol=1e-8, max_cycle=80, verbose=0):
    """EOM-EE-CCSD excitation energies (zero-momentum-transfer sector).

    Uses the linear-response identity: at converged amplitudes the CCSD
    residual Jacobian  J = dR/dt  equals  <Phi_mu| Hbar |Phi_nu> - E 1
    on the singles+doubles space (Hbar = e^-T H e^T is block-triangular
    once R = 0), so its eigenvalues ARE the EOM-EE excitation energies.
    The Jacobian comes from ``jax.jacfwd`` of the (holomorphic — no
    conj(t) anywhere) jitted residual: no sigma-vector equations to
    derive, and the complex-safety of the residual (oracle-gated) is
    inherited.  Gate: tests/test_cc.py vs the literal determinant-space
    Hbar block.

    The redundant packed t2 (full antisymmetric blocks) is projected
    onto an orthonormal basis of independent components ((k,i)<(k,j),
    (k,a)<(k,b) composite orderings); the amplitude space is exactly the
    q = 0 (optical) sector, see the inline note.

    Returns (omega, info): complex eigenvalues sorted by real part.
    Dense diagonalization — fixture scale; the scalable path is Davidson
    on the same Jacobian as a ``jax.jvp`` matvec (no matrix
    materialized)."""
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose, return_amps=True)
    if not info["converged"]:
        raise RuntimeError("kccsd did not converge; EOM needs R = 0")
    if info.get("reference") == "fock":
        raise NotImplementedError(
            "EOM assumes a canonical (diagonal-fock HF) reference")
    w = eom_dense(df.nkpt, info["nocc"], info["ev"].shape[1],
                  info["kp3"], info["eo"], info["ev"],
                  info["t1"], info["t2"], info["U"])
    info["e_ccsd"] = e_cc
    return w, info


def _jacobian(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev):
    """Host Jacobian dR/dt of the packed CCSD residual at (t1, t2)."""
    step = make_step(nk, nocc, nvir, kp3, eo_, ev_)
    n1 = nk * nocc * nvir
    blk = nocc * nocc * nvir * nvir
    cdt = U_dev.dtype

    def unpack(vec):
        t1 = vec[:n1].reshape(nk, nocc, nvir)
        t2 = {}
        off = n1
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    t2[ki, kj, ka] = vec[off:off + blk].reshape(
                        nocc, nocc, nvir, nvir)
                    off += blk
        return t1, t2

    d1 = np.stack([eo_[k][:, None] - ev_[k][None, :] for k in range(nk)])
    d2v = []
    for ki in range(nk):
        for kj in range(nk):
            for ka in range(nk):
                kb = int(kp3[ki, kj, ka])
                d2v.append((eo_[ki][:, None, None, None]
                            + eo_[kj][None, :, None, None]
                            - ev_[ka][None, None, :, None]
                            - ev_[kb][None, None, None, :]).ravel())
    dvec = jnp.asarray(np.concatenate([d1.ravel()] + d2v))

    @jax.jit
    def residual(vec, U):
        t1, t2 = unpack(vec)
        t1n, t2n, _ = step(t1, t2, U)
        return dvec * (_pack_dev(t1n, t2n, nk) - vec)

    tvec = _pack_dev(t1_conv, t2_conv, nk)
    jac = jax.jacfwd(lambda v: residual(v, U_dev),
                     holomorphic=True)(tvec.astype(cdt))
    return to_host(jac)


def _amp_basis(nk, nocc, nvir, kp3):
    """Orthonormal columns spanning the independent (antisymmetric)
    amplitude components, as (labels, columns): labels are
    ('s', k, i, a) / ('d', ki, i, kj, j, ka, a, kb, b)."""
    n1 = nk * nocc * nvir
    blk = nocc * nocc * nvir * nvir
    ntot = n1 + nk ** 3 * blk
    cols, labels = [], []
    for k in range(nk):
        for i in range(nocc):
            for a in range(nvir):
                col = np.zeros(ntot)
                col[(k * nocc + i) * nvir + a] = 1.0
                cols.append(col)
                labels.append(("s", k, i, a))

    def comp(k, p):
        return k * (nocc + nvir) + p

    idx2 = {}
    off = n1
    for ki in range(nk):
        for kj in range(nk):
            for ka in range(nk):
                kb = int(kp3[ki, kj, ka])
                for i in range(nocc):
                    for j in range(nocc):
                        for a in range(nvir):
                            for b in range(nvir):
                                idx2[(ki, i, kj, j, ka, a, kb, b)] = (
                                    off + ((i * nocc + j) * nvir + a)
                                    * nvir + b)
                off += blk
    for (ki, i, kj, j, ka, a, kb, b), pos in idx2.items():
        if comp(ki, i) >= comp(kj, j) or comp(ka, a) >= comp(kb, b):
            continue
        col = np.zeros(ntot)
        col[pos] = 0.5
        col[idx2[(kj, j, ki, i, ka, a, kb, b)]] = -0.5
        col[idx2[(ki, i, kj, j, kb, b, ka, a)]] = -0.5
        col[idx2[(kj, j, ki, i, kb, b, ka, a)]] = 0.5
        cols.append(col)
        labels.append(("d", ki, i, kj, j, ka, a, kb, b))
    return labels, np.stack(cols, axis=1)


def eom_dense(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev):
    """Dense EOM-EE eigenvalues from converged amplitudes (see eomee).

    NB: the ground-state amplitude space IS the q = 0 (optical) momentum
    sector — t1 is k-diagonal and every t2 block conserves momentum — so
    the Jacobian spans exactly the zero-momentum-transfer EOM-EE block.
    Finite-q sectors would need k-offdiagonal trial amplitudes (a
    sigma-vector generalization), intentionally out of scope here."""
    jac = _jacobian(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv,
                    U_dev)
    _, bmat = _amp_basis(nk, nocc, nvir, kp3)
    w = np.linalg.eigvals(bmat.T @ jac @ bmat)
    return np.sort_complex(w)


def _residual_fn(nk, nocc, nvir, kp3, eo_, ev_, U_dev):
    """The packed CCSD residual R(t) and its jitted jvp-matvec factory."""
    step = make_step(nk, nocc, nvir, kp3, eo_, ev_)
    n1 = nk * nocc * nvir
    blk = nocc * nocc * nvir * nvir

    def unpack(vec):
        t1 = vec[:n1].reshape(nk, nocc, nvir)
        t2 = {}
        off = n1
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    t2[ki, kj, ka] = vec[off:off + blk].reshape(
                        nocc, nocc, nvir, nvir)
                    off += blk
        return t1, t2

    d1 = np.stack([eo_[k][:, None] - ev_[k][None, :] for k in range(nk)])
    d2v = []
    for ki in range(nk):
        for kj in range(nk):
            for ka in range(nk):
                kb = int(kp3[ki, kj, ka])
                d2v.append((eo_[ki][:, None, None, None]
                            + eo_[kj][None, :, None, None]
                            - ev_[ka][None, None, :, None]
                            - ev_[kb][None, None, None, :]).ravel())
    dhost = np.concatenate([d1.ravel()] + d2v)
    dvec = jnp.asarray(dhost)

    def residual(vec):
        t1, t2 = unpack(vec)
        t1n, t2n, _ = step(t1, t2, U_dev)
        return dvec * (_pack_dev(t1n, t2n, nk) - vec)

    @jax.jit
    def matvec(tvec, x):
        return jax.jvp(residual, (tvec,), (x,))[1]

    return residual, matvec, dhost


def eom_davidson(matvec_amp, bmat, diag, nroots=4, tol=1e-7,
                 max_space=60, max_cycle=200):
    """Matrix-free non-Hermitian Davidson for the lowest-real-part
    eigenvalues of the EOM block  M = B^T J B  (B orthonormal columns of
    the sector basis; J applied only through ``matvec_amp`` — jax.jvp of
    the CCSD residual, no matrix materialized).

    ``diag``: approximate diagonal of M for the preconditioner (the
    excitation-energy denominators).  Returns (omega[nroots], converged).
    """
    m = bmat.shape[1]
    nroots = min(nroots, m)
    rng = np.random.default_rng(0)

    def apply_m(c):
        y = matvec_amp(bmat @ c)
        return bmat.conj().T @ y

    # start from the preconditioner's lowest diagonals
    order = np.argsort(diag.real)
    vs = []
    for r in range(nroots):
        v = np.zeros(m, dtype=complex)
        v[order[r]] = 1.0
        vs.append(v)
    V = np.stack(vs, axis=1)
    conv = False
    theta = np.zeros(nroots, dtype=complex)
    for _ in range(max_cycle):
        # orthonormalize V
        q, _ = np.linalg.qr(V)
        V = q
        MV = np.stack([apply_m(V[:, j]) for j in range(V.shape[1])],
                      axis=1)
        h = V.conj().T @ MV
        w, y = np.linalg.eig(h)
        sel = np.argsort(w.real)[:nroots]
        theta, yv = w[sel], y[:, sel]
        x = V @ yv
        r = MV @ yv - x * theta[None, :]
        rn = np.linalg.norm(r, axis=0)
        if np.all(rn < tol):
            conv = True
            break
        if V.shape[1] + nroots > max_space:
            V = x                      # restart from the Ritz vectors
            continue
        new = []
        for j in range(nroots):
            if rn[j] < tol:
                continue
            denom = diag - theta[j]
            denom = np.where(np.abs(denom) < 1e-8, 1e-8, denom)
            new.append(r[:, j] / denom)
        if not new:
            conv = True
            break
        V = np.concatenate([V] + [n[:, None] for n in new], axis=1)
    return np.sort_complex(theta), conv


def eomee_davidson(df, mf, nroots=4, conv_tol=1e-8, max_cycle=80,
                   tol=1e-6, verbose=0):
    """Iterative (matrix-free) EOM-EE-CCSD: the lowest ``nroots`` q=0
    excitation energies via Davidson on jax.jvp matvecs — the scalable
    path (the Jacobian is never materialized; each iteration is one
    batched CC-residual-shaped computation on device)."""
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose, return_amps=True)
    if not info["converged"]:
        raise RuntimeError("kccsd did not converge; EOM needs R = 0")
    if info.get("reference") == "fock":
        raise NotImplementedError(
            "EOM assumes a canonical (diagonal-fock HF) reference")
    nk = df.nkpt
    nocc, nvir = info["nocc"], info["ev"].shape[1]
    _, matvec, dhost = _residual_fn(nk, nocc, nvir, info["kp3"],
                                    info["eo"], info["ev"], info["U"])
    tvec = _pack_dev(info["t1"], info["t2"], nk)

    def mv(x):
        return to_host(matvec(tvec, to_device(x,
                                              dtype=info["U"].dtype)))

    _, bmat = _amp_basis(nk, nocc, nvir, info["kp3"])
    diag = -(bmat.T * dhost[None, :]) @ bmat   # diag of -D in the basis
    diag = np.diag(diag).astype(complex)
    w, conv = eom_davidson(mv, bmat, diag, nroots=nroots, tol=tol)
    info["e_ccsd"], info["eom_converged"] = e_cc, conv
    return w, info


def lambda_rdm(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev):
    """Lambda (adjoint) solve and the unrelaxed CCSD one-particle
    density, with NO hand-derived Lambda equations:

    - stationarity of the Lagrangian L = E(t) + lambda^T R(t) w.r.t. the
      amplitudes is the linear system  J^T lambda = -dE/dt  with the SAME
      residual Jacobian the EOM path uses (jax.jacfwd / jax.grad of the
      oracle-verified holomorphic residual), solved on the
      independent-amplitude basis;
    - the density is  gamma_pq = dL/df_pq  (jax.grad w.r.t. the one-body
      blocks of ``_equations``, which are independent holomorphic
      arguments), plus the reference part delta_ij.  This is the
      standard *unrelaxed* (orbital-response-free) CCSD density.

    Returns ((goo, gov, gvo, gvv) per-k host blocks, lambda_packed).
    Gate: tests/test_cc.py vs the literal
    <0|(1+Lambda) e^-T p^dag q e^T|0> with the determinant-space Lambda.
    """
    resid = _equations_packed(nk, nocc, nvir, kp3)
    n1 = nk * nocc * nvir
    blk = nocc * nocc * nvir * nvir
    cdt = U_dev.dtype

    def unpack(vec):
        t1 = vec[:n1].reshape(nk, nocc, nvir)
        t2 = {}
        off = n1
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    t2[ki, kj, ka] = vec[off:off + blk].reshape(
                        nocc, nocc, nvir, nvir)
                    off += blk
        return t1, t2

    f0 = ([jnp.asarray(np.diag(eo_[k])).astype(cdt) for k in range(nk)],
          [jnp.zeros((nocc, nvir), cdt) for _ in range(nk)],
          [jnp.zeros((nvir, nocc), cdt) for _ in range(nk)],
          [jnp.asarray(np.diag(ev_[k])).astype(cdt) for k in range(nk)])

    def rvec_e(vec, f):
        t1_, t2_ = unpack(vec)
        r1, r2, e = resid(t1_, t2_, f, U_dev)
        return _pack_dev(jnp.stack(r1), r2, nk), e

    tvec = _pack_dev(t1_conv, t2_conv, nk).astype(cdt)
    g = jax.grad(lambda v: rvec_e(v, f0)[1],
                 holomorphic=True)(tvec)
    jac = jax.jacfwd(lambda v: rvec_e(v, f0)[0],
                     holomorphic=True)(tvec)
    gh, jh = to_host(g), to_host(jac)
    _, bmat = _amp_basis(nk, nocc, nvir, kp3)
    lam_b = np.linalg.solve((bmat.T @ jh @ bmat).T, -(bmat.T @ gh))
    lam = to_device(bmat @ lam_b, dtype=cdt)

    def lagr(f):
        r, e = rvec_e(tvec, f)
        return e + jnp.sum(lam * r)            # lambda^T R (no conj)

    grads = jax.grad(lagr, holomorphic=True)(f0)
    goo = [to_host(grads[0][k]) + np.eye(nocc) for k in range(nk)]
    gov = [to_host(grads[1][k]) for k in range(nk)]
    gvo = [to_host(grads[2][k]) for k in range(nk)]
    gvv = [to_host(grads[3][k]) for k in range(nk)]
    return (goo, gov, gvo, gvv), to_host(lam)


def lambda_rdm2(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev,
                lam=None, gam1=None):
    """Unrelaxed CCSD two-particle density, antisymmetrized spin-orbital
    pairing:  Gamma_as[k1,k2,k3][p,q,r,s] = <(1+Lambda) e^-T p+ q+ s r
    e^T>  (the density paired with <pq||rs> in  E2 = 1/4 sum u Gamma).

    Autodiff route: U enters the Lagrangian linearly and holomorphically
    except the single T2 driving term conj(U_oovv), so
    Gamma = 4 * dL/dU (include_drive=False) plus the driving's analytic
    contribution — lambda2 mapped through the integral Hermiticity
    conj(U[k1,k2,k3][ijab]) = U[k3,k4,k1][abij] onto the vvoo slots.
    Gate: literal determinant-space <(1+L) e^-T p+q+sr e^T| at a random
    converged system (tests/test_cc.py).

    Returns Gamma_as as a host (nk,nk,nk,nso,nso,nso,nso) array in the
    same (supercell-normalized-U) units the Lagrangian uses.
    """
    if lam is None or gam1 is None:
        gam1, lam = lambda_rdm(nk, nocc, nvir, kp3, eo_, ev_, t1_conv,
                               t2_conv, U_dev)
    resid_nd = _equations_packed(nk, nocc, nvir, kp3,
                                 include_drive=False)
    cdt = U_dev.dtype
    n1 = nk * nocc * nvir
    blk = nocc * nocc * nvir * nvir
    f0 = ([jnp.asarray(np.diag(eo_[k])).astype(cdt) for k in range(nk)],
          [jnp.zeros((nocc, nvir), cdt) for _ in range(nk)],
          [jnp.zeros((nvir, nocc), cdt) for _ in range(nk)],
          [jnp.asarray(np.diag(ev_[k])).astype(cdt) for k in range(nk)])
    lam_dev = to_device(lam, dtype=cdt)

    def unpack(vec):
        t1 = vec[:n1].reshape(nk, nocc, nvir)
        t2 = {}
        off = n1
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    t2[ki, kj, ka] = vec[off:off + blk].reshape(
                        nocc, nocc, nvir, nvir)
                    off += blk
        return t1, t2

    tvec = _pack_dev(t1_conv, t2_conv, nk).astype(cdt)

    def lagr_u(up):
        t1_, t2_ = unpack(tvec)
        r1, r2, e = resid_nd(t1_, t2_, f0, up)
        return e + jnp.sum(lam_dev * _pack_dev(jnp.stack(r1), r2, nk))

    g = to_host(jax.grad(lagr_u, holomorphic=True)(U_dev))
    gam2 = 4.0 * g
    # analytic driving part: sum lam2[k1,k2,k3][ijab] d conj(U_oovv)
    #                      = sum lam2[k1,k2,k3][ijab] dU[k3,k4,k1][abij]
    lam2 = np.asarray(lam[n1:]).reshape((nk,) * 3 + (nocc, nocc,
                                                     nvir, nvir))
    kp3 = np.asarray(kp3)
    for k1 in range(nk):
        for k2 in range(nk):
            for k3 in range(nk):
                k4 = int(kp3[k1, k2, k3])
                gam2[k3, k4, k1, nocc:, nocc:, :nocc, :nocc] += (
                    4.0 * lam2[k1, k2, k3].transpose(2, 3, 0, 1))
    # project onto the exact operator antisymmetries (the derivative may
    # split weight unevenly over redundant slots; u carries these
    # symmetries exactly, so contractions are unchanged and the result
    # is the canonical — literal — representative).  NB: do NOT
    # hermitize — the unrelaxed CC density is genuinely non-Hermitian
    # away from the exactness limit (gated at 3 electrons).
    ar = np.arange(nk)
    X3, Y3, Z3 = ar[:, None, None], ar[None, :, None], ar[None, None, :]
    k4_b = kp3[X3, Y3, Z3]
    # bra antisymmetry (p<->q, k1<->k2)
    gam2 = 0.5 * (gam2 - gam2.transpose(1, 0, 2, 4, 3, 5, 6))
    # ket antisymmetry (r<->s, k3<->k4)
    gam2 = 0.5 * (gam2 - gam2[X3, Y3, k4_b].transpose(0, 1, 2, 3, 4,
                                                      6, 5))
    # The Lagrangian holds the fock fixed and omits E_ref, but a
    # physical du both moves the fock (by its occupied trace, paired
    # with gamma_corr) and shifts the determinant energy (paired with
    # the reference 2-RDM).  Add both in canonical (already projected)
    # form:  Gamma_ref = delta delta - exchange, and the antisymmetrized
    # gamma_corr x delta_occ cross product.
    nso = nocc + nvir
    goo, gov, gvo, gvv = gam1
    gc = np.zeros((nk, nso, nso), dtype=complex)
    for k in range(nk):
        gc[k, :nocc, :nocc] = goo[k] - np.eye(nocc)   # correlation only
        gc[k, :nocc, nocc:] = gov[k]
        gc[k, nocc:, :nocc] = gvo[k]
        gc[k, nocc:, nocc:] = gvv[k]
    d_occ = np.zeros((nso, nso))
    d_occ[:nocc, :nocc] = np.eye(nocc)
    eye_o = np.eye(nocc)
    for k1 in range(nk):
        for k2 in range(nk):
            # blocks [k1, k2, k1]: delta_pr-type pairings
            blk13 = gam2[k1, k2, k1]
            blk13[:nocc, :nocc, :nocc, :nocc] += np.einsum(
                "pr,qs->pqrs", eye_o, eye_o)
            blk13 += (np.einsum("pr,qs->pqrs", gc[k1], d_occ)
                      + np.einsum("pr,qs->pqrs", d_occ, gc[k2]))
            # blocks [k1, k2, k2]: delta_ps-type (exchange) pairings
            blk14 = gam2[k1, k2, k2]
            blk14[:nocc, :nocc, :nocc, :nocc] -= np.einsum(
                "ps,qr->pqrs", eye_o, eye_o)
            blk14 -= (np.einsum("ps,qr->pqrs", gc[k1], d_occ)
                      + np.einsum("ps,qr->pqrs", d_occ, gc[k2]))
    return gam2


def ccsd_solver(h1, eri, nelec, conv_tol=1e-9, max_cycle=100,
                diis_space=8):
    """Molecular-style CCSD solver with RDMs: (h1, eri, nelec) ->
    (e_elec, gamma, Gamma) in scf.fci conventions — a drop-in impurity
    solver for scf.dmet beyond exact-diagonalization reach.

    h1 (n, n) complex Hermitian; eri chemists' (pq|rs); closed-shell
    nelec.  Internally: a small RHF solve fixes the reference
    determinant, the spin-orbital CC machinery (make_step at nk=1) runs
    in the canonical MO basis, and the unrelaxed CC RDMs come from the
    Lambda/Lagrangian machinery (lambda_rdm / lambda_rdm2), mapped back
    to the input basis.  Gates: equals FCI exactly for 2 electrons, and
    tracks it closely on 4-electron embeddings (tests/test_dmet.py).
    """
    from fftisdf_tpu.scf.hf import DIIS

    h1 = np.asarray(h1, dtype=complex)
    eri = np.asarray(eri, dtype=complex)
    n = h1.shape[0]
    nelec = int(nelec) if not isinstance(nelec, (tuple, list)) \
        else int(sum(nelec))
    assert nelec % 2 == 0, "closed-shell solver"
    no = nelec // 2
    nv = n - no

    # small dense RHF (fci gamma convention: gamma[p,q] = <p+ q>)
    gamma = np.zeros((n, n), dtype=complex)
    gamma[:no, :no] = 2.0 * np.eye(no)
    c_mo = np.eye(n, dtype=complex)
    diis = DIIS(space=8)
    for it in range(200):
        f = h1 + _vhf_chem(eri, gamma)
        err = f @ gamma.T - gamma.T @ f
        f = diis.update(f.ravel(), err.ravel()).reshape(n, n)
        w, c_mo = np.linalg.eigh(0.5 * (f + f.conj().T))
        gamma_new = 2.0 * (c_mo[:, :no] @ c_mo[:, :no].conj().T).T
        dg = float(np.max(np.abs(gamma_new - gamma)))
        gamma = gamma_new
        if dg < 1e-11:
            break
    assert dg < 1e-9, f"embedded RHF did not converge (|dD|={dg:.1e})"
    e_hf = (np.einsum("pq,pq->", h1, gamma)
            + 0.5 * np.einsum("pq,pq->", _vhf_chem(eri, gamma), gamma))

    # MO-basis integrals; spin-orbital order [occ_a, occ_b, vir_a, vir_b]
    eri_mo = np.einsum("pm,qn,rk,sl,pqrs->mnkl", c_mo.conj(), c_mo,
                       c_mo.conj(), c_mo, eri, optimize=True)
    spat = np.array([*range(no), *range(no), *range(no, n),
                     *range(no, n)])
    spin = np.array([0] * no + [1] * no + [0] * nv + [1] * nv)
    nso = 2 * n
    phys = eri_mo.transpose(0, 2, 1, 3)        # <pq|rs> = (pr|qs)
    d = (phys[np.ix_(spat, spat, spat, spat)]
         * ((spin[:, None, None, None] == spin[None, None, :, None])
            & (spin[None, :, None, None] == spin[None, None, None, :])))
    x = (phys.transpose(0, 1, 3, 2)[np.ix_(spat, spat, spat, spat)]
         * ((spin[:, None, None, None] == spin[None, None, None, :])
            & (spin[None, :, None, None] == spin[None, None, :, None])))
    U = (d - x)[None, None, None]
    e_so = np.concatenate([w[:no], w[:no], w[no:], w[no:]])
    # fock diag in the canonical MO basis is w
    eo = e_so[None, :2 * no]
    ev = e_so[None, 2 * no:]
    kp3 = np.zeros((1, 1, 1), dtype=np.int64)
    nocc_so, nvir_so = 2 * no, 2 * nv
    step = make_step(1, nocc_so, nvir_so, kp3, eo, ev)
    U_dev = to_device(U)
    d2 = (eo[0][:, None, None, None] + eo[0][None, :, None, None]
          - ev[0][None, None, :, None] - ev[0][None, None, None, :])
    t1 = jnp.zeros((1, nocc_so, nvir_so), jnp.complex128)
    t2 = {(0, 0, 0): to_device(
        np.conj(U[0, 0, 0, :nocc_so, :nocc_so, nocc_so:, nocc_so:])
        / d2)}
    adiis = DIIS(space=diis_space)
    vec_old = _pack(t1, t2, 1)
    conv = False
    for it in range(max_cycle):
        t1n, t2n, e_dev = step(t1, t2, U_dev)
        vec_new = _pack(t1n, t2n, 1)
        err = vec_new - vec_old
        dt = float(np.linalg.norm(err) / np.sqrt(err.size))
        vec_old = adiis.update(vec_new, err)
        t1, t2 = jax.jit(_unpack_dev, static_argnums=(1, 2, 3))(
            to_device(vec_old), 1, nocc_so, nvir_so)
        if dt < conv_tol:
            conv = True
            break
    assert conv, "embedded CCSD did not converge"
    _, _, e_dev = step(t1, t2, U_dev)
    e_corr = complex(to_host(e_dev))

    gam_blocks, lam = lambda_rdm(1, nocc_so, nvir_so, kp3, eo, ev,
                                 t1, t2, U_dev)
    gam2_so = lambda_rdm2(1, nocc_so, nvir_so, kp3, eo, ev, t1, t2,
                          U_dev, lam=lam, gam1=gam_blocks)[0, 0, 0]
    goo, gov, gvo, gvv = gam_blocks
    g_so = np.block([[goo[0], gov[0]], [gvo[0], gvv[0]]])
    # spin-orbital -> spatial MO (fci conventions):
    #   gamma[m,n]      = sum_s <m_s+ n_s>
    #   Gamma[m,n,k,l]  = sum_st <m_s+ k_t+ l_t n_s> = Gamma_as[m,k,n,l]
    g_mo = np.zeros((n, n), dtype=complex)
    g2_mo = np.zeros((n,) * 4, dtype=complex)
    for s1 in range(2):
        sel1 = np.where(spin == s1)[0]
        m1 = spat[sel1]
        g_mo[np.ix_(m1, m1)] += g_so[np.ix_(sel1, sel1)]
        for s2 in range(2):
            sel2 = np.where(spin == s2)[0]
            m2 = spat[sel2]
            g2_mo[np.ix_(m1, m1, m2, m2)] += gam2_so[
                np.ix_(sel1, sel2, sel1, sel2)].transpose(0, 2, 1, 3)
    # back to the input basis: a_p+ = sum_m conj(C[p,m]) a_m+
    g_out = np.einsum("pm,mn,qn->pq", c_mo.conj(), g_mo, c_mo)
    g2_out = np.einsum("pm,qn,rk,sl,mnkl->pqrs", c_mo.conj(), c_mo,
                       c_mo.conj(), c_mo, g2_mo, optimize=True)
    # NB: truncated CC energies on complex Hermitian integrals carry a
    # genuine (small) imaginary part unless symmetry forces reality —
    # the density reconstruction must match it exactly, and the solver
    # returns the real part.
    e_elec = e_hf + e_corr
    e_check = (np.einsum("pq,pq->", h1, g_out)
               + 0.5 * np.einsum("pqrs,pqrs->", eri, g2_out))
    assert abs(e_check - e_elec) < 1e-7 * max(1.0, abs(e_elec)), \
        (e_check, e_elec)
    return float(np.real(e_elec)), g_out, g2_out


def _vhf_chem(eri, gamma):
    """Closed-shell HF potential for chemists' (pq|rs) and
    gamma[p,q] = <p+ q> (spin-summed)."""
    j = np.einsum("pqrs,rs->pq", eri, gamma)
    k = np.einsum("plrq,rl->pq", eri, gamma)
    return j - 0.5 * k


def onerdm(df, mf, conv_tol=1e-8, max_cycle=80, verbose=0):
    """Unrelaxed CCSD one-particle density matrix in the spin-orbital MO
    basis, per k-point: blocks (goo, gov, gvo, gvv) + reference part.
    Returns (gamma_blocks, info); info carries natural-occupation sums
    per k (trace check: sum_k tr(gamma_k) = nk * nocc_so)."""
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose, return_amps=True)
    if not info["converged"]:
        raise RuntimeError("kccsd did not converge")
    if info.get("reference") == "fock":
        raise NotImplementedError(
            "the Lambda/RDM path assumes a canonical HF reference")
    nk = df.nkpt
    gam, lam = lambda_rdm(nk, info["nocc"], info["ev"].shape[1],
                          info["kp3"], info["eo"], info["ev"],
                          info["t1"], info["t2"], info["U"])
    goo, gov, gvo, gvv = gam
    info["e_ccsd"] = e_cc
    info["trace"] = float(sum(np.trace(goo[k]).real
                              + np.trace(gvv[k]).real
                              for k in range(nk)))
    return gam, info


def ao_density(df, mf, conv_tol=1e-8, max_cycle=80, verbose=0):
    """Spin-resolved AO-basis CCSD one-particle density per k-point,
    shaped (2, nk, nao, nao) — plug-compatible with scf.analysis
    (Mulliken/Loewdin populations, moments) for correlated observables.

    dm_s[k] = C_s gamma_s C_s^dag with gamma the unrelaxed CCSD density
    (onerdm) and C the spin-s spin-orbital coefficient columns."""
    gam, info = onerdm(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose)
    goo, gov, gvo, gvv = gam
    cs, _, spins, nocc = _spinorb_mo(mf)
    nk = df.nkpt
    nao = cs.shape[1]
    dm = np.zeros((2, nk, nao, nao), dtype=complex)
    for k in range(nk):
        g = np.block([[goo[k], gov[k]], [gvo[k], gvv[k]]])
        for s in range(2):
            sel = spins[k] == s
            c = cs[k][:, sel]
            dm[s, k] = c @ g[np.ix_(sel, sel)] @ c.conj().T
    return dm, info


def eom_qp(nk, nocc, nvir, kp3, eo_, ev_, t1_host, t2_host, U_host,
           sector):
    """k-resolved EOM-IP/EA-CCSD eigenvalues via the continuum-orbital
    trick: augment every k with one *phantom* orbital (zero integrals,
    energy 0) — virtual for IP, occupied for EA.  The phantom decouples,
    so the ground amplitudes are the physical ones zero-padded, and the
    CCSD Jacobian block on amplitudes carrying exactly one phantom index
    IS the IP (1h + 2h1p) / EA (1p + 2p1h) EOM matrix: an excitation
    into (out of) the non-interacting orbital at e = 0 costs exactly
    E(N-1) - E(N)  (E(N+1) - E(N)).  Grouping by the phantom's k-point
    resolves the quasiparticle spectrum by crystal momentum.

    Inputs are HOST arrays (augmentation re-embeds them); returns
    {k: sorted complex eigenvalues}.  Gated against the determinant-
    space Hbar blocks on the (N-1)/(N+1) sectors (tests/test_cc.py).
    """
    assert sector in ("ip", "ea")
    nso = nocc + nvir
    if sector == "ip":
        no_a, nv_a = nocc, nvir + 1
        m = np.arange(nso)                   # originals keep positions
        eo_a = eo_
        ev_a = np.concatenate([ev_, np.zeros((nk, 1))], axis=1)
        t1_a = np.concatenate([t1_host, np.zeros((nk, nocc, 1),
                                                 t1_host.dtype)], axis=2)

        def phantom(label):
            if label[0] == "s":
                _, k, i, a = label
                return (k if a == nvir else None)
            _, ki, i, kj, j, ka, a, kb, b = label
            cnt = (a == nvir) + (b == nvir)
            if cnt != 1:
                return None
            return ka if a == nvir else kb
    else:
        no_a, nv_a = nocc + 1, nvir
        m = np.concatenate([np.arange(nocc), np.arange(nocc + 1,
                                                       nso + 1)])
        eo_a = np.concatenate([eo_, np.zeros((nk, 1))], axis=1)
        ev_a = ev_
        t1_a = np.concatenate([t1_host, np.zeros((nk, 1, nvir),
                                                 t1_host.dtype)], axis=1)

        def phantom(label):
            if label[0] == "s":
                _, k, i, a = label
                return (k if i == nocc else None)
            _, ki, i, kj, j, ka, a, kb, b = label
            cnt = (i == nocc) + (j == nocc)
            if cnt != 1:
                return None
            return ki if i == nocc else kj

    nso_a = no_a + nv_a
    cdt = (jnp.complex128 if U_host.dtype == np.complex128
           else jnp.complex64)
    U_a = np.zeros((nk, nk, nk) + (nso_a,) * 4, dtype=U_host.dtype)
    U_a[np.ix_(range(nk), range(nk), range(nk), m, m, m, m)] = U_host
    t2_a = {}
    for ki in range(nk):
        for kj in range(nk):
            for ka in range(nk):
                blk = np.zeros((no_a, no_a, nv_a, nv_a),
                               dtype=t1_host.dtype)
                if sector == "ip":
                    blk[:, :, :nvir, :nvir] = t2_host[ki, kj, ka]
                else:
                    blk[:nocc, :nocc] = t2_host[ki, kj, ka]
                t2_a[ki, kj, ka] = to_device(blk, dtype=cdt)
    jac = _jacobian(nk, no_a, nv_a, kp3, eo_a, ev_a,
                    to_device(t1_a, dtype=cdt), t2_a,
                    to_device(U_a, dtype=cdt))
    labels, bmat = _amp_basis(nk, no_a, nv_a, kp3)
    out = {}
    for k in range(nk):
        sel = [ii for ii, lb in enumerate(labels) if phantom(lb) == k]
        b = bmat[:, sel]
        out[k] = np.sort_complex(np.linalg.eigvals(b.T @ jac @ b))
    return out


def _eom_qp_driver(df, mf, sector, conv_tol=1e-8, max_cycle=80,
                   verbose=0):
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose, return_amps=True)
    if not info["converged"]:
        raise RuntimeError("kccsd did not converge; EOM needs R = 0")
    if info.get("reference") == "fock":
        raise NotImplementedError(
            "EOM assumes a canonical (diagonal-fock HF) reference")
    nk = df.nkpt
    t2_host = {key: to_host(v) for key, v in info["t2"].items()}
    w = eom_qp(nk, info["nocc"], info["ev"].shape[1], info["kp3"],
               info["eo"], info["ev"], to_host(info["t1"]), t2_host,
               to_host(info["U"]), sector)
    info["e_ccsd"] = e_cc
    return w, info


def eomip(df, mf, **kw):
    """k-resolved EOM-IP-CCSD: {k: eigenvalues of E(N-1) - E(N)}
    (correlated hole/valence-band energies).  See eom_qp."""
    return _eom_qp_driver(df, mf, "ip", **kw)


def eomea(df, mf, **kw):
    """k-resolved EOM-EA-CCSD: {k: eigenvalues of E(N+1) - E(N)}
    (correlated electron-attachment/conduction energies).  See eom_qp."""
    return _eom_qp_driver(df, mf, "ea", **kw)


# ----------------------------------------------------------------------
# perturbative triples: CCSD(T)
# ----------------------------------------------------------------------

def make_t3_energy(nk, nocc, nvir, kp3, eo, ev, chunk=None):
    """Build the jitted (T) energy ``energy_t(t1, t2, U) -> e`` (supercell
    normalization, like make_step).

      W[ijk,abc] = P(i/jk) P(a/bc) [ sum_e t2_jk^ae <bc||ei>
                                     - sum_m t2_im^bc <ma||jk> ]
      t3c = W / D3,   D3 t3d = P(i/jk) P(a/bc) t1_ia conj(<jk||bc>)
      E(T) = 1/36 sum conj(t3c + t3d) W

    Complex-safe index orders by the same vertex rule as make_step: the
    real-orbital literature's <ei||bc> becomes <bc||ei> (external
    particles in the bra) and the disconnected driving pairs t1 with
    conj(<jk||bc>) — both, like every term here, gated against the
    determinant-space oracle (tests/test_cc.py) which evaluates
    <Phi3|H T2|0> and <0|T1,2^dag H T3|0> literally.

    Momentum structure: triple blocks [ki,kj,kk,ka,kb] with kc fixed by
    conservation and NO internal k sums — so the nk^5 blocks are a flat
    batch.  Accelerator-first shape: all per-block gather indices (for the nine
    P(i/jk)P(a/bc) label permutations) are precomputed host-side, the
    block batch is processed by ``lax.map`` over chunks of batched
    einsums (one trace regardless of nk; gathers feed the matmul
    contractions), and the energy is reduced on device.  ``chunk``
    bounds the per-step tensor to chunk * o^3 v^3 entries.
    """
    o_sl = (slice(0, nocc), slice(nocc, nocc + nvir))
    kp3 = np.asarray(kp3)

    def kp(a, b, c):
        return kp3[a, b, c]

    perms = [((0, 1, 2), 1.0), ((1, 0, 2), -1.0), ((2, 1, 0), -1.0)]
    # host-side block label table (B, 6)
    grids = np.stack(np.meshgrid(*([np.arange(nk)] * 5),
                                 indexing="ij"), axis=-1).reshape(-1, 5)
    ki, kj, kk, ka, kb = grids.T
    kc = kp(kp(ki, kj, ka), kk, kb)
    labels = np.stack([ki, kj, kk, ka, kb, kc], axis=1)
    nblk = labels.shape[0]

    # per-permutation gather indices (static axes transposes)
    tables = []
    for po, so in perms:
        for pv, sv in perms:
            lo = labels[:, [po[0], po[1], po[2]]]
            lv = labels[:, [3 + pv[0], 3 + pv[1], 3 + pv[2]]]
            pki, pkj, pkk = lo.T
            pka, pkb, pkc = lv.T
            ke = kp(pkj, pkk, pka)
            km = kp(pkb, pkc, pki)
            tables.append(dict(
                sign=so * sv,
                ax=tuple(po) + tuple(3 + p for p in pv),
                t2_1=np.stack([pkj, pkk, pka], 1),   # t2[kj,kk,ka]
                u_1=np.stack([pkb, pkc, ke], 1),     # <bc||ei>
                t2_2=np.stack([pki, km, pkb], 1),    # t2[ki,km,kb]
                u_2=np.stack([km, pka, pkj], 1),     # <ma||jk>
                disc=(pka == pki).astype(np.float64),
                t1_d=pki,
                u_d=np.stack([pkj, pkk, pkb], 1),    # conj(<jk||bc>)
            ))

    if chunk is None:
        chunk = max(1, min(nblk, int(2 ** 22 // max(
            nocc ** 3 * nvir ** 3, 1)) or 1))
    pad = (-nblk) % chunk
    nchunks = (nblk + pad) // chunk

    def _pad(x, fill=0):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                          x.dtype)]) if pad else x

    idx = {}
    for t, tab in enumerate(tables):
        for key in ("t2_1", "u_1", "t2_2", "u_2", "t1_d", "u_d", "disc"):
            idx[t, key] = jnp.asarray(
                _pad(tab[key]).reshape((nchunks, chunk)
                                       + tab[key].shape[1:]))
    d3_eo = [jnp.asarray(_pad(eo[labels[:, x]]).reshape(nchunks, chunk,
                                                        nocc))
             for x in range(3)]
    # pad the virtual energies with 1.0 so padded rows keep d3 != 0
    # (their contribution is masked, but 0/0 would still NaN the sum)
    d3_ev = [jnp.asarray(_pad(ev[labels[:, 3 + x]], 1.0).reshape(
        nchunks, chunk, nvir)) for x in range(3)]
    # padded rows: labels are all-zero blocks — mask their contribution
    mask = jnp.asarray(_pad(np.ones(nblk)).reshape(nchunks, chunk))

    o, v = o_sl

    def energy_t(t1, t2, U):
        ein = jnp.einsum
        T2 = jnp.stack([jnp.stack([jnp.stack(
            [t2[a, b, c] for c in range(nk)]) for b in range(nk)])
            for a in range(nk)])
        Uoo = U  # full; sliced per gather below

        def g3(arr, ix):
            return arr[ix[:, 0], ix[:, 1], ix[:, 2]]

        def body(c):
            w = 0.0
            d = 0.0
            for t in range(len(tables)):
                tab = tables[t]
                t2a = g3(T2, idx[t, "t2_1"][c])
                ua = g3(Uoo, idx[t, "u_1"][c])[:, v, v, v, o]
                x = ein("xjkae,xbcei->xijkabc", t2a, ua)
                t2b = g3(T2, idx[t, "t2_2"][c])
                ub = g3(Uoo, idx[t, "u_2"][c])[:, o, v, o, o]
                x = x - ein("ximbc,xmajk->xijkabc", t2b, ub)
                w = w + tab["sign"] * jnp.transpose(
                    x, (0,) + tuple(1 + a for a in tab["ax"]))
                t1d = t1[idx[t, "t1_d"][c]]
                ud = g3(Uoo, idx[t, "u_d"][c])[:, o, o, v, v].conj()
                dd = ein("x,xia,xjkbc->xijkabc",
                         idx[t, "disc"][c].astype(ud.dtype), t1d, ud)
                d = d + tab["sign"] * jnp.transpose(
                    dd, (0,) + tuple(1 + a for a in tab["ax"]))
            d3 = (d3_eo[0][c][:, :, None, None, None, None, None]
                  + d3_eo[1][c][:, None, :, None, None, None, None]
                  + d3_eo[2][c][:, None, None, :, None, None, None]
                  - d3_ev[0][c][:, None, None, None, :, None, None]
                  - d3_ev[1][c][:, None, None, None, None, :, None]
                  - d3_ev[2][c][:, None, None, None, None, None, :])
            t3 = w / d3
            contrib = jnp.sum((t3 + d / d3).conj() * w,
                              axis=(1, 2, 3, 4, 5, 6))
            return jnp.sum(contrib * mask[c].astype(contrib.dtype)) / 36.0

        es = jax.lax.map(body, jnp.arange(nchunks))
        return jnp.sum(es)

    return jax.jit(energy_t)


def kccsd_t(df, mf, conv_tol=1e-7, max_cycle=60, diis_space=8, verbose=0):
    """CCSD(T) from a converged KRHF/KUHF ``mf``: runs kccsd, then the
    perturbative-triples correction.  Returns (e_ccsd, e_t, info) —
    correlation energies per cell."""
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       diis_space=diis_space, verbose=verbose,
                       return_amps=True)
    if info.get("reference") == "fock":
        raise NotImplementedError(
            "(T) assumes a canonical (diagonal-fock HF) reference")
    nk = df.nkpt
    nocc = info["nocc"]
    nvir = info["ev"].shape[1]
    if nocc < 3 and nk * nocc < 3:
        info["imag_t"] = 0.0
        return e_cc, 0.0, info          # fewer than 3 electrons: no triples
    fn = make_t3_energy(nk, nocc, nvir, info["kp3"], info["eo"],
                        info["ev"])
    e_t = complex(to_host(fn(info["t1"], info["t2"], info["U"]))) / nk
    info["imag_t"] = float(e_t.imag)
    return e_cc, float(e_t.real), info
