"""Sharded ISDF build and J/K serving over a device mesh.

Sharding layout (original design; the reference is single-process —
SURVEY.md section 2c):

  stage 1 (RHS sweep):   grid axis sharded over 'd' (shard_map: each device
                         streams ITS contiguous grid blocks through the SAME
                         ``_sweep_chunk_body`` the single-chip build jits,
                         accumulating the half-solved g planes in their
                         final real-plane layout)
  <reshard: one all-to-all over the interconnect on the two real planes>
  stage 2 (spectral+gram): sector axis sharded; each device runs the SAME
                         ``_spectral_body`` (every row FFT'd exactly once,
                         sqrt-Coulomb scaled) and ``_sector_gram_body``
                         (triangular real-gemm gram + finish polynomial)
                         over its local sectors — no communication inside
                         the stage
  serve (J/K):           the image-space cos/sin gemm serve
                         (isdf.jk.get_k_kpts_img) with the image axis of
                         the precomputed metric sharded

One implementation, two drivers (round-3 verdict item #2): the stage
*bodies* live in isdf.kpoint and are shared verbatim — the production
hardening (real-plane g storage, donated/in-place spectral transform,
triangular gram, cos/sin serve) exists exactly once.  The naive per-sector
``_sector_wq`` form survives only for the small-problem consumers
(isdf.bands per-pair re-fits, the autodiff force sweep).

Parity with the single-chip build: the same time-reversal sector halving
(w_{-q} = conj(w_q); only canonical sectors run, and only their planes
cross the all-to-all), the same solver/rcond/refine knobs through
``_chunk_factors``, and the same HBM-budgeted sector chunking — scaled by
the device count (the multi-chip replacement for the reference's HDF5
spill, ``/root/reference/fftisdf.py:60-64``).  Truncated (signed) Coulomb
kernels run through the dynamic ``sign`` operand of the gram (every device
executes one program, so the single-chip path's static per-sector
``neg_cols`` indices are not expressible here; gated in
tests/test_coulomb_trunc.py).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.lax import with_sharding_constraint
from jax.sharding import NamedSharding, PartitionSpec as P

from fftisdf_tpu.basis.eval import make_evaluator
from fftisdf_tpu.lattice import kpoints as kpt_mod
from fftisdf_tpu.isdf.kpoint import (
    _chunk_factors, _sweep_chunk_body, _spectral_body, _sector_gram_body,
    _eiqr_kernel, _sqrt_kernel, _take_rows, _take_cols, _scatter_trs,
    _trs_sweep_inputs, get_coulG_batched)
from fftisdf_tpu.isdf import jk as jk_mod
from fftisdf_tpu.parallel.mesh import sector_sharding, replicated
from fftisdf_tpu.utils.device import to_device


def plan_sharded(ngrid, nip, ndev, nsec, *, dtype, max_memory_gb=12.0,
                 blksize=16384):
    """Sizing plan of the sharded build (shared with the AOT proof so the
    lowered program is exactly the one the runtime would execute):

    - grid blocks: contiguous per-device segments (nblk divisible by ndev
      so the shard_map split is even; the zero-coordinate pad tail is
      wiped by the spectral stage's zero-padded writeback, exactly as on
      one chip);
    - row slabs (rblk) sized so one slab's FFT working set (~4x the slab,
      Bluestein padding — the measured single-chip factor) fits the
      per-device budget share;
    - sector chunks (qchunk, a device-count multiple): a chunk holds both
      real g planes split over ndev."""
    itemsize = 16 if dtype == jnp.float64 else 8
    blk = min(int(blksize), -(-ngrid // ndev))
    if dtype != jnp.float64:
        blk = min(blk, 512)
    nblk = -(-ngrid // blk)
    nblk = -(-nblk // ndev) * ndev
    ngrid_pad = nblk * blk
    rblk = 128
    for cand in range(128, min(nip, 2048) + 127, 128):
        if (cand * ngrid_pad * itemsize / 1e9) * 4.0 > max_memory_gb / 4:
            break
        rblk = cand
    nrb = -(-nip // min(rblk, nip))
    rblk = -(-(-(-nip // nrb)) // 8) * 8
    nip_pad = nrb * rblk
    plane_gb = 2.0 * nip_pad * ngrid_pad * (itemsize / 2) / 1e9
    budget_gb = max_memory_gb - max(0.05 * max_memory_gb, 0.4)
    qchunk = max(1, ndev)
    for nq in range(ndev, nsec + ndev, ndev):
        if nq * plane_gb / ndev > budget_gb / 2:
            break
        qchunk = nq
    qchunk = min(qchunk, -(-nsec // ndev) * ndev)
    return dict(blk=blk, nblk=nblk, ngrid_pad=ngrid_pad, rblk=rblk,
                nip_pad=nip_pad, plane_gb=plane_gb, qchunk=qchunk)


def make_chunk_step(*, fn, dev_mesh, fmesh, ngrid, rblk, nip_pad, kind,
                    signed, rdtype):
    """The jitted per-chunk sharded program: grid-sharded sweep -> one
    all-to-all -> sector-sharded spectral+gram, built from the SAME stage
    bodies the single-chip pipeline jits (isdf.kpoint).  Factored out so
    the AOT proof (examples/multichip_aot.py) can lower/compile it at
    production shapes without materializing any data."""

    def _rhs_local(coords_loc, x_k, phase_full, phase_cols, data_c):
        """Per-device RHS sweep over the local grid blocks — the
        single-chip stage body verbatim."""
        return _sweep_chunk_body(coords_loc, x_k, phase_full, phase_cols,
                                 data_c, fn=fn, kind=kind, nip_pad=nip_pad)

    def _sector_local(g_re, g_im, eiqr_c, sqk_c, data_c, sign_c):
        """Per-device spectral transform + gram over the local sectors —
        the single-chip stage bodies verbatim."""
        g_re, g_im = _spectral_body(g_re, g_im, eiqr_c, sqk_c, mesh=fmesh,
                                    ngrid=ngrid, rblk=rblk)
        nq_loc = g_re.shape[0]
        out = []
        for iq in range(nq_loc):
            data_q = jax.tree_util.tree_map(lambda a: a[iq], data_c)
            wq_q, _ = _sector_gram_body(
                g_re, g_im, data_q, q=iq, rblk=rblk, kind=kind,
                sign=sign_c[iq] if signed else None)
            out.append(wq_q)
        return jnp.stack(out)

    pspec = lambda *axes: P(*axes)
    data_spec = lambda d: jax.tree_util.tree_map(lambda _: P("d"), d)

    @jax.jit
    def chunk_step(coords_p, x_k, phase_full, phase_cols, data_c, eiqr_c,
                   sqk_c, sign_c):
        # stage 1: grid-sharded sweep (real g planes in final layout)
        # check_vma off: the sweep's fori_loop carry starts as an
        # unvarying zeros buffer and becomes device-varying on the first
        # block write — sound here (each device owns its grid segment)
        g_re, g_im = jax.shard_map(
            _rhs_local, mesh=dev_mesh,
            in_specs=(pspec("d"), pspec(), pspec(), pspec(),
                      jax.tree_util.tree_map(lambda _: P(), data_c)),
            out_specs=(pspec(None, None, "d"), pspec(None, None, "d")),
            check_vma=False,
        )(coords_p, x_k, phase_full, phase_cols, data_c)
        # reshard: ONE all-to-all into the sector layout
        sshard = NamedSharding(dev_mesh, P("d", None, None))
        g_re = with_sharding_constraint(g_re, sshard)
        g_im = with_sharding_constraint(g_im, sshard)
        # stage 2: sector-sharded spectral + gram
        wq_c = jax.shard_map(
            _sector_local, mesh=dev_mesh,
            in_specs=(pspec("d"), pspec("d"), pspec("d"), pspec("d"),
                      data_spec(data_c),
                      pspec("d") if signed else pspec()),
            out_specs=pspec("d"),
            check_vma=False,
        )(g_re, g_im, eiqr_c, sqk_c, data_c,
          sign_c if signed else jnp.zeros((1, 1), rdtype))
        return with_sharding_constraint(wq_c, sshard)

    return chunk_step


def build_wq_sharded(cell, kpts, x_k, phase, dev_mesh, solver="lstsq",
                     rcond=1e-10, dtype=jnp.float64, refine=None,
                     use_trs=True, max_memory_gb=12.0, blksize=16384,
                     trunc=None, omega=0.0, log=None):
    """Compute w_q over the device mesh with the production four-stage
    pipeline.  Returns wq (nk, nip, nip), sector-sharded.  Sector chunks
    are padded to a device-count multiple (duplicate sectors, results
    dropped) so every shard runs the same program.

    ``omega``: range-separated (screened) Coulomb kernel, same erf/erfc
    convention as the single-chip ``FFTISDF.get_wq_omega`` (exclusive
    with ``trunc``; linalg.coulomb.check_trunc enforces that)."""
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    rdtype = jnp.float64 if dtype == jnp.float64 else jnp.float32
    itemsize = 16 if dtype == jnp.float64 else 8
    ndev = int(np.prod([dev_mesh.shape[ax] for ax in dev_mesh.axis_names]))
    coords = cell.gen_uniform_grids()
    ngrid = coords.shape[0]
    fmesh = tuple(int(m) for m in cell.mesh)
    vol = float(cell.vol)
    nk, nip, nao = x_k.shape
    kind = "ridge" if solver == "ridge" else "eigh"

    # Coulomb kernels / q-phases built on device from small inputs (as in
    # the single-chip build: no large host complex arrays)
    gv = jnp.asarray(cell.get_Gv(fmesh), dtype=dtype)
    kpts_d = jnp.asarray(np.asarray(kpts), dtype=dtype)
    coords_d = jnp.asarray(coords, dtype=dtype)
    coulG = get_coulG_batched(cell, kpts_d, gv, dtype=dtype, trunc=trunc,
                              omega=omega)
    eiqr = _eiqr_kernel(coords_d, kpts_d).astype(cdtype)
    phase_dev = to_device(phase, dtype=cdtype)
    sqk = _sqrt_kernel(coulG, vol / ngrid**2)

    # ---- time-reversal sector halving (identical to the single-chip
    # build, isdf.kpoint.FFTISDF._metric_pass)
    s_kpts = cell.get_scaled_kpts(np.asarray(kpts))
    mirror = np.array([kpt_mod.member(-s_kpts[q], s_kpts, strict=False)
                       for q in range(nk)])
    if use_trs and not (mirror < 0).any():
        qsel = np.array([q for q in range(nk) if q <= mirror[q]])
    else:
        qsel = np.arange(nk)
    nsec = len(qsel)

    # sweep producers on the TRS-canonical k half (same identity as the
    # single-chip build; the sector stages are unaffected)
    sweep_in = (_trs_sweep_inputs(cell, kpts, mirror, x_k, phase_dev,
                                  dtype) if use_trs else None)
    if sweep_in is None:
        sweep_in = (make_evaluator(cell, kpts=kpts, dtype=dtype),
                    x_k, phase_dev)
    fn, x_sw, phase_sw = sweep_in

    plan = plan_sharded(ngrid, nip, ndev, nsec, dtype=dtype,
                        max_memory_gb=max_memory_gb, blksize=blksize)
    blk, nblk, rblk, nip_pad, qchunk = (
        plan["blk"], plan["nblk"], plan["rblk"], plan["nip_pad"],
        plan["qchunk"])
    pad = nblk * blk - ngrid
    coords_p = jnp.asarray(np.concatenate(
        [coords, np.zeros((pad, 3))], axis=0).reshape(nblk, blk, 3),
        dtype=dtype)
    ngrid_pad = nblk * blk
    plane_gb = plan["plane_gb"]
    if log is not None:
        log.info("build_sharded: nk=%d (canonical %d) nip=%d ngrid=%d "
                 "ndev=%d qchunk=%d rblk=%d (planes/device %.2f GB/chunk)",
                 nk, nsec, nip, ngrid, ndev, qchunk,
                 rblk, min(qchunk, nsec) * plane_gb / ndev)

    signed = trunc is not None
    sign = (jnp.where(jnp.pad(coulG, ((0, 0), (0, pad)),
                              constant_values=1.0) < 0,
                      -1.0, 1.0).astype(rdtype) if signed else None)

    chunk_step = make_chunk_step(fn=fn, dev_mesh=dev_mesh, fmesh=fmesh,
                                 ngrid=ngrid, rblk=rblk, nip_pad=nip_pad,
                                 kind=kind, signed=signed, rdtype=rdtype)

    wq_parts = []
    for q0 in range(0, nsec, qchunk):
        qs = qsel[q0:q0 + qchunk]
        # pad the chunk to a device-count multiple with duplicate sectors
        # (every shard runs the same program; dup results are dropped)
        nq_pad = -(-len(qs) // ndev) * ndev
        qs_pad = np.concatenate([qs, np.repeat(qs[-1:], nq_pad - len(qs))])
        qs_j = jnp.asarray(qs_pad)
        data_c = _chunk_factors(x_k, phase_dev, qs_j, nq=nq_pad,
                                solver=solver, rcond=rcond, refine=refine)
        wq_c = chunk_step(
            coords_p, x_sw, phase_sw, _take_cols(phase_dev, qs_j), data_c,
            _take_rows(eiqr, qs_j), _take_rows(sqk, qs_j),
            _take_rows(sign, qs_j) if signed else None)
        wq_parts.append(wq_c[:len(qs)])
    wq_sel = (jnp.concatenate(wq_parts, axis=0) if len(wq_parts) > 1
              else wq_parts[0])

    sshard = sector_sharding(dev_mesh)
    if nsec < nk:
        pos_of = {int(q): i for i, q in enumerate(qsel)}
        order = np.empty(nk, dtype=np.int64)
        conj_flag = np.zeros(nk, dtype=bool)
        for q in range(nk):
            if q in pos_of:
                order[q] = pos_of[q]
            else:
                order[q] = pos_of[int(mirror[q])]
                conj_flag[q] = True
        scatter = jax.jit(
            lambda w, o, c: with_sharding_constraint(
                _scatter_trs(w, o, c), sshard))
        return scatter(wq_sel, jnp.asarray(order), jnp.asarray(conj_flag))
    return jax.jit(lambda w: with_sharding_constraint(w, sshard))(wq_sel)


def build_sharded(df, dev_mesh):
    """Sharded analog of FFTISDF.build(): same selection, sharded state
    build, SAME accuracy knobs (solver/rcond/refine/use_trs resolved by the
    FFTISDF object, so dtype-aware defaults are identical on both paths)."""
    from fftisdf_tpu.isdf.kpoint import select_interpolation_points

    x_k, mask, rank, m0_used = select_interpolation_points(
        df.cell, df.kpts, df.m0, df.c0, dtype=df.dtype,
        select_tol=df.select_tol, log=df._log,
        host_f64=df.select_host_f64,
        auto_densify=getattr(df, "_m0_auto", False),
        use_trs=df.use_trs, keep_tol=getattr(df, "select_keep", None))
    df.m0 = m0_used
    df.mask = mask
    phase = df.phase
    df.x_k = jax.device_put(x_k, replicated(dev_mesh))
    df.wq = build_wq_sharded(df.cell, df.kpts, df.x_k, phase, dev_mesh,
                             solver=df.solver, rcond=df.rcond,
                             dtype=df.dtype, refine=df.refine,
                             use_trs=df.use_trs,
                             max_memory_gb=df.max_memory_gb,
                             blksize=df.blksize, trunc=df.trunc,
                             log=df._log)
    return df


def get_jk_sharded(df, dm_kpts, dev_mesh):
    """J/K with the metric sharded over the mesh (serving path).

    Runs the production serve kernels — J through the q=0 metric, K
    through the image-space cos/sin gemm form (isdf.jk.get_k_kpts_img) —
    with the
    density-independent image metric ws sharded along its image axis.
    The ws precompute (one k-axis inverse FFT of wq) is cached on the df
    object across calls, exactly like the single-chip ``get_ws``."""
    sshard = sector_sharding(dev_mesh)
    kmesh = tuple(int(m) for m in df.kmesh)

    if getattr(df, "_ws_sharded", None) is None:
        df._ws_sharded = jax.jit(
            lambda wq: with_sharding_constraint(
                jk_mod.wq_to_ws(with_sharding_constraint(wq, sshard),
                                kmesh), sshard))(df.wq)
    ws = df._ws_sharded

    @jax.jit
    def step(x_k, w0, ws, dm):
        ws = with_sharding_constraint(ws, sshard)
        vj = jk_mod.get_j_kpts(x_k, w0, dm[None])[0]
        vk = jk_mod.get_k_kpts_img(x_k, ws, dm[None], kmesh)[0]
        return vj, vk

    w0 = jax.jit(lambda w: w[0])(df.wq)
    return step(df.x_k, w0, ws, to_device(dm_kpts, dtype=df.wq.dtype))
