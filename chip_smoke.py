"""Smoke run of the production path on one NVIDIA GPU.

Drives the user entry points -- ``FFTISDF(...).build()``, ``get_jk`` and
``scf.device.DeviceKUHF`` -- at the reference driver's production
configuration (NiO AFM, 4x4x4 k-mesh, gth-dzvp-molopt-sr, gth-pade,
ke_cutoff=200, c0=40, m0=15^3), then checks accuracy on the 2x2x2 sub-mesh
with the same basis, cutoff and compression, where the exact plane-wave
oracle fits one card:

  production  cold build (wall time includes compile), one J+K serve of a
              time-reversal-symmetric test density, three DeviceKUHF
              cycles (AFM init_spin, Fermi smearing 5e-3); the test
              density is ``bench.trs_test_density``; every energy
              and every vj/vk entry must be finite.
  accuracy    (a) ISDF vs exact plane-wave vj/vk, bound 1e-2 x scale (the
              compression floor); (b) the card's serve vs the same serve
              in complex128 numpy on the host from the same x_k/w_q,
              bound 1e-4 x scale (catches a lost matmul precision: f32
              products at 'highest' land near 1e-6, TF32 near 1e-3).
  --four      only: the sharded build and serve over four cards
              (``parallel.build_sharded`` + ``get_jk_sharded``) against
              the one-card build in the same process, bound 1e-3 x
              max|vk|.

Any failed check raises, so the process exits non-zero.  With no GPU the
script exits non-zero before any phase runs.  The last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage:  python chip_smoke.py [--four]
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Config:
    system: str = "nio"
    basis: str = "gth-dzvp-molopt-sr"
    ke_cutoff: float = 200.0
    kmesh: tuple = (4, 4, 4)
    c0: float = 40.0
    m0: tuple = (15, 15, 15)
    scf_cycles: int = 3
    smearing: float = 5e-3


PRODUCTION = Config()
ACCURACY = dataclasses.replace(PRODUCTION, kmesh=(2, 2, 2))

ISDF_VS_EXACT_TOL = 1e-2     # compression floor, relative to max|v_exact|
SERVE_VS_HOST_TOL = 1e-4     # f32 'highest' serve vs complex128 host serve
SHARDED_VS_ONE_TOL = 1e-3    # four-card vs one-card, relative to max|vk|


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power_limit():
    """``name, power.limit`` of every card, read by nvidia-smi in a child
    process (which never imports JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def make_cell(cfg):
    from fftisdf_tpu.lattice import structure

    if cfg.system == "nio":
        return structure.to_cell(*structure.nio_afm(), basis=cfg.basis,
                                 pseudo="gth-pade", ke_cutoff=cfg.ke_cutoff,
                                 exp_to_discard=0.1)
    return structure.to_cell(*structure.bulk_diamond(), basis=cfg.basis,
                             pseudo="gth-pade", ke_cutoff=cfg.ke_cutoff)


def init_spin(cfg):
    """AFM order on the two Ni sites; none for a closed-shell test cell."""
    return {0: +1.0, 1: -1.0} if cfg.system == "nio" else {}


def host_serve(x_k, wq, dm, kmesh):
    """The ISDF J/K serve in complex128 numpy: the plain phase-matrix
    algebra of ``isdf.jk.get_j_kpts`` / ``get_k_kpts`` on host copies of
    the device state."""
    x = np.asarray(x_k, dtype=np.complex128)
    wq = np.asarray(wq, dtype=np.complex128)
    nk = x.shape[0]
    rho = np.einsum("kIm,kIn,kmn->I", x, x.conj(), dm) / nk
    v = wq[0] @ rho
    vj = np.einsum("kIm,kIn,I->kmn", x.conj(), x, v)

    ii = np.indices(tuple(kmesh)).reshape(len(kmesh), -1).T
    phase = np.exp(2j * np.pi * ii @ (ii / np.asarray(kmesh)[None, :]).T)
    phase /= np.sqrt(nk)
    ws = np.einsum("Rq,qIJ->RIJ", phase, wq).real * np.sqrt(nk)
    rhok = (x @ dm) @ x.conj().transpose(0, 2, 1) / nk
    rhos = np.einsum("Rk,kIJ->RIJ", phase, rhok).real
    vk_q = np.einsum("Rk,RIJ->kIJ", phase, ws * rhos.transpose(0, 2, 1))
    vk = x.conj().transpose(0, 2, 1) @ vk_q @ x
    return vj, vk


def _max_abs(a):
    return float(np.max(np.abs(np.asarray(a))))


def _check(name, err, scale, tol):
    bound = tol * scale
    log(f"{name}: max_abs_err={err:.6e} scale={scale:.6e} "
        f"bound={bound:.6e}")
    if not err <= bound:
        raise AssertionError(f"{name}: {err:.6e} exceeds {bound:.6e}")


def _numerics():
    import jax

    return (f"matmul_precision={jax.config.jax_default_matmul_precision} "
            f"device={jax.devices()[0].platform}")


def production(cfg=PRODUCTION):
    """Build, serve and three device-resident KUHF cycles at ``cfg``."""
    import jax
    from bench import trs_test_density
    from fftisdf_tpu import native
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf.device import DeviceKUHF

    log(f"production: native engine "
        f"{'loaded' if native.load() is not None else 'NOT loaded'}")
    cell = make_cell(cfg)
    kpts = cell.get_kpts(list(cfg.kmesh))
    t0 = time.perf_counter()
    df = FFTISDF(cell, kpts, c0=cfg.c0, m0=cfg.m0, verbose=0).build()
    jax.block_until_ready((df.x_k, df.wq))
    t_build = time.perf_counter() - t0
    log(f"production: nk={len(kpts)} nao={cell.nao_nr()} "
        f"ngrid={int(np.prod(cell.mesh))} nip={df.nip} "
        f"nchunks={df._nchunks} dtype={df.wq.dtype} {_numerics()}")
    log(f"production: cold build wall {t_build:.3f} s (includes compile; "
        f"selection {df._t_select:.3f} s)")

    dm = trs_test_density(cell, kpts)
    t0 = time.perf_counter()
    vj, vk = jax.block_until_ready(df.get_jk(dm))
    log(f"production: first J+K serve wall {time.perf_counter() - t0:.4f} s "
        f"(includes compile)")
    t0 = time.perf_counter()
    vj, vk = jax.block_until_ready(df.get_jk(dm))
    log(f"production: warm J+K serve wall {time.perf_counter() - t0:.4f} s")
    for name, v in (("vj", vj), ("vk", vk)):
        if not np.isfinite(np.asarray(v)).all():
            raise AssertionError(f"production: {name} is not finite")
    log(f"production: max|vj|={_max_abs(vj):.6e} max|vk|={_max_abs(vk):.6e}")
    del vj, vk

    t0 = time.perf_counter()
    mf = DeviceKUHF(cell, kpts, with_df=df, verbose=0,
                    max_cycle=cfg.scf_cycles, init_spin=init_spin(cfg),
                    smearing=cfg.smearing)
    e_tot = mf.kernel()
    energies = list(mf.cycle_energies) + [e_tot]
    log(f"production: DeviceKUHF setup+{len(mf.cycle_energies)} cycles wall "
        f"{time.perf_counter() - t0:.3f} s, cycle walls "
        f"{[round(t, 4) for t in mf.cycle_times]}")
    log(f"production: cycle energies {mf.cycle_energies} (Ha), "
        f"host f64 E_tot {e_tot!r}")
    if len(mf.cycle_energies) != cfg.scf_cycles \
            or not np.isfinite(energies).all():
        raise AssertionError(f"production: bad SCF energies {energies}")
    stats = jax.devices()[0].memory_stats()
    peak = stats.get("peak_bytes_in_use") if stats else None
    log(f"production: peak_bytes_in_use={peak if peak is not None else 'not measured'}")
    return {"nip": int(df.nip), "nchunks": int(df._nchunks),
            "build_s": t_build, "energies": energies, "peak_bytes": peak}


def accuracy(cfg=ACCURACY):
    """ISDF vs the exact plane-wave oracle, and the device serve vs the
    same serve in complex128 on the host."""
    import jax
    import jax.numpy as jnp
    from bench import trs_test_density
    from fftisdf_tpu.basis.eval import make_evaluator
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.pw import jk as pw_jk

    cell = make_cell(cfg)
    kpts = cell.get_kpts(list(cfg.kmesh))
    df = FFTISDF(cell, kpts, c0=cfg.c0, m0=cfg.m0, verbose=0).build()
    dm = trs_test_density(cell, kpts)
    vj, vk = jax.block_until_ready(df.get_jk(dm))
    log(f"accuracy: nk={len(kpts)} nip={df.nip} dtype={df.wq.dtype} "
        f"{_numerics()}")

    dm_dev = jnp.asarray(dm, dtype=df.wq.dtype)
    coords = jnp.asarray(cell.gen_uniform_grids(), dtype=df.dtype)
    ao = make_evaluator(cell, kpts=kpts, dtype=df.dtype)(coords)
    vj_e = pw_jk.get_j_kpts(cell, dm_dev, ao)
    vk_e = pw_jk.get_k_kpts(cell, dm_dev, ao, kpts, coords=coords)
    del ao
    out = {}
    for name, v, ve in (("vj", vj, vj_e), ("vk", vk, vk_e)):
        err, scale = _max_abs(v - ve), _max_abs(ve)
        _check(f"accuracy (a) ISDF vs exact {name} [{df.wq.dtype}]",
               err, scale, ISDF_VS_EXACT_TOL)
        out[f"{name}_vs_exact"] = err

    vj_h, vk_h = host_serve(df.x_k, df.wq, dm, df.kmesh)
    for name, v, vh in (("vj", vj, vj_h), ("vk", vk, vk_h)):
        err = _max_abs(np.asarray(v, dtype=np.complex128) - vh)
        _check(f"accuracy (b) {df.wq.dtype} serve vs host complex128 "
               f"{name} [{_numerics()}]", err, _max_abs(vh),
               SERVE_VS_HOST_TOL)
        out[f"{name}_vs_host"] = err
    return out


def four(cfg=PRODUCTION, n_devices=4):
    """Sharded build + serve over ``n_devices`` against the one-card build
    in the same process."""
    import jax
    from bench import trs_test_density
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.parallel import (
        build_sharded, get_jk_sharded, make_device_mesh)

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"--four needs {n_devices} devices, found "
                           f"{len(devices)}")
    cell = make_cell(cfg)
    kpts = cell.get_kpts(list(cfg.kmesh))
    dm = trs_test_density(cell, kpts)

    t0 = time.perf_counter()
    with jax.default_device(devices[0]):
        df1 = FFTISDF(cell, kpts, c0=cfg.c0, m0=cfg.m0, verbose=0).build()
        vj1, vk1 = jax.block_until_ready(df1.get_jk(dm))
    log(f"four: one-card build+serve wall {time.perf_counter() - t0:.3f} s "
        f"(includes compile), nip={df1.nip}")

    mesh = make_device_mesh(devices=devices)
    t0 = time.perf_counter()
    dfn = FFTISDF(cell, kpts, c0=cfg.c0, m0=cfg.m0, verbose=0)
    build_sharded(dfn, mesh)
    vjn, vkn = jax.block_until_ready(get_jk_sharded(dfn, dm, mesh))
    log(f"four: {n_devices}-card build+serve wall "
        f"{time.perf_counter() - t0:.3f} s (includes compile), "
        f"nip={dfn.nip}")
    for name, arr in (("wq", dfn.wq), ("ws", dfn._ws_sharded)):
        held = sorted({s.device.id for s in arr.addressable_shards
                       if s.data.size})
        log(f"four: {name} {arr.shape} split over devices {held}, shard "
            f"{arr.addressable_shards[0].data.shape}")
        if len(held) != n_devices or arr.sharding.is_fully_replicated:
            raise AssertionError(f"four: {name} is not split over all "
                                 f"{n_devices} devices ({arr.sharding})")
    scale = _max_abs(vk1)
    out = {}
    for name, a, b in (("vj", vj1, vjn), ("vk", vk1, vkn)):
        err = _max_abs(np.asarray(a) - np.asarray(b))
        _check(f"four: sharded vs one-card {name} [{dfn.wq.dtype} "
               f"{_numerics()}]", err, scale, SHARDED_VS_ONE_TOL)
        out[name] = err
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded build and its "
                        "one-card comparison")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    log(f"nvidia-smi: {gpu_name_and_power_limit()}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    from fftisdf_tpu.utils.device import (
        enable_persistent_cache, ensure_f32_matmul_precision)

    enable_persistent_cache()
    ensure_f32_matmul_precision()
    t0 = time.perf_counter()
    if args.four:
        four()
    else:
        production()
        accuracy()
    log(f"total wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
