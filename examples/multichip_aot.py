"""AOT lowering/compile proof of the sharded build at PRODUCTION shapes.

Round-3 verdict item #2's gate: real multi-chip hardware is not available
in this environment, so the closest available evidence that the unified
(production-pipeline) sharded build works beyond toy shapes is to
lower + compile its per-chunk program on an N-virtual-device CPU mesh at
the reference driver's production configuration — NiO AFM, 4x4x4 k-mesh,
gth-dzvp-molopt-sr, ke=200 (nk=64, nao=62, ngrid=250047, nip=c0*nao=2480)
— with per-device memory accounting from XLA's own analysis.  No data is
materialized: every operand is a ShapeDtypeStruct; ``_chunk_factors``'s
output pytree comes from ``jax.eval_shape``.

Usage:  python examples/multichip_aot.py [--ndev 8] [--c0 40]
        [--out artifacts/multichip_aot.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the CPU client must not exist yet when the flag is set (conftest note)
import re

flags = os.environ.get("XLA_FLAGS", "")
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ndev", type=int, default=8)
    p.add_argument("--c0", type=float, default=40.0)
    p.add_argument("--max-memory-gb", type=float, default=12.0,
                   help="per-device HBM budget driving the plan")
    p.add_argument("--out", default="artifacts/multichip_aot.json")
    args = p.parse_args()
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={args.ndev}"
    ).strip()

    import numpy as np
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from functools import partial

    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.parallel import make_device_mesh
    from fftisdf_tpu.parallel.build import (plan_sharded, make_chunk_step,
                                            _chunk_factors)
    from fftisdf_tpu.basis.eval import make_evaluator

    # production (accelerator) dtypes — the CPU mesh only hosts the compile
    dtype, cdtype = jnp.float32, jnp.complex64
    cell = structure.to_cell(*structure.nio_afm(),
                             basis="gth-dzvp-molopt-sr", pseudo="gth-pade",
                             ke_cutoff=200.0, exp_to_discard=0.1)
    kpts = cell.get_kpts([4, 4, 4])
    nk, nao = len(kpts), cell.nao_nr()
    ngrid = int(np.prod(cell.mesh))
    nip = int(args.c0 * nao)
    nsec = nk // 2 + 4   # canonical sectors of the 4x4x4 TRS pairing (36)

    plan = plan_sharded(ngrid, nip, args.ndev, nsec, dtype=dtype,
                        max_memory_gb=args.max_memory_gb)
    nq_pad = min(plan["qchunk"], -(-nsec // args.ndev) * args.ndev)
    print(f"production shapes: nk={nk} nao={nao} ngrid={ngrid} nip={nip}")
    print(f"plan: {plan} -> chunk of {nq_pad} sectors over "
          f"{args.ndev} devices")

    dev_mesh = make_device_mesh(n_devices=args.ndev)
    # evaluator over the TRS-canonical k half, matching the halved sweep
    # operands below (isdf.kpoint._trs_sweep_inputs)
    s_kpts = cell.get_scaled_kpts(kpts)
    from fftisdf_tpu.lattice import kpoints as kpt_mod
    mirror = np.array([kpt_mod.member(-s_kpts[q], s_kpts, strict=False)
                       for q in range(nk)])
    ksel = np.array([k for k in range(nk) if k <= mirror[k]])
    assert len(ksel) == nsec
    fn = make_evaluator(cell, kpts=kpts[ksel], dtype=dtype)
    step = make_chunk_step(fn=fn, dev_mesh=dev_mesh,
                           fmesh=tuple(int(m) for m in cell.mesh),
                           ngrid=ngrid, rblk=plan["rblk"],
                           nip_pad=plan["nip_pad"], kind="ridge",
                           signed=False, rdtype=dtype)

    S = jax.ShapeDtypeStruct
    x_k = S((nk, nip, nao), cdtype)
    phase = S((nk, nk), cdtype)
    qs = S((nq_pad,), jnp.int32)
    data_c = jax.eval_shape(
        partial(_chunk_factors, nq=nq_pad, solver="ridge", rcond=1e-5,
                refine=2), x_k, phase, qs)
    # the sweep producers run on the TRS-canonical k half (the same nsec
    # canonical set as the sectors: isdf.kpoint._trs_sweep_inputs)
    operands = (
        S((plan["nblk"], plan["blk"], 3), dtype),          # coords_p
        S((nsec, nip, nao), cdtype),                       # x (k-half)
        S((nk, nsec), cdtype),                             # stripe phase
        S((nk, nq_pad), cdtype),                           # phase_cols
        data_c,
        S((nq_pad, ngrid), cdtype),                        # eiqr_c
        S((nq_pad, ngrid), dtype),                         # sqk_c
        None,                                              # sign_c
    )
    t0 = time.perf_counter()
    lowered = step.lower(*operands)
    t_lower = time.perf_counter() - t0
    print(f"lowered in {t_lower:.1f}s; compiling...")
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    rec = {
        "note": "AOT lower+compile of the UNIFIED sharded build chunk "
                "program (grid-sharded production sweep -> all-to-all -> "
                "sector-sharded spectral+gram) at the reference driver's "
                "production config, on a virtual CPU mesh with accelerator (f32) "
                "dtypes; per-device bytes from XLA's memory analysis",
        "ndev": args.ndev, "nk": nk, "nao": nao, "ngrid": ngrid,
        "nip": nip, "chunk_sectors": nq_pad, "plan": plan,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
    }
    try:
        rec["per_device_bytes"] = {
            "arguments_gb": round(mem.argument_size_in_bytes / 1e9, 3),
            "outputs_gb": round(mem.output_size_in_bytes / 1e9, 3),
            "temps_gb": round(mem.temp_size_in_bytes / 1e9, 3),
            "generated_code_gb": round(
                mem.generated_code_size_in_bytes / 1e9, 4),
            "peak_est_gb": round(
                (mem.argument_size_in_bytes + mem.output_size_in_bytes
                 + mem.temp_size_in_bytes) / 1e9, 3),
        }
    except AttributeError:
        rec["per_device_bytes"] = {"unavailable": str(type(mem))}
    print(json.dumps(rec, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
