"""Worker process for the multi-process CPU simulation harness.

Run as ``python -m pbrt_tpu.parallel.mp_worker --coordinator ... --nprocs N
--pid I ...`` — one OS process per simulated host, each with
``--local-devices`` virtual CPU devices (SURVEY.md section 4's prescribed
no-cluster stand-in for a multi-host deployment). Writes this process' results to
``<out>.<pid>.npz`` so the spawning test can gate bitwise determinism
across process counts.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--mode", default="render", choices=["render", "train"])
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.local_devices}"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

    # jax.distributed.initialize must run BEFORE anything touches the XLA
    # backend. Importing pbrt_tpu used to materialize module-scope jnp
    # constants (core/cie.py et al.) which initialized the backend and made
    # this call refuse to run — so initialize first, import pbrt_tpu after.
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.nprocs,
        process_id=args.pid,
    )

    from pbrt_tpu.parallel.multiprocess import (
        global_mesh,
        render_multiprocess,
        train_step_multiprocess,
    )
    assert jax.process_count() == args.nprocs
    assert len(jax.devices()) == args.nprocs * args.local_devices

    import numpy as np

    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(args.res, args.res))
    integ = PathIntegrator(max_depth=3)
    mesh = global_mesh()

    if args.mode == "render":
        img = render_multiprocess(scene, camera, integ, mesh, spp=args.spp)
        t0 = time.perf_counter()
        img = render_multiprocess(scene, camera, integ, mesh, spp=args.spp)
        dt = time.perf_counter() - t0
        np.savez(f"{args.out}.{args.pid}.npz", img=img, seconds=dt,
                 nprocs=args.nprocs, ndev=len(jax.devices()))
    else:
        target = np.full((args.res * args.res, 3), 0.25, np.float32)
        loss, grads = train_step_multiprocess(
            scene, camera, integ, target, mesh, spp=args.spp)
        np.savez(f"{args.out}.{args.pid}.npz", loss=loss,
                 albedo_coeffs=grads["albedo_coeffs"],
                 area_scale=grads["area_scale"])
    sys.stdout.write("OK\n")


if __name__ == "__main__":
    main()
