"""Multi-process (multi-host simulation) harness: jax.distributed over N
spawned CPU processes — SURVEY.md section 4's prescribed stand-in for the
1 -> 4 host scaling north star (BASELINE.md).

Gates: the film is bitwise identical across process counts (1, 2, 4), and
the replicated-parameter gradients psum identically across processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(nprocs, mode, out, local_devices=2, res=16, spp=4, timeout=420):
    port = _free_port()
    procs = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    # Workers must not inherit pytest's compilation-cache config; each has
    # its own process-count-specific executables anyway.
    for pid in range(nprocs):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "pbrt_tpu.parallel.mp_worker",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--nprocs", str(nprocs),
                    "--pid", str(pid),
                    "--local-devices", str(local_devices),
                    "--mode", mode,
                    "--res", str(res),
                    "--spp", str(spp),
                    "--out", out,
                ],
                cwd=REPO,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"mp worker timed out (nprocs={nprocs})")
        outs.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in outs:
        assert rc == 0, stderr.decode()[-2000:]
    return [
        np.load(f"{out}.{pid}.npz") for pid in range(nprocs)
    ]


@pytest.mark.parametrize("nprocs", [2])
def test_render_bitwise_across_process_counts(tmp_path, nprocs):
    base = _spawn(1, "render", str(tmp_path / "r1"))[0]
    multi = _spawn(nprocs, "render", str(tmp_path / f"r{nprocs}"))
    for shard in multi:
        np.testing.assert_array_equal(shard["img"], base["img"])
    assert multi[0]["ndev"] == nprocs * 2


def test_render_four_processes_bitwise(tmp_path):
    base = _spawn(1, "render", str(tmp_path / "s1"))[0]
    multi = _spawn(4, "render", str(tmp_path / "s4"), local_devices=2)
    for shard in multi:
        np.testing.assert_array_equal(shard["img"], base["img"])
    assert multi[0]["ndev"] == 8


def test_gradient_psum_across_processes(tmp_path):
    base = _spawn(1, "train", str(tmp_path / "g1"))[0]
    multi = _spawn(2, "train", str(tmp_path / "g2"))
    # Replicated-parameter gradients must agree across process layouts
    # (allclose: the psum may legally reassociate float partial sums) and
    # be identical on every process of one layout.
    np.testing.assert_array_equal(
        multi[0]["albedo_coeffs"], multi[1]["albedo_coeffs"]
    )
    np.testing.assert_array_equal(multi[0]["area_scale"],
                                  multi[1]["area_scale"])
    np.testing.assert_allclose(
        multi[0]["albedo_coeffs"], base["albedo_coeffs"],
        rtol=2e-4, atol=1e-7,
    )
    np.testing.assert_allclose(
        multi[0]["area_scale"], base["area_scale"], rtol=2e-4, atol=1e-7
    )
    np.testing.assert_allclose(multi[0]["loss"], base["loss"], rtol=1e-5)
