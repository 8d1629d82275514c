"""Pytest configuration: run tests on a virtual 8-device CPU mesh.

Sharding correctness is validated on XLA's host platform with 8 virtual
devices. The CPU is forced unless JAX_PLATFORMS names another platform;
tests marked `gpu` then run on the card (README: "Tests on the GPU") and
skip everywhere else.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")

from pbrt_tpu.utils import compile_cache  # noqa: E402

# Persistent compilation cache: cached executables skip backend_compile,
# which cuts suite time substantially on warmed runs.
compile_cache.enable(".jax_cache_tests", min_compile_secs=0.5)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip tests marked `gpu` unless JAX's backend is the GPU. Decided
    here, per test, never at import: every xdist worker must collect the
    same tests."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda on a machine with one)")
