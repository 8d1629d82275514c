"""Multi-device rendering modes: correctness, determinism, psum film.

The bitwise-stability gate of BASELINE.json: renders must be identical
across runs and across device decompositions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_tpu.models.path import PathIntegrator
from pbrt_tpu.parallel.mesh import make_mesh
from pbrt_tpu.parallel import render as render_mod
from pbrt_tpu.parallel.render import render_spp_sharded, render_tile_sharded
from pbrt_tpu.scenes.cornell import cornell_box


def _setup():
    scene, camera = cornell_box(resolution=(16, 16))
    return scene, camera, PathIntegrator(max_depth=3)


def test_tile_sharded_matches_single():
    scene, camera, integ = _setup()
    mesh8 = make_mesh(8)
    mesh1 = make_mesh(1)
    a = np.asarray(render_tile_sharded(scene, camera, integ, mesh8, spp=4))
    b = np.asarray(render_tile_sharded(scene, camera, integ, mesh1, spp=4))
    np.testing.assert_array_equal(a, b)  # bitwise across decompositions


@pytest.mark.parametrize("n_dev", [2, 8])
def test_tile_sharded_pads_to_whole_tiles(monkeypatch, n_dev):
    """An image that fills no whole number of tiles: the last pixel pads
    the dispatches, the padding is dropped, and the image still does not
    depend on the device count (one dispatch on the mesh, four on one
    device)."""
    monkeypatch.setattr(render_mod, "TILE_PIXELS", 16)
    scene, camera = cornell_box(resolution=(9, 7))
    integ = PathIntegrator(max_depth=1)
    a = np.asarray(render_tile_sharded(scene, camera, integ,
                                       make_mesh(n_dev), spp=1))
    b = np.asarray(render_tile_sharded(scene, camera, integ, make_mesh(1),
                                       spp=1))
    assert a.shape == (7, 9, 3)
    assert np.isfinite(a).all() and a.mean() > 0
    np.testing.assert_array_equal(a, b)


def test_spp_sharded_matches_tile():
    scene, camera, integ = _setup()
    mesh = make_mesh(8)
    a = np.asarray(render_spp_sharded(scene, camera, integ, mesh, spp=8))
    b = np.asarray(render_tile_sharded(scene, camera, integ, mesh, spp=8))
    # Same sample set, different reduction order: allclose (psum order may
    # legally reassociate float sums).
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_bitwise_repeatability():
    scene, camera, integ = _setup()
    mesh = make_mesh(8)
    a = np.asarray(render_spp_sharded(scene, camera, integ, mesh, spp=8))
    b = np.asarray(render_spp_sharded(scene, camera, integ, mesh, spp=8))
    np.testing.assert_array_equal(a, b)
