"""Tag-sorted shading dispatch: the wavefront kernel-specialization tier.

Reference analogue: the wavefront backend instantiates one shading kernel
per concrete material type and enqueues each hit into its material's queue
(/root/reference/src/pbrt/wavefront/surfscatter.cpp:39-58,136-138 +
workitems.h MaterialEvalQueue), so a ray only pays for the BxDF it actually
carries. The lockstep masked design here evaluates every family present in
the scene on every lane — cheap for 1-2 families, but a scene mixing coated
(layered random walk), hair, and measured materials pays the sum of all of
them per ray.

Redesign: there are no queues or atomics — instead rays are argsorted by
material kind each bounce and processed in fixed-size tiles through a
`lax.map` whose body `lax.switch`es on the tile's tag:

  * a tile whose rays all share one family runs a branch traced with ONLY
    that family's `any_*` static flag set, so XLA compiles the single-family
    code path (the "kernel specialization");
  * a mixed tile (at family boundaries: at most n_families - 1 of them)
    falls back to the usual masked evaluate-all branch.

All BxDF evaluation is per-lane elementwise (the layered walk's RNG is keyed
on (wo, wi, salt) bit patterns, not lane index), so the sorted path is
semantically identical to the lockstep path, just without charging diffuse
rays for hair code. Exact bit-equality is NOT guaranteed: the specialized
branches are different XLA traces, so fusion/reassociation can differ at the
ULP level, and for the stochastic layered walk a 1-ULP difference in the
freshly sampled wi re-keys the walk RNG — still an unbiased estimate of the
same integral, but not the same sample (tests gate deterministic leaves
tightly and walk estimates statistically). vmap cannot replace the map:
vmapping a `switch` lowers to predicated execution of every branch, which is
exactly the masked design this tier exists to avoid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .buffers import (
    MAT_COATEDCONDUCTOR,
    MAT_COATEDDIFFUSE,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_DIFFUSETRANS,
    MAT_HAIR,
    MAT_INTERFACE,
    MAT_MEASURED,
    MAT_RETRO,
    MAT_SUBSURFACE,
    MAT_THINDIELECTRIC,
)

# Entries of the surface_params dict that are global tables (never per-ray,
# even if a dimension coincides with the ray count).
_GLOBAL_KEYS = ("measured_coeffs", "measured_scale")

_FLAG_KEYS = (
    "any_conductor", "any_dielectric", "any_thin", "any_coated",
    "any_diffusetrans", "any_hair", "any_subsurface", "any_measured",
    "any_mix", "any_retro", "any_interface_mat",
)

# Flags a single-family branch needs set for its code path to be traced.
_FAMILY_FLAGS = {
    MAT_DIFFUSE: (),
    MAT_CONDUCTOR: ("any_conductor",),
    MAT_DIELECTRIC: ("any_dielectric",),
    MAT_THINDIELECTRIC: ("any_thin",),
    MAT_COATEDDIFFUSE: ("any_coated",),
    MAT_COATEDCONDUCTOR: ("any_coated", "any_conductor"),
    MAT_DIFFUSETRANS: ("any_diffusetrans",),
    MAT_HAIR: ("any_hair",),
    MAT_SUBSURFACE: ("any_subsurface",),
    MAT_MEASURED: ("any_measured",),
    MAT_RETRO: ("any_retro",),
    # Interface lanes take the delta pass-through branch in bxdf.sample,
    # which is only traced when any_interface_mat is set (bxdf.py:791);
    # a uniform interface tile must keep that flag or its rays would get
    # diffuse hemisphere sampling instead of wi=-wo transmission.
    MAT_INTERFACE: ("any_interface_mat",),
}

# Which single families the scene's static flags can produce (MAT_MIX
# resolves to a leaf family before gather, so it never appears in kinds).
_FLAG_TO_FAMILY = (
    ("any_conductor", MAT_CONDUCTOR),
    ("any_dielectric", MAT_DIELECTRIC),
    ("any_thin", MAT_THINDIELECTRIC),
    ("any_coated", MAT_COATEDDIFFUSE),
    ("any_diffusetrans", MAT_DIFFUSETRANS),
    ("any_hair", MAT_HAIR),
    ("any_subsurface", MAT_SUBSURFACE),
    ("any_measured", MAT_MEASURED),
    ("any_retro", MAT_RETRO),
    ("any_interface_mat", MAT_INTERFACE),
)


def possible_families(params) -> list[int]:
    """Single-family kinds the scene's static flags allow, diffuse first."""
    fams = [MAT_DIFFUSE]
    for flag, fam in _FLAG_TO_FAMILY:
        if params.get(flag):
            fams.append(fam)
    if params.get("any_coated") and params.get("any_conductor"):
        fams.append(MAT_COATEDCONDUCTOR)
    return fams


def _restrict(params, fam: int):
    """params with static flags narrowed to one family's code path."""
    out = dict(params)
    keep = set(_FAMILY_FLAGS[fam])
    # Subsurface kinds were already rewritten to diffuse by the integrator;
    # any_subsurface only gates that rewrite, so it is safe to drop.
    for key in _FLAG_KEYS:
        out[key] = key in keep
    return out


def shade_sorted(params, ops, fn, tile: int = 8192):
    """Run fn(params, ops) over kind-sorted fixed-size tiles.

    params: the surface_params dict (per-ray leaves with leading dim N,
    global tables, and static `any_*` bools). ops: a dict of extra per-ray
    arrays (leading dim N). fn(params_tile, ops_tile) -> pytree of arrays
    with leading dim `tile`. Returns the pytree with leading dim N in the
    ORIGINAL ray order, bit-identical to fn(params, ops).
    """
    kind = params["kind"]
    n = int(kind.shape[0])
    fams = possible_families(params)
    if len(fams) <= 1 or n <= tile:
        # Single family (or one tile): specialization buys nothing.
        return fn(params, ops)

    pad = (-n) % tile
    npad = n + pad
    nt = npad // tile

    # Sort by kind; padding uses a sentinel above every family id so pad
    # lanes land in the final tile's tail.
    big = jnp.int32(0x7FFF)
    kind_p = jnp.concatenate([kind.astype(jnp.int32), jnp.full((pad,), big, jnp.int32)])
    perm = jnp.argsort(kind_p)  # stable
    inv = jnp.zeros((npad,), jnp.int32).at[perm].set(jnp.arange(npad, dtype=jnp.int32))
    src = jnp.minimum(perm, n - 1)  # pad lanes re-read ray n-1; discarded

    def sort_leaf(x):
        return jnp.take(x, src, axis=0)

    per_ray = {
        k: v for k, v in params.items()
        if k not in _GLOBAL_KEYS and hasattr(v, "shape") and v.ndim >= 1
        and v.shape[0] == n
    }
    static = {k: v for k, v in params.items() if k not in per_ray}
    per_ray_s = jax.tree.map(sort_leaf, per_ray)
    ops_s = jax.tree.map(sort_leaf, ops)

    # Per-tile branch: the family position when the tile is uniform over
    # real lanes, else the masked fallback (last branch).
    ks = per_ray_s["kind"].reshape(nt, tile)
    lane = jnp.arange(tile, dtype=jnp.int32)[None, :]
    real = lane + jnp.arange(nt, dtype=jnp.int32)[:, None] * tile < n
    k_lo = jnp.min(jnp.where(real, ks, big), axis=1)
    k_hi = jnp.max(jnp.where(real, ks, -1), axis=1)
    # kind id -> branch position (fallback for ids outside `fams`).
    lut = np.full((16,), len(fams), np.int32)
    for pos, fam in enumerate(fams):
        lut[fam] = pos
    branch = jnp.where(
        (k_lo == k_hi) | (k_hi < 0),  # uniform, or all-pad tile
        jnp.take(jnp.asarray(lut), jnp.clip(jnp.where(k_hi < 0, 0, k_hi), 0, 15)),
        len(fams),
    )

    def tiled(x):
        return x.reshape((nt, tile) + x.shape[1:])

    xs = (jax.tree.map(tiled, per_ray_s), jax.tree.map(tiled, ops_s), branch)

    branches = [
        (lambda pr, oo, _fam=fam: fn({**_restrict(static, _fam), **pr}, oo))
        for fam in fams
    ]
    branches.append(lambda pr, oo: fn({**static, **pr}, oo))

    def body(args):
        pr, oo, b = args
        return jax.lax.switch(b, branches, pr, oo)

    out_s = jax.lax.map(body, xs)

    def unsort(x):
        flat = x.reshape((npad,) + x.shape[2:])
        return jnp.take(flat, inv[:n], axis=0)

    return jax.tree.map(unsort, out_s)
