"""Pallas (Triton) brute-force intersector for small scenes.

One program holds a block of rays in registers (one or two per thread) and
walks the packed triangle table in global memory. Every thread reads the
same row, so each read is a broadcast through L1, and the Moller-Trumbore
chain and the running best hit (t, prim, u, v, normal, mat, light) never
leave registers: every hit attribute is selected in the kernel, so the
closest-hit assembly needs no gathers.

The plain XLA alternative (accel/dense.py) tests (N, block) component
arrays and materialises them in device memory.

Reference analogue: the role of the flat no-BVH fallback aggregate
(cpu/aggregates.cpp exhaustive primitive loop).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..core.pytree import pytree, static_field

# Chosen on an H100 (tools/profile_accel.py --part tune).
BLOCK = 256  # rays per program
NUM_WARPS = 4
_UNROLL_MAX = 64  # triangle tables up to this size are walked unrolled


@pytree
class SmallTriAccel:
    # Packed rows, one per triangle: columns
    # 0:3 v0 | 3:6 e1 | 6:9 e2 | 9:12 unit geometric normal |
    # 12 pid+1 | 13 mat+1 | 14 light+1 | 15 pad.
    table: jnp.ndarray  # (T, 16) float32
    n_tris: int = static_field(default=0)


def build_smallscene(tri_verts, tri_mat=None, tri_light=None) -> SmallTriAccel:
    tri_verts = np.asarray(tri_verts, np.float32)
    t = tri_verts.shape[0]
    if tri_mat is None:
        tri_mat = np.zeros((t,), np.int64)
    if tri_light is None:
        tri_light = np.full((t,), -1, np.int64)
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 1e-30, n / np.maximum(ln, 1e-30), 0.0)
    tab = np.zeros((t, 16), np.float32)
    tab[:, 0:3] = tri_verts[:, 0]
    tab[:, 3:6] = e1
    tab[:, 6:9] = e2
    tab[:, 9:12] = n
    tab[:, 12] = np.arange(1, t + 1, dtype=np.float32)
    tab[:, 13] = np.asarray(tri_mat, np.float32) + 1.0
    tab[:, 14] = np.asarray(tri_light, np.float32) + 1.0
    return SmallTriAccel(table=jnp.asarray(tab), n_tris=t)


def _kernel(tri_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            tmax_ref,
            t_out, prim_out, u_out, v_out, n0_out, n1_out, n2_out,
            mat_out, light_out, *, n_tris: int, any_hit: bool):
    eps = 1e-12
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]  # (BLOCK,)
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    tmax = tmax_ref[...]
    zero = jnp.zeros_like(tmax)

    def body(c, carry):
        tb, pb, ub, vb, nxb, nyb, nzb, mb, lb = carry
        v0x = tri_ref[c, 0]
        v0y = tri_ref[c, 1]
        v0z = tri_ref[c, 2]
        e1x = tri_ref[c, 3]
        e1y = tri_ref[c, 4]
        e1z = tri_ref[c, 5]
        e2x = tri_ref[c, 6]
        e2y = tri_ref[c, 7]
        e2z = tri_ref[c, 8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        hit = (
            (jnp.abs(det) > eps)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (tk > 0.0)
            & (tk < tb)
        )
        if any_hit:
            # Any hit ends the ray: collapse t so later triangles fail the
            # (tk < tb) gate, and flag the ray in prim.
            tb = jnp.where(hit, 0.0, tb)
            pb = jnp.where(hit, tri_ref[c, 12], pb)
            return (tb, pb, ub, vb, nxb, nyb, nzb, mb, lb)
        tb = jnp.where(hit, tk, tb)
        pb = jnp.where(hit, tri_ref[c, 12], pb)
        ub = jnp.where(hit, u, ub)
        vb = jnp.where(hit, v, vb)
        nxb = jnp.where(hit, tri_ref[c, 9], nxb)
        nyb = jnp.where(hit, tri_ref[c, 10], nyb)
        nzb = jnp.where(hit, tri_ref[c, 11], nzb)
        mb = jnp.where(hit, tri_ref[c, 13], mb)
        lb = jnp.where(hit, tri_ref[c, 14], lb)
        return (tb, pb, ub, vb, nxb, nyb, nzb, mb, lb)

    init = (tmax, zero, zero, zero, zero, zero, zero, zero, zero)
    if n_tris <= _UNROLL_MAX:
        # Static unroll: triangle reads get constant addresses and the
        # compiler can hoist them ahead of the arithmetic.
        out = init
        for c in range(n_tris):
            out = body(c, out)
    else:
        out = jax.lax.fori_loop(0, n_tris, body, init)
    t_out[...] = out[0]
    prim_out[...] = out[1]
    u_out[...] = out[2]
    v_out[...] = out[3]
    n0_out[...] = out[4]
    n1_out[...] = out[5]
    n2_out[...] = out[6]
    mat_out[...] = out[7]
    light_out[...] = out[8]


@functools.partial(
    jax.jit, static_argnames=("any_hit", "interpret", "block", "num_warps")
)
def _smallscene_intersect_impl(accel: SmallTriAccel, o, d, tmax,
                               any_hit: bool = False, interpret: bool = False,
                               block: int = BLOCK, num_warps: int = NUM_WARPS):
    """Closest- or any-hit query of every ray against every triangle.

    Returns a dict with per-ray 't' (inf = miss) and 'prim' (-1 = miss);
    closest-hit mode adds 'u', 'v', 'n' (geometric normal), 'mat' and
    'light' (-1 = none)."""
    n = o.shape[0]
    pad = (-n) % block
    npad = n + pad

    def comp(x, fill=0.0):
        return jnp.pad(x, (0, pad), constant_values=fill)

    ox, oy, oz = comp(o[:, 0]), comp(o[:, 1]), comp(o[:, 2])
    dx, dy, dz = comp(d[:, 0], 1.0), comp(d[:, 1], 1.0), comp(d[:, 2], 1.0)
    tm = comp(tmax, -1.0)

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    table_spec = pl.BlockSpec(accel.table.shape, lambda i: (0, 0))
    kernel = functools.partial(
        _kernel, n_tris=accel.n_tris, any_hit=any_hit
    )
    outs = pl.pallas_call(
        kernel,
        grid=(npad // block,),
        in_specs=[table_spec] + [ray_spec] * 7,
        out_specs=[ray_spec] * 9,
        out_shape=[
            jax.ShapeDtypeStruct((npad,), jnp.float32) for _ in range(9)
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="smallscene_intersect",
    )(accel.table, ox, oy, oz, dx, dy, dz, tm)

    t, prim_f, u, v, n0, n1, n2, matf, lightf = (x[:n] for x in outs)
    miss = prim_f <= 0.0
    prim = jnp.where(miss, -1, prim_f.astype(jnp.int32) - 1)
    t = jnp.where(miss, jnp.inf, t)
    if any_hit:
        return {"t": t, "prim": prim}
    z = jnp.zeros_like(u)
    return {
        "t": t,
        "prim": prim,
        "u": jnp.where(miss, z, u),
        "v": jnp.where(miss, z, v),
        "n": jnp.stack([n0, n1, n2], axis=-1),
        "mat": jnp.where(miss, 0, matf.astype(jnp.int32) - 1),
        "light": jnp.where(miss, -1, lightf.astype(jnp.int32) - 1),
    }


# Geometry detached under reverse-mode AD (ops/detach.py).
from .detach import detached_query  # noqa: E402

smallscene_intersect = detached_query(_smallscene_intersect_impl)
