"""Staged wavefront compaction for masked fixed-point walks.

The volumetric delta-tracking / ratio-tracking walks (models/volpath.py) are
masked lockstep loops: every iteration pays the full ray batch even though
the live set decays fast (on the cloud scene 45% of rays enter the medium,
~6% still walking after 28 steps, 0 by 48 — an ~8x lockstep waste at a
64-step cap). This is the batched equivalent of the reference's wavefront
queue compaction (/root/reference/src/pbrt/wavefront/workqueue.h: dead lanes
are simply not enqueued for the next kernel).

staged_masked_loop runs the walk in stages: a full-width prefix, then
progressively narrower stages that gather the still-walking lanes to the
front (argsort of the mask — a stable compaction permutation), run the body
on the compacted batch, and scatter results back. Because the renderer's
RNG is stateless (draws depend only on (pixel, sample, dim), never on lane
position), a compacted lane computes BITWISE the same result it would have
computed in the monolithic loop.

Capacity overflow (more live lanes than a stage's width) is guarded: a
lax.cond checks the live count against the stage capacity and runs the
stage full-width when it would overflow, so no lane is ever silently
frozen (advisor round-4 finding — freezing would be a data-dependent
transmittance/termination bias, not a benign truncation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def default_stages(max_steps: int):
    """Stage plan (width divisor, iterations) summing to max_steps,
    shaped to the measured live-set decay of the medium walks."""
    k0 = max(1, max_steps // 8)
    k1 = max(1, max_steps // 5)
    k2 = max(1, max_steps // 4)
    k3 = max_steps - k0 - k1 - k2
    plan = [(1, k0), (2, k1), (4, k2)]
    if k3 > 0:
        plan.append((16, k3))
    return plan


def staged_masked_loop(body, inputs, state, mask_of, max_steps: int,
                       stages=None):
    """Run `state = body(inputs, it, state)` until mask_of(state) is all
    False or max_steps iterations, compacting between stages.

    body: (inputs, it, state) -> state; must only change lanes where
        mask_of(state) (standard masked-update discipline).
    inputs: pytree of per-ray constants (leading dim N) the body reads.
    state: pytree of per-ray loop state (leading dim N).
    mask_of: state -> (N,) bool, the still-walking mask.
    """
    n = jax.tree_util.tree_leaves(state)[0].shape[0]
    if stages is None:
        stages = default_stages(max_steps)

    def run(inputs_s, state_s, it0, iters):
        def cond(c):
            it, st = c
            return (it < it0 + iters) & jnp.any(mask_of(st))

        def step(c):
            it, st = c
            return it + 1, body(inputs_s, it, st)

        _, st = jax.lax.while_loop(cond, step, (it0, state_s))
        return st

    it = 0
    for div, iters in stages:
        if iters <= 0:
            continue
        if div <= 1:
            state = run(inputs, state, jnp.int32(it), iters)
        else:
            cap = max(256, -(-n // div))
            if cap >= n:
                state = run(inputs, state, jnp.int32(it), iters)
            else:
                mask = mask_of(state)

                def compacted(state, mask=mask, cap=cap, it=it, iters=iters):
                    # Stable live-first permutation; take the first `cap`.
                    idx = jnp.argsort(
                        jnp.where(mask, 0, 1), stable=True
                    )[:cap].astype(jnp.int32)
                    part_in = jax.tree_util.tree_map(
                        lambda a: a[idx], inputs)
                    part_st = jax.tree_util.tree_map(lambda a: a[idx], state)
                    part_st = run(part_in, part_st, jnp.int32(it), iters)
                    return jax.tree_util.tree_map(
                        lambda full, part: full.at[idx].set(part),
                        state, part_st,
                    )

                def fullwidth(state, it=it, iters=iters):
                    return run(inputs, state, jnp.int32(it), iters)

                # Overflow guard: if more lanes are live than the stage
                # holds, compacting would freeze the excess — run the
                # stage full-width instead (correct for any decay curve).
                state = jax.lax.cond(
                    jnp.sum(mask) <= cap, compacted, fullwidth, state)
        it += iters
    return state
