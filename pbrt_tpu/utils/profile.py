"""Profiling hooks: named scopes on hot paths + trace capture.

Reference analogue: the per-kernel GPU launch statistics the reference
keeps for every wavefront kernel (gpu/util.cpp:128-175 — cudaEvent timers
per kernel, printed by --stats). Here the equivalent is (a)
`jax.named_scope` annotations so every HLO op in a captured XLA trace
attributes to a renderer phase (traversal, shading, NEE, sort, ...), and
(b) `capture()` to record a trace viewable in TensorBoard / Perfetto, plus
(c) `timed_breakdown` for quick host-side per-phase wall timing when a full
trace is overkill.

Usage:
    with profile.capture("/tmp/trace"):
        render(...)

    @profile.scope("accel/closest")  # or: with profile.scope("..."):
    def closest(...): ...

Named scopes are zero-cost when no trace is being captured (they only
rename HLO metadata), so they stay on permanently.
"""

from __future__ import annotations

import contextlib
import time

import jax

# jax.named_scope works as both decorator and context manager and nests.
scope = jax.named_scope


@contextlib.contextmanager
def capture(logdir: str):
    """Capture an XLA profiler trace (TensorBoard xplane format) of the
    enclosed block. View with `tensorboard --logdir` or convert with
    the tensorboard_plugin_profile tooling."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(x):
    """Wait until the device has produced `x`; returns it."""
    return jax.block_until_ready(x)


def timed_breakdown(stages, warmup: int = 1, iters: int = 3):
    """Time a dict of {name: thunk} stages; each thunk returns device
    arrays that are sync()'d. Returns {name: seconds} (best of iters)."""
    out = {}
    for name, thunk in stages.items():
        for _ in range(warmup):
            sync(thunk())
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            sync(thunk())
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    return out
