"""Integrators — the renderer's model families.

Reference analogue: the 11 CPU integrators
(/root/reference/src/pbrt/cpu/integrators.h:34-518) and the wavefront path
integrator (wavefront/integrator.*). Design: an integrator is a pure
function scene x rays -> radiance built from lax.scan over bounces with
fixed-size carried ray state (the RayWorkItem of workitems.soa:40-50 as a
pytree of arrays).
"""

from .path import PathIntegrator  # noqa: F401
from .volpath import VolPathIntegrator  # noqa: F401
