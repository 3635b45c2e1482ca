"""simplepathtracer_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/Pallas re-design of the capabilities of
ilia-glushchenko/SimplePathTracer (C++17 CPU path tracer): batched wavefront
path tracing under ``lax.scan``, stateless counter-based RNG, end-to-end
differentiability w.r.t. scene parameters, and multi-chip scaling via
``jax.sharding`` meshes.
"""

from .types import Camera, Material, RenderConfig, RenderState, Scene, make_camera
from .scenes import (
    SCENES,
    compact_scene,
    cover_scene,
    random_scene,
    reference_scene,
    simple_scene,
    three_sphere_scene,
    with_ground_plane,
)
from .render import accumulate, init_state, render, render_pixels, trace_rays
from .presets import PRESETS, Preset

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Material",
    "RenderConfig",
    "RenderState",
    "Scene",
    "make_camera",
    "SCENES",
    "compact_scene",
    "cover_scene",
    "random_scene",
    "reference_scene",
    "simple_scene",
    "three_sphere_scene",
    "with_ground_plane",
    "accumulate",
    "init_state",
    "render",
    "render_pixels",
    "trace_rays",
]
