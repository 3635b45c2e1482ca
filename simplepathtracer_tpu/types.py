"""Core pytrees for the path tracer.

The reference (ilia-glushchenko/SimplePathTracer) keeps its scene in global
mutable SoA arrays (include/Globals.hpp:31-37) and its configuration in
compile-time constants (include/Globals.hpp:8-29).  Here both become explicit,
immutable pytrees so every render is a pure function `(scene, camera, config,
key) -> image` that can be `jit`-ed, `grad`-ed, `vmap`-ed and sharded.

Scene arrays are JAX leaves so that `jax.grad` flows into sphere geometry and
material parameters (the differentiability extension of BASELINE.json).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import jax
import jax.numpy as jnp

Array = Any  # jax.Array; kept loose so numpy arrays also fit (CPU oracle)


class Material(enum.IntEnum):
    """Surface material ids.

    The reference enumerates SKYBOX/REFLECTIVE/REFRACTIVE/DIFFUSE
    (include/Definitions.hpp:7-13); SKYBOX is not a surface property there
    (it is the miss shader), so this build models only the three surface
    materials and treats a miss as hitting the sky.
    """

    LAMBERTIAN = 0  # reference: Material::DIFFUSE
    METAL = 1       # reference: Material::REFLECTIVE
    DIELECTRIC = 2  # reference: Material::REFRACTIVE


def _pytree_dataclass(cls=None, *, meta_fields=()):
    """Register a frozen dataclass as a JAX pytree with static meta fields."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = [f.name for f in dataclasses.fields(c) if f.name not in meta_fields]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(meta_fields)
        )
        return c

    return wrap(cls) if cls is not None else wrap


@_pytree_dataclass
class Scene:
    """SoA sphere scene.

    Mirrors the reference's global arrays (include/Globals.hpp:31-37):
    `g_spheres` -> centers, `g_radii` -> radii, `g_colors` -> albedo,
    `g_materials` -> material, `g_diffuses` -> fuzz.  The reference's
    `g_attenuations` is generated but never read by any tracer
    (SURVEY.md S2), so it has no counterpart here; instead `albedo` is the
    single, actually-used color parameter in [0, 1].

    All float leaves are differentiable. `radii` may be negative: the sign
    flips the outward normal, producing Shirley's hollow-glass shell
    (BASELINE config 2).
    """

    centers: Array   # [S, 3] f32
    radii: Array     # [S]    f32 (negative => inward-facing normal)
    albedo: Array    # [S, 3] f32 in [0, 1]
    material: Array  # [S]    i32 (Material)
    fuzz: Array      # [S]    f32, metal fuzz in [0, 1]
    ior: Array       # [S]    f32, dielectric refraction index (e.g. 1.5)
    sky_lo: Array    # [3]    f32, sky color at dir.y == -1
    sky_hi: Array    # [3]    f32, sky color at dir.y == +1
    # Optional Lambertian infinite plane: [7] f32 (unit normal xyz, offset k
    # with the surface {p : dot(n, p) + k = 0}, albedo rgb), or None.  The
    # reference counterpart is its DEAD plane code + constants
    # (include/Collision.hpp:73-85, Globals.hpp:26-28) — here it is live in
    # every forward path (jnp bounce and the forward kernel).  A DIFF_LEAVES
    # member: offset + albedo receive gradients; the unit normal is
    # structurally detached.
    plane: Array | None = None

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


@_pytree_dataclass
class Camera:
    """Thin-lens camera (pinhole when aperture == 0).

    The reference camera is a pinhole built from a (buggy) cross-product
    basis (include/Math.hpp:198-231; the Cross z-term bug is documented in
    SURVEY.md S2) with fixed 90-degree FOV via z=1 NDC
    (include/SingleThreadPathTracer.hpp:125-127).  This build uses the
    correct orthonormal basis plus vertical FOV and defocus blur (needed by
    BASELINE config 3).  All leaves are differentiable.
    """

    origin: Array      # [3] f32 — reference eyePos (Globals.hpp:23)
    lookat: Array      # [3] f32 — reference lookAt (Globals.hpp:22)
    vup: Array         # [3] f32 — reference upDir  (Globals.hpp:24)
    vfov_deg: Array    # []  f32 vertical field of view
    aperture: Array    # []  f32 lens diameter (0 => pinhole)
    focus_dist: Array  # []  f32 focal plane distance

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


def make_camera(
    origin=(0.0, 1.0, -3.0),
    lookat=(0.0, 1.0, 0.0),
    vup=(0.0, 1.0, 0.0),
    vfov_deg=90.0,
    aperture=0.0,
    focus_dist=None,
) -> Camera:
    origin = jnp.asarray(origin, jnp.float32)
    lookat = jnp.asarray(lookat, jnp.float32)
    if focus_dist is None:
        focus_dist = jnp.linalg.norm(lookat - origin)
    return Camera(
        origin=origin,
        lookat=lookat,
        vup=jnp.asarray(vup, jnp.float32),
        vfov_deg=jnp.asarray(vfov_deg, jnp.float32),
        aperture=jnp.asarray(aperture, jnp.float32),
        focus_dist=jnp.asarray(focus_dist, jnp.float32),
    )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (hashable; safe as a jit static arg).

    The reference equivalents are the constexpr globals
    (include/Globals.hpp:11-18): g_width/g_height/g_samples/g_bounces and
    the 1e-3 hit threshold default (include/Collision.hpp:10).
    """

    width: int = 1440
    height: int = 1440
    spp: int = 100
    max_depth: int = 10          # reference g_bounces (Globals.hpp:12)
    t_min: float = 1e-3          # reference intersection threshold (Collision.hpp:10)
    t_max: float = 3.0e7
    gamma: float = 2.0           # reference gamma (include/IOHelpers.hpp:19: sqrt)
    spp_chunk: int = 0           # 0 => all spp in one pass; else scan over chunks
    # Forward renders through the GPU kernel (ops/pallas_forward.py);
    # gradient entry points always take the jnp bounce.
    use_pallas: bool = False
    pallas_interpret: bool = False  # run the kernel interpreted (CPU tests)
    # Soft-silhouette blend width for the first bounce (0 = hard edges).
    # Used by inverse rendering to recover geometry gradients at visibility
    # boundaries, which the detached hit selection otherwise drops.
    silhouette_softness: float = 0.0
    # Russian roulette: from this bounce index on, paths survive with
    # probability max(throughput) (clamped to [0.05, 1]) and are reweighted
    # by 1/p — unbiased early termination the reference lacks.  0 disables.
    rr_start_depth: int = 0
    rng_impl: str = "threefry2x32"  # jax PRNG implementation

    def __post_init__(self):
        # The RNG slot map assigns bounce b the counter slots 4b..4b+3 and
        # the camera jitter slots 124/125 (ops/sampling.py).  A deeper scan
        # would silently reuse the camera slots for bounce randomness,
        # correlating samples — fail loudly instead.
        if self.max_depth > 30:
            raise ValueError(
                f"max_depth={self.max_depth} exceeds 30, the RNG slot-map "
                "limit (bounce b uses slots 4b..4b+3; camera uses 124/125 — "
                "see ops/sampling.py)"
            )

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@_pytree_dataclass
class RenderState:
    """Progressive accumulation state — the checkpointable unit.

    The reference persists nothing mid-render (a crash loses the image; the
    final BMP is the only artifact, include/IOHelpers.hpp:24-27).  Here a
    render is a fold over sample batches of this state, so snapshot/resume
    is `save(state)` / `continue accumulating`.
    """

    accum: Array          # [H, W, 3] f32 linear radiance sum
    sample_count: Array   # []  i32 samples accumulated so far
    next_key: Array       # PRNG key for the next sample batch

    def image(self, gamma: float = 2.0) -> Array:
        """Resolve to a gamma-corrected float image in [0, 1]."""
        n = jnp.maximum(self.sample_count, 1).astype(jnp.float32)
        linear = jnp.clip(self.accum / n, 0.0, 1.0)
        return linear ** (1.0 / gamma)

    def replace(self, **kw) -> "RenderState":
        return dataclasses.replace(self, **kw)
