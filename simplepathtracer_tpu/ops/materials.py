"""Branchless material shading: one masked-select step for all rays.

Reference counterpart: the per-hit ``switch (g_materials[i])`` dispatch into
SampleColorDiffuse/Reflective/Refractive (include/SingleThreadPathTracer.hpp:
94-112) and the wavefront tracer's material-binned queues
(include/TaskBasedPathTracer.hpp:9-30).  Here uniform control flow replaces
compaction: every ray computes all three scatter candidates and a
``jnp.where`` over the material id picks one (SURVEY.md S7 design stance).

Semantics are the *intended* Shirley ones (the reference's quirks — 0.5
hard-coded diffuse falloff, hit-point added into the diffuse direction at
SingleThreadPathTracer.hpp:32, ignored colors for metal/glass — are
documented divergences; see SURVEY.md S2 "Material model").

Differentiability: sampled noise is treated as a reparameterized constant
(`stop_gradient` on the random draws' *selection* effects only); gradients
flow through albedo/fuzz/ior/centers/radii via the throughput product and
the hit geometry (SURVEY.md S7 stage 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import Material
from .sampling import in_unit_ball, unit_sphere_surface


def sky_color(dirs, sky_lo, sky_hi):
    """Vertical sky gradient.

    Generalizes both the reference's ``initColor * (dir.y + 1) / 2``
    (include/SingleThreadPathTracer.hpp:11-19; sky_lo = 0) and Shirley's
    white-to-blue lerp.
    """
    s = 0.5 * (dirs[..., 1:2] + 1.0)
    return sky_lo + (sky_hi - sky_lo) * s


def _reflect(d, n):
    """Mirror reflection (include/Math.hpp:156 semantics)."""
    return d - 2.0 * jnp.sum(d * n, -1, keepdims=True) * n


def _safe_normalize(v, fallback):
    n2 = jnp.sum(v * v, -1, keepdims=True)
    unit = v / jnp.sqrt(jnp.maximum(n2, 1e-20))
    return jnp.where(n2 > 1e-12, unit, fallback)


def scatter(dirs, hit, scene, unif, fresnel_score=False):
    """One surface interaction for every ray in the wavefront.

    Args:
      dirs: [N,3] incident unit directions.
      hit: Hit namedtuple from intersect_scene.
      scene: Scene.
      unif: [N,8] uniforms (bounce_noise column contract).
      fresnel_score: see scatter_attrs.

    Returns (new_dirs [N,3], attenuation [N,3], scattered [N] bool).
    ``scattered`` is False for metal rays absorbed into the surface
    (Shirley's dot(scatter, normal) <= 0 check).
    """
    mat = scene.material[hit.index]          # [N] i32
    albedo = scene.albedo[hit.index]         # [N,3]
    fuzz = scene.fuzz[hit.index]             # [N]
    ior = scene.ior[hit.index]               # [N]
    return scatter_attrs(
        dirs, hit.normal, mat, albedo, fuzz, ior, unif,
        fresnel_score=fresnel_score,
    )


def scatter_attrs(dirs, n, mat, albedo, fuzz, ior, unif, fresnel_score=False):
    """scatter() on pre-gathered per-ray attributes (the plane branch of
    the bounce overrides them on plane hits)."""
    # Face-forward normal: outward if the ray arrives from outside.
    front = jnp.sum(dirs * n, -1) < 0.0      # [N]
    n_face = jnp.where(front[:, None], n, -n)

    # --- Lambertian (reference Material::DIFFUSE,
    #     SingleThreadPathTracer.hpp:21-37) -----------------------------
    lam_dir = _safe_normalize(
        n_face + unit_sphere_surface(unif[:, 0], unif[:, 1]), n_face
    )

    # --- Metal (reference Material::REFLECTIVE, :39-46) ----------------
    refl = _reflect(dirs, n_face)
    metal_dir = _safe_normalize(
        refl + fuzz[:, None] * in_unit_ball(unif[:, 2], unif[:, 3], unif[:, 4]),
        n_face,
    )
    metal_ok = jnp.sum(metal_dir * n_face, -1) > 0.0

    # --- Dielectric (reference Material::REFRACTIVE, :48-92) -----------
    # eta ratio entering vs exiting; Schlick + total-internal-reflection.
    eta = jnp.where(front, 1.0 / ior, ior)   # [N]
    cos_t = jnp.minimum(-jnp.sum(dirs * n_face, -1), 1.0)
    # TIR test without a sqrt: eta^2 sin^2 > 1 (booleans carry no gradient,
    # and sqrt'(0) = inf would NaN-poison grads through the unselected
    # branch of the material select below).
    sin2 = jnp.maximum(1.0 - cos_t * cos_t, 0.0)
    cannot_refract = eta * eta * sin2 > 1.0
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    reflect_prob = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    coin = unif[:, 5]
    do_reflect = cannot_refract | (coin < jax.lax.stop_gradient(reflect_prob))
    # Refraction (Snell): perp + parallel decomposition.  The clamp floor is
    # strictly positive so d sqrt/d theta stays finite at the TIR boundary
    # and at head-on hits (cos_t == 1 exactly after the min clamp).
    perp = eta[:, None] * (dirs + cos_t[:, None] * n_face)
    par_len = jnp.sqrt(jnp.maximum(1.0 - jnp.sum(perp * perp, -1), 1e-12))
    refr = perp - par_len[:, None] * n_face
    diel_dir = jnp.where(do_reflect[:, None], _reflect(dirs, n_face), refr)
    diel_dir = _safe_normalize(diel_dir, n_face)

    # --- Select by material (branchless) --------------------------------
    is_metal = mat == Material.METAL
    is_diel = mat == Material.DIELECTRIC
    new_dirs = jnp.where(is_metal[:, None], metal_dir, lam_dir)
    new_dirs = jnp.where(is_diel[:, None], diel_dir, new_dirs)
    diel_att = jnp.ones_like(albedo)
    if fresnel_score:
        # Detached Schlick-coin probability ratio (round 5, soft configs):
        # the realized branch's probability p (reflect_prob on reflection —
        # 1 under TIR — else 1 - reflect_prob) over its own stop_gradient
        # == 1.0 exactly in fp, and its vjp carries dP * (L_realized) —
        # in expectation the Fresnel-coin gradient dP * (L_refl - L_refr)
        # the locally-constant-coin treatment drops (measured ~+0.3 of
        # geometry AD/FD on the specular trio).  Same floor policy as the
        # silhouette ratio (grazing 1 - reflect_prob can be tiny).
        from .intersect import SIL_P_FLOOR

        p_evt = jnp.where(
            do_reflect,
            jnp.where(cannot_refract, 1.0, reflect_prob),
            1.0 - reflect_prob,
        )
        p_evt = jnp.maximum(p_evt, SIL_P_FLOOR)
        diel_att = (p_evt / jax.lax.stop_gradient(p_evt))[:, None] * diel_att
    attenuation = jnp.where(is_diel[:, None], diel_att, albedo)
    scattered = jnp.where(is_metal, metal_ok, True)
    return new_dirs, attenuation, scattered
