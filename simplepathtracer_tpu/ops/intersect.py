"""Batched ray-sphere intersection: the innermost hot loop.

Reference counterpart: ``cd::FindClosestIntersectionSphere``
(include/Collision.hpp:87-109) — an O(S) scalar scan per ray with a
``uint8_t`` index (which silently truncates past 255 spheres) and a
distance-squared comparison.  The jnp form is a dense ``[N rays, S spheres]``
computation whose two inner products are expressed as ``[N,3] @ [3,S]``
matmuls, followed by elementwise math and a masked argmin over the sphere
axis; indices are int32, comparison is on the ray parameter t.  (The
forward kernel, ops/pallas_forward.py, scans spheres per lane instead.)

Numerics: the geometric form ``t = t_center -/+ sqrt(r^2 - d_perp^2)``
(include/Collision.hpp:19-47) is kept, with the discriminant clamped before
the sqrt so gradients stay finite at grazing hits (SURVEY.md S7 "hard
parts").  Both quadratic roots are computed; the far root is used when the
near one is behind ``t_min`` — required for dielectric interior hits and for
Shirley's negative-radius hollow glass, and the fix for the reference's
"forward-facing" test (Collision.hpp:99) which can only see near roots.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Hit(NamedTuple):
    t: jax.Array        # [N] f32 — ray parameter of closest hit (t_max if miss)
    index: jax.Array    # [N] i32 — sphere index of closest hit (0 if miss)
    hit: jax.Array      # [N] bool — any sphere hit in (t_min, t_max)
    point: jax.Array    # [N, 3] f32 — hit point
    normal: jax.Array   # [N, 3] f32 — outward normal (flipped for radius < 0)


# Gradient floor for sqrt(disc): keeps d sqrt/d theta finite at grazing hits.
_DISC_EPS = 1e-12


def ray_sphere_ts(origins, dirs, centers, radii, t_min):
    """Per (ray, sphere) candidate hit parameter.

    Returns (t [N,S], valid [N,S]).  The only O(N*S*3) work is two
    matmuls; everything else is rank-2 elementwise.
    """
    # t_center[n,s] = (c_s - o_n) . d_n
    # precision=HIGHEST: a default-precision f32 matmul may run in TF32 or
    # bf16 passes; intersection geometry needs true f32 (reduced-precision
    # t errors are ~1e-2 — visible acne).
    hi = jax.lax.Precision.HIGHEST
    d_dot_c = jnp.matmul(dirs, centers.T, precision=hi)         # [N,S]
    o_dot_d = jnp.sum(origins * dirs, -1, keepdims=True)        # [N,1]
    tc = d_dot_c - o_dot_d
    # |oc|^2 = |c|^2 - 2 o.c + |o|^2
    o_dot_c = jnp.matmul(origins, centers.T, precision=hi)      # [N,S]
    oc2 = (
        jnp.sum(centers * centers, -1)[None, :]
        - 2.0 * o_dot_c
        + jnp.sum(origins * origins, -1, keepdims=True)
    )
    disc = radii[None, :] ** 2 - (oc2 - tc * tc)
    valid = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, _DISC_EPS))
    t_near = tc - sq
    t_far = tc + sq
    # Near root if it is in front of t_min, else far root (ray starts inside
    # or on the sphere — dielectric interiors, hollow-glass shells).
    t = jnp.where(t_near > t_min, t_near, t_far)
    return t, valid


# Soft-silhouette logistic clamp:
# saturates the sigmoid exactly in f32 and keeps every vjp finite.
_XS_CLAMP = 30.0

# Radius cap in the silhouette band scale (below): for object-sized
# spheres (r << R0) the band is the established soft * r^2; for giant
# spheres the raw r^2 scaling is a parameterization artifact — a 100-radius
# ground sphere's band would span ~15 * soft * r = 75 world units at
# soft 0.05, making its ENTIRE visible area stochastic (measured: its
# geometry AD/FD lands wrong-signed in the noise while object spheres
# validate at ~1.0).  The cap bounds the band to ~soft * R0 world units.
_SIL_R0 = 8.0


def silhouette_scale(softness, r):
    """Shared silhouette band scale sigma(r): disc / sigma is the logistic
    argument and logit(u) * sigma the acceptance threshold.

    sigma = soft * r^2 * R0 / (R0 + |r|): equals soft * r^2 for r << R0
    (band half-width ~15 * soft * r near the edge), saturating to
    soft * |r| * R0 for giant spheres (world-space half-width ~7.5 *
    soft * R0, radius-independent).  Smooth and differentiable in r;
    negative (hollow-glass) radii work through |r|."""
    c = jnp.float32(softness * _SIL_R0)
    return (r * r) * c / (jnp.float32(_SIL_R0) + jnp.abs(r))


# Estimator-ablation switch (module-level, read at trace time): the
# detached Schlick-coin probability ratio in scatter paths under soft
# configs.  Formally unbiased (captures dP * (L_refl - L_refr)), but
# MEASURED net-harmful at realistic sampling — the grazing-side weight
# 1/(1 - reflect_prob) is heavy-tailed and moved the glass-scene geometry
# AD/FD from 1.24 to 1.56 at 256 spp (experiments/r5_estimator_grid.py).
# Default OFF; the switch remains for A/B.
SIL_FRESNEL = False

# Floor on the realized-outcome probability p = We - M in the detached
# REINFORCE ratio p / stop_grad(p): caps the per-sample weight |dp| / p at
# 1/floor (the raw weight is heavy-tailed — P(p < x) ~ x for a uniform
# coin, so unfloored variance diverges logarithmically and low-spp Adam
# fits ride outliers).  Gradient contributions of outcomes rarer than the
# floor are under-weighted by p/floor — a bias bounded by the floor itself;
# measured AD/FD stays ~1.0 through 3e-2 (experiments/r5_two_sided_fd.py).
SIL_P_FLOOR = 1e-2


def crossing_scale(softness, r):
    """t-space band scale sigma_x(r) for the stochastic WINNER-SELECT coin
    (opaque-opaque intersection edges, round 5).

    The acceptance coin smooths hit-vs-miss edges, but where two solid
    surfaces CROSS (a sphere poking through the ground plane) both
    opacities saturate and the discontinuity lives in the t-argmin.  The
    crossing coin accepts the sphere iff t_s < t_p + logit(u) * sigma_x,
    i.e. P(sphere wins) = sigmoid((t_p - t_s) / sigma_x); the realized
    outcome's probability folds into the detached REINFORCE ratio next to
    (We - M).  sigma_x = soft * |r| * R0 / (R0 + |r|): linear in the
    sphere radius for object-sized spheres (the transition band moves
    O(soft * r) along the ray — commensurate with the silhouette band),
    saturating at soft * R0 for giants (same rationale as
    silhouette_scale's cap).  Smooth in r; |r| handles hollow-glass
    negative radii."""
    a = jnp.abs(r)
    return softness * a * jnp.float32(_SIL_R0) / (jnp.float32(_SIL_R0) + a)


# Validity band scale: sigma_v = softness * _SIG_V0, RADIUS-INDEPENDENT.
# The t > t_min candidate-validity test is the remaining unsmoothed
# t-threshold compare (measured: far-root exits of phantom-continuation
# chains sliding past t_min carried ~35% of a crossing-heavy scene's true
# gradient — experiments/r5_crossing_fd.py); the validity coin softens it
# with the same machinery as the winner crossing.  Unlike the crossing
# band, the t_min gate is a LOCAL phenomenon at the ray origin — a
# radius-scaled band handed the r=100 ground sphere a +-3 t-unit
# stochastic-validity zone covering every near hit in the scene (measured:
# trio-scene geometry AD/FD flipped to -0.83).  softness * 0.1 reproduces
# the band the crossing-heavy probes validated (sigma_v ~ 5e-3 at
# soft 0.05).
_SIG_V0 = 0.1


def validity_scale(softness, r):
    """t-space band scale for the candidate-validity coin (t > t_min):
    radius-independent (see _SIG_V0); ``r`` kept for signature symmetry
    and per-sphere table builds."""
    return jnp.broadcast_to(
        jnp.float32(softness * _SIG_V0), jnp.shape(r)
    ).astype(jnp.float32)


def grad_capped_sqrt(dmax, scale):
    """sqrt(dmax) in VALUE with its derivative capped at 1/(2 sqrt(scale)).

    The hit-t reconstruction t = tc -/+ sqrt(disc) has d t / d disc =
    1/(2 sqrt(disc)) — unbounded at grazing hits, and under the soft
    scheme grazing/phantom winners are COMMON (the band samples them on
    purpose), so a handful of near-tangent chains carry 1e3-1e5x weights
    and the sampled geometry gradient sits persistently ~10-30% high of FD
    (experiments/r5_estimator_grid.py).  Within the silhouette band the
    surface position is fuzzy at the band scale anyway; capping the
    derivative there is the consistent smoothing:

        value    = sqrt(dmax)                       (bit-exact forward*)
        gradient = d sqrt(dmax + scale)             (<= 1/(2 sqrt(scale)))

    (*) value is sqrt(dmax) up to one f32 rounding of the stop_gradient
    identity x = sg(x - y) + y.  Soft paths only.
    """
    exact = jnp.sqrt(dmax)
    capped = jnp.sqrt(dmax + scale)
    return jax.lax.stop_gradient(exact - capped) + capped


def silhouette_logit(u):
    """Acceptance-coin logit for the two-sided stochastic-transparency
    estimator, clamped to the same +-30 band as the blend sigmoid.

    Sphere s is accepted iff sigmoid(disc_s / (soft * r_s^2)) > u, i.e.
    disc_s > logit(u) * soft * r_s^2 — one transcendental pair per
    (ray, bounce) instead of a per-sphere sigmoid.  u = 0 (possible from
    the 24-bit uniform) clamps to "accept anything in the +-30 band".
    """
    tiny = 1e-30
    return jnp.clip(
        jnp.log(jnp.maximum(u, tiny)) - jnp.log(jnp.maximum(1.0 - u, tiny)),
        -_XS_CLAMP, _XS_CLAMP,
    )


def intersect_scene_soft(
    origins, dirs, u, uv, scene, t_min, t_max, softness, prev_idx=None
) -> tuple[Hit, jax.Array]:
    """Stochastic-transparency closest hit: the two-sided soft-silhouette
    semantic (round 5).

    Each sphere carries opacity w_s = sigmoid(disc_s / (softness * r_s^2))
    — 1 for solid hits, 0 far from the surface, partial inside the
    silhouette band.  One shared coin ``u`` per ray decides acceptance
    (w_s > u, tested in logit space — see silhouette_logit); the winner is
    the NEAREST accepted sphere, which near an edge is sometimes a GRAZING
    phantom (disc < 0, t = t_center).  Additionally returns ``blocker_idx``
    [N] i32: among spheres the coin REJECTED whose WOULD-BE hit t (the
    same clamped-sqrt t an accepted sphere gets — NOT t_center, which for
    a large grazing sphere like the ground overshoots by up to ~r) lies
    strictly in front of the running winner, the one with max normalized
    disc (-1 if none) — the lane's strongest front occluder, whose opacity
    M the bounce's detached-weight ratio (W - M) / stop_grad(W - M)
    differentiates.  In expectation the estimator's gradient is the full
    two-sided visibility derivative dw * (L_front - L_behind); the
    one-sided round-4 blend measured AD/FD = 0.49 on geometry leaves
    because it dropped L_behind.

    Semantics include a running-best-t blocker filter and first-wins tie
    breaks, as a one-pass scan in sphere order would have; the final
    strictly-in-front validity test (t_blocker < t_winner) is applied by
    the bounce, which recomputes it from the blocker's attributes.

    Reference counterpart: none (the reference is not differentiable);
    the hard limit softness -> 0 is FindClosestIntersectionSphere
    (include/Collision.hpp:87-109).
    """
    hi = jax.lax.Precision.HIGHEST
    centers, radii = scene.centers, scene.radii
    d_dot_c = jnp.matmul(dirs, centers.T, precision=hi)
    o_dot_d = jnp.sum(origins * dirs, -1, keepdims=True)
    tc = d_dot_c - o_dot_d
    o_dot_c = jnp.matmul(origins, centers.T, precision=hi)
    oc2 = (
        jnp.sum(centers * centers, -1)[None, :]
        - 2.0 * o_dot_c
        + jnp.sum(origins * origins, -1, keepdims=True)
    )
    r2 = radii * radii
    disc = r2[None, :] - (oc2 - tc * tc)
    scale = silhouette_scale(softness, radii)
    thr = silhouette_logit(u)[:, None] * scale[None, :]
    sq = grad_capped_sqrt(jnp.maximum(disc, _DISC_EPS), scale[None, :])
    t_near = tc - sq
    t_raw = jnp.where(t_near > t_min, t_near, tc + sq)
    # Validity coin (round 5): the t > t_min candidate gate is the last
    # unsmoothed t-threshold compare — far-root exits of phantom
    # continuations slide past it discontinuously.  Candidate s is valid
    # iff t_raw > t_min + logit(uv) * sigma_v(r_s) (one shared coin per
    # ray); the realized t clamps to t_min so a coin-validated marginal
    # candidate hits AT the origin, never behind it.  ``prev_idx`` ([N]
    # i32, -1 = none): the chain's previous sphere winner keeps the HARD
    # gate — a ray leaving a sphere has its own far root at exactly 0,
    # one band-sigma below ANY threshold centered at t_min, so the coin
    # would re-validate ~half of all bounces as in-place self-hits
    # (dielectric interior exits still pass the hard gate: their real exit
    # t is far above t_min).
    sigv = validity_scale(softness, radii)
    thr_v = t_min + silhouette_logit(uv)[:, None] * sigv[None, :]
    gate_lo = (t_min - 30.0 * sigv)[None, :]
    if prev_idx is not None:
        is_prev = prev_idx[:, None] == jnp.arange(
            radii.shape[0], dtype=jnp.int32
        )[None, :]
        thr_v = jnp.where(is_prev, t_min, thr_v)
        gate_lo = jnp.where(is_prev, t_min, gate_lo)
    t = jnp.maximum(t_raw, t_min)
    accept = (disc > thr) & (t_raw > thr_v) & (t_raw < t_max)
    t_sel = jnp.where(accept, t, t_max)
    index = jnp.argmin(t_sel, axis=-1).astype(jnp.int32)
    t_hit = jnp.take_along_axis(t_sel, index[:, None], axis=-1)[:, 0]
    hit = t_hit < t_max

    # Blocker: one-pass scan semantics — a rejected sphere qualifies if
    # its would-be hit t beats the best accepted t seen SO FAR (exclusive
    # running min in sphere-index order); max normalized disc wins, first
    # on ties.  The validity band's lower edge (t_raw > t_min - 30 sigma_v)
    # bounds candidacy: below it V == 0 exactly and a behind-the-origin
    # solid (e.g. the SELF sphere after a bounce) must not hijack the slot.
    n = origins.shape[0]
    cmin = jax.lax.cummin(t_sel, axis=1)
    bt_before = jnp.concatenate(
        [jnp.full((n, 1), t_max, t_sel.dtype), cmin[:, :-1]], axis=-1
    )
    rej_front = (~accept) & (t_raw > gate_lo) & (t < bt_before)
    score = jnp.where(rej_front, disc / r2[None, :], -jnp.inf)
    bidx = jnp.argmax(score, axis=-1).astype(jnp.int32)
    blocker_idx = jnp.where(jnp.any(rej_front, axis=-1), bidx, -1)

    point = origins + t_hit[:, None] * dirs
    c = centers[index]
    r = radii[index]
    nrm = (point - c) / r[:, None]
    nrm = nrm / jnp.sqrt(jnp.sum(nrm * nrm, -1, keepdims=True) + 1e-20)
    return (
        Hit(t=t_hit, index=index, hit=hit, point=point, normal=nrm),
        blocker_idx,
    )


def intersect_scene(origins, dirs, scene, t_min=1e-3, t_max=3.0e7) -> Hit:
    """Closest hit over all spheres for a batch of rays.

    origins, dirs: [N, 3] f32 (dirs unit length).
    """
    t, valid = ray_sphere_ts(origins, dirs, scene.centers, scene.radii, t_min)
    ok = valid & (t > t_min) & (t < t_max)
    t_sel = jnp.where(ok, t, t_max)
    index = jnp.argmin(t_sel, axis=-1).astype(jnp.int32)
    t_hit = jnp.take_along_axis(t_sel, index[:, None], axis=-1)[:, 0]
    hit = t_hit < t_max

    point = origins + t_hit[:, None] * dirs
    c = scene.centers[index]            # [N,3] gather
    r = scene.radii[index]              # [N]
    # Outward normal; dividing by signed radius flips it for hollow glass
    # (negative radii), matching Shirley.  Renormalize for fp robustness on
    # huge ground spheres.
    n = (point - c) / r[:, None]
    n = n / jnp.sqrt(jnp.sum(n * n, -1, keepdims=True) + 1e-20)
    return Hit(t=t_hit, index=index, hit=hit, point=point, normal=n)
