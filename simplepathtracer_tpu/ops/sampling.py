"""Stateless, counter-based sampling.

The reference uses a wall-clock-seeded ``thread_local`` splitmix engine
(include/Random.hpp:11-46, 86-93): renders are irreproducible and the random
stream depends on the thread schedule.  This build makes every random
number a pure function of

    (base_key, pixel_id, sample_id, slot)

via a hand-vectorized threefry2x32 block cipher over u32 counters:

    bits = threefry2x32(key, counter = (pixel_id, sample_id << 8 | slot))

so the image is bit-identical under any sharding of pixels/samples across
devices — the determinism guardrail SURVEY.md S5 calls for.  Compared to
vmapping ``jax.random.fold_in`` chains this is pure elementwise u32 math
(~200 ops per ray-bounce, no per-element key arrays, no gathers), and the
same function runs inside the forward kernel (ops/pallas_forward.py).

Slot map (each slot = one threefry eval = 2 words):
    bounce b, eval e in 0..3  ->  slot b*4 + e   (depth <= 30)
    camera jitter             ->  slots 124, 125
    winner-crossing coin      ->  slot 128 + b   (plane+soft configs only)

Direction samplers replace include/Random.hpp:95-141 with the *intended*
semantics (the reference's "inside sphere" sampler inverts its rejection test
and actually samples a shell, and its "normal dist" sampler is a copy of the
uniform one — SURVEY.md S2), using the rejection-free (z, phi)
parameterization: z ~ U(-1,1) is the cosine-latitude (uniform on the sphere
by Archimedes), phi ~ U(0, 2pi), and the ball radius is cbrt(U) — no
while-loops, fixed cost, layout-independent.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# threefry2x32 rotation schedule (Salmon et al., SC'11; same as jax's PRNG).
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """20-round threefry2x32: (2 u32 keys, 2 u32 counters) -> 2 u32 words.

    Pure elementwise u32 arithmetic — vectorizes over any counter shape.
    """
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = c0 + k0
    x1 = c1 + k1

    def four(x0, x1, rs):
        for r in rs:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        return x0, x1

    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = x0 + k1, x1 + ks2 + jnp.uint32(1)
    x0, x1 = four(x0, x1, _ROT[4:])
    x0, x1 = x0 + ks2, x1 + k0 + jnp.uint32(2)
    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = x0 + k0, x1 + k1 + jnp.uint32(3)
    x0, x1 = four(x0, x1, _ROT[4:])
    x0, x1 = x0 + k1, x1 + ks2 + jnp.uint32(4)
    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = x0 + ks2, x1 + k0 + jnp.uint32(5)
    return x0, x1


def _to_unit_float(bits):
    """u32 -> f32 in [0, 1) using the top 24 bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * np.float32(2.0**-24)


class RayCtx(NamedTuple):
    """Per-ray RNG context: cipher key + global (pixel, sample) counters."""

    k0: Array      # [] u32
    k1: Array      # [] u32
    pixel: Array   # [N] u32 — global pixel id
    sample: Array  # [N] u32 — global sample id (< 2^24)


def ray_keys(base_key, pixel_ids, sample_ids) -> RayCtx:
    """Build the per-ray RNG context from global (pixel, sample) ids."""
    kd = base_key if base_key.dtype == jnp.uint32 else jax.random.key_data(base_key)
    pixel_ids, sample_ids = jnp.broadcast_arrays(
        jnp.asarray(pixel_ids), jnp.asarray(sample_ids)
    )
    return RayCtx(
        k0=kd[0],
        k1=kd[1],
        pixel=pixel_ids.astype(jnp.uint32),
        sample=sample_ids.astype(jnp.uint32),
    )


def _uniform_words(ctx: RayCtx, slot0, n_evals: int):
    """n_evals threefry evals -> 2*n_evals uniform [N] f32 columns."""
    c1_base = ctx.sample << jnp.uint32(8)
    cols = []
    for e in range(n_evals):
        slot = (jnp.uint32(slot0) + jnp.uint32(e)).astype(jnp.uint32)
        w0, w1 = threefry2x32(ctx.k0, ctx.k1, ctx.pixel, c1_base | slot)
        cols.append(_to_unit_float(w0))
        cols.append(_to_unit_float(w1))
    return cols


def bounce_noise(ctx: RayCtx, bounce):
    """All randomness one bounce step needs, per ray: uniforms [N, 8].

    Columns: 0-1 Lambertian (z, phi); 2-4 metal fuzz ball (z, phi, r);
    5 dielectric reflect coin; 6 Russian roulette; 7 soft-silhouette
    acceptance coin (the two-sided stochastic-transparency estimator,
    round 5).  All 8 words come from the same 4 threefry evals the slot
    map always reserved for a bounce — the stream is unchanged.
    """
    slot0 = jnp.asarray(bounce, jnp.uint32) * jnp.uint32(4)
    cols = _uniform_words(ctx, slot0, 4)
    return jnp.stack(cols, axis=-1)


def crossing_noise(ctx: RayCtx, bounce):
    """The two t-threshold coins for bounce ``bounce``: (ux, uv), each [N].

    ux drives the stochastic plane-vs-sphere winner select of the
    opaque-opaque intersection-edge estimator (round 5): the nearest
    accepted sphere beats the plane iff t_s < t_p + logit(ux) * sigma_x.
    uv drives the candidate-VALIDITY coin: candidate s is valid iff
    t_raw > t_min + logit(uv) * sigma_v(r_s) — the smoothed form of the
    t > t_min gate whose far-root flips carried the phantom-continuation
    gradient mass.  Lives in its own slot region (128 + b; the 8-bit slot
    space is only used to 125 by the bounce/camera map) so the established
    stream is untouched; only evaluated when softness > 0.
    """
    slot = jnp.uint32(128) + jnp.asarray(bounce, jnp.uint32)
    c1 = (ctx.sample << jnp.uint32(8)) | slot
    w0, w1 = threefry2x32(ctx.k0, ctx.k1, ctx.pixel, c1)
    return _to_unit_float(w0), _to_unit_float(w1)


def camera_jitter(ctx: RayCtx):
    """Per-ray (2 pixel-jitter, 2 lens-disk) uniforms [N, 4].

    Reference: per-sample jitter u,v in [0,1) added to pixel coordinates
    (include/SingleThreadPathTracer.hpp:125-126); the lens draws support the
    defocus camera (BASELINE config 3) that the reference lacks.
    """
    cols = _uniform_words(ctx, jnp.uint32(124), 2)
    return jnp.stack(cols, axis=-1)


def unit_sphere_surface(u_z, u_phi):
    """Uniform directions on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u_z
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = (2.0 * np.pi) * u_phi
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def in_unit_ball(u_z, u_phi, u_r):
    """Uniform points inside the unit ball: surface point scaled by U^(1/3).

    Intended semantics of include/Random.hpp:115-127 (whose rejection test is
    inverted; it really samples the shell between the unit sphere and its
    bounding cube — we implement the textbook ball).
    """
    return unit_sphere_surface(u_z, u_phi) * jnp.cbrt(u_r)[..., None]
