"""Path tracing: the jnp wavefront (reference and gradient path) and the
entry points that choose between it and the forward kernel.

Design (SURVEY.md S7): the reference forks into a recursive megakernel
(include/SingleThreadPathTracer.hpp:94-137) and a material-binned wavefront
with compaction queues (include/TaskBasedPathTracer.hpp:54-206).  The jnp
path is a single *uniform* wavefront: every live ray advances one bounce
per ``lax.scan`` step, materials are resolved with masked selects, and dead
rays are masked rather than compacted.  The reference's unbounded specular
recursion (SingleThreadPathTracer.hpp:45,63 never decrement bounceCount)
becomes a fixed ``max_depth`` budget for every material.

Each bounce body is wrapped in ``jax.checkpoint`` so the backward pass of a
``max_depth``-step scan rematerializes per bounce instead of storing all
[N, S] intersection intermediates (SURVEY.md S7 hard part 4).

``use_pallas=True`` renders forward-only through the GPU kernel in
ops/pallas_forward.py (one lane per pixel, in-place regeneration).
Gradients always take the jnp bounce.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .camera import generate_rays
from .ops.intersect import intersect_scene, intersect_scene_soft
from .ops.materials import scatter, sky_color
from .ops.sampling import bounce_noise, camera_jitter, ray_keys
from .types import Camera, RenderConfig, RenderState, Scene


def _vary_like(xs, refs):
    """Cast fresh constants to the union of the refs' varying manual axes.

    Under ``shard_map`` a ``lax.scan`` carry must have the same vma set as the
    body's output; constants created inside the body are unvarying while
    values derived from sharded inputs are varying, so scan inits built from
    ``jnp.zeros``/``ones`` need an explicit ``pcast``.  Outside shard_map this
    is the identity.
    """
    vma = frozenset()
    for r in jax.tree.leaves(refs):
        vma |= getattr(jax.typeof(r), "vma", frozenset())
    if not vma:
        return xs
    return jax.tree.map(lambda x: jax.lax.pcast(x, tuple(vma), to="varying"), xs)


def kernel_available(config: RenderConfig) -> bool:
    """The one capability check for the forward kernel: it runs compiled
    on a GPU, and interpreted only when ``pallas_interpret=True`` asks."""
    return config.pallas_interpret or jax.default_backend() == "gpu"


def _kernel_interpret(config: RenderConfig) -> bool:
    """``interpret`` for the kernel call; an error where it cannot run."""
    if not kernel_available(config):
        raise RuntimeError(
            "use_pallas=True needs a GPU, but JAX's backend is "
            f"{jax.default_backend()!r}: set use_pallas=False (the jnp path; "
            "--no-pallas on the CLI) or pallas_interpret=True"
        )
    return config.pallas_interpret


# Device bytes one ray in flight costs on the jnp path: the [rays, spheres]
# intersection intermediates of a rematerialized bounce plus the per-bounce
# scan residuals, at the cover preset (484 spheres, depth 10) under
# value_and_grad.  Measured on an H100 as the growth of peak_bytes_in_use
# from 1 to 2 spp at 1200x800: 14,148 B hard, 15,560 B with soft
# silhouettes (PERF.md); the larger, rounded up, bounds both.
_BYTES_PER_RAY = 15_600
# Share of the device's memory a chunk of rays may take.
_MEMORY_SHARE = 0.5
# Rays per chunk where the device reports no memory limit (the CPU): a
# fixed, conservative 2 M rays (~2 spp at 1200x800).
_HOST_RAY_BUDGET = 2_000_000


def ray_budget(bytes_limit: int | None = None) -> int:
    """Rays the jnp path may trace at once (forward or under autodiff).

    ``bytes_limit`` defaults to the first device's
    ``memory_stats()["bytes_limit"]``; a device without memory stats (the
    CPU) gets the fixed ``_HOST_RAY_BUDGET``.
    """
    if bytes_limit is None:
        stats = jax.devices()[0].memory_stats() or {}
        bytes_limit = stats.get("bytes_limit")
    if not bytes_limit:
        return _HOST_RAY_BUDGET
    return max(1, int(bytes_limit * _MEMORY_SHARE) // _BYTES_PER_RAY)


def spp_chunk(config: RenderConfig, n_pixels: int, n_samples: int,
              bytes_limit: int | None = None) -> int:
    """Samples per scan step of the jnp path for a block of ``n_pixels``.

    An explicit ``config.spp_chunk`` is an upper bound; otherwise the chunk
    keeps ``chunk * n_pixels`` within ray_budget.  The result always
    divides ``n_samples`` (the largest divisor that fits): a sharded call
    sees ``n_samples = spp / mesh_samples``, which a chunk need not divide.
    """
    chunk = config.spp_chunk or max(1, ray_budget(bytes_limit) // n_pixels)
    chunk = min(chunk, n_samples)
    return next(c for c in range(chunk, 0, -1) if n_samples % c == 0)


def grad_safe_config(config: RenderConfig) -> RenderConfig:
    """Downgrade a config for use under ``jax.grad``.

    The forward kernel is not differentiable, so every gradient entry point
    clears ``use_pallas`` and takes the jnp bounce.  Memory under autodiff
    is bounded by render_pixel_block's spp chunking (see spp_chunk).
    """
    return config.replace(use_pallas=False) if config.use_pallas else config


def crossing_probability(ph_t, t_w, sigx, plane_won):
    """Probability of the realized plane-vs-sphere select (soft configs).

    The sphere beats the plane with q = sigmoid((t_p - t_w) / sigma_x).
    The plane's side is sigmoid of the negated argument, not 1 - q: once
    the sphere leads by ~16.7 sigma, 1 - q rounds to 0 in f32, and a
    realized plane win would turn the detached ratio den / stop_grad(den)
    into 0 / 0.
    """
    arg = jnp.clip((ph_t - t_w) / (sigx + 1e-12), -30.0, 30.0)
    return jnp.where(plane_won, jax.nn.sigmoid(-arg), jax.nn.sigmoid(arg))


def trace_rays(origins, dirs, keys, scene: Scene, config: RenderConfig):
    """Trace a batch of rays to completion. Returns radiance [N, 3].

    The bounce loop is the wavefront form of TraceAndSampleColor
    (SingleThreadPathTracer.hpp:94-112): closest hit -> material scatter ->
    throughput update, with the sky gradient as the miss shader and a live
    mask instead of early returns.
    """

    def bounce(carry, b):
        o, d, tp, rad, alive, prev = carry
        wc3 = wr = pw_mask = blk = ph_t = cross_valid = widx = None
        unif = bounce_noise(keys, b)
        if scene.plane is None:
            if config.silhouette_softness > 0.0:
                # Two-sided soft silhouettes (round 5): stochastic-
                # transparency closest hit — a shared coin decides sphere
                # acceptance by silhouette opacity, and the strongest
                # REJECTED front sphere (the blocker) is tracked for the
                # detached probability ratio below.
                from .ops.sampling import crossing_noise

                _, uvw = crossing_noise(keys, b)
                hit, blk = intersect_scene_soft(
                    o, d, unif[:, 7], uvw, scene, config.t_min, config.t_max,
                    config.silhouette_softness, prev_idx=prev,
                )
                wc3 = scene.centers[hit.index]
                wr = scene.radii[hit.index]
                widx = jnp.where(hit.hit, hit.index, -1)
            else:
                hit = intersect_scene(o, d, scene, config.t_min, config.t_max)
            from .ops import intersect as _I

            new_d, att, scattered = scatter(
                d, hit, scene, unif,
                fresnel_score=(
                    config.silhouette_softness > 0.0 and _I.SIL_FRESNEL
                ),
            )
        else:
            # Sphere scan + Lambertian ground-plane candidate (the
            # reference's dead Collision.hpp:73-85, live here).  Where the
            # plane is nearer, the winner's point/normal/attributes are
            # overridden; sphere-table cotangents are blocked by the selects
            # on plane-win lanes (their gathered values are unused).
            from .ops.materials import scatter_attrs
            from .ops.plane import ray_plane_intersection

            if config.silhouette_softness > 0.0:
                from .ops.sampling import crossing_noise

                uxw, uvw = crossing_noise(keys, b)
                hit, blk = intersect_scene_soft(
                    o, d, unif[:, 7], uvw, scene, config.t_min, config.t_max,
                    config.silhouette_softness, prev_idx=prev,
                )
            else:
                hit = intersect_scene(o, d, scene, config.t_min, config.t_max)
            # The plane normal is unit-constrained and NOT a differentiable
            # parameter (offset + albedo are).
            ph = ray_plane_intersection(
                o, d, jax.lax.stop_gradient(scene.plane[:3]), scene.plane[3],
                config.t_min, config.t_max,
            )
            if config.silhouette_softness > 0.0:
                # Stochastic WINNER SELECT at the plane-vs-sphere t-crossing
                # (round 5): where both candidates are solid the acceptance
                # coin can't see the edge (opacities saturate), so the
                # nearest-wins compare itself gets a coin — the sphere beats
                # the plane iff t_s < t_p + logit(ux) * sigma_x(r), i.e.
                # P(sphere wins) = sigmoid((t_p - t_s) / sigma_x).  The
                # realized outcome's probability joins the detached ratio
                # below, carrying the intersection-circle edge gradient
                # dq * (L_sphere - L_plane) no smoothing estimator reaches.
                from .ops.intersect import crossing_scale, silhouette_logit

                sg = jax.lax.stop_gradient
                thr_x = silhouette_logit(uxw) * crossing_scale(
                    config.silhouette_softness, sg(scene.radii[hit.index])
                )
                pw = ph.hit & ~(hit.hit & (hit.t < ph.t + thr_x))
                ph_t = ph.t
                cross_valid = ph.hit & hit.hit
            else:
                pw = ph.hit & (ph.t < hit.t)
            from .ops.intersect import Hit

            hit = Hit(
                t=jnp.where(pw, ph.t, hit.t),
                index=hit.index,
                hit=hit.hit | pw,
                point=jnp.where(pw[:, None], ph.point, hit.point),
                normal=jnp.where(pw[:, None], ph.normal, hit.normal),
            )
            i = hit.index
            mat = jnp.where(pw, 0, scene.material[i])
            alb = jnp.where(pw[:, None], scene.plane[None, 4:7], scene.albedo[i])
            fz = jnp.where(pw, 0.0, scene.fuzz[i])
            io = jnp.where(pw, 1.0, scene.ior[i])
            from .ops import intersect as _I

            new_d, att, scattered = scatter_attrs(
                d, hit.normal, mat, alb, fz, io, unif,
                fresnel_score=(
                    config.silhouette_softness > 0.0 and _I.SIL_FRESNEL
                ),
            )
            if config.silhouette_softness > 0.0:
                # Plane wins have no silhouette term (pw_mask excludes them).
                wc3 = scene.centers[i]
                wr = scene.radii[i]
                pw_mask = pw
                widx = jnp.where(hit.hit & ~pw, hit.index, -1)

        if config.silhouette_softness > 0.0:
            # Two-sided silhouette gradients (round 5): the realized scan
            # outcome's probability is p = We - M (We = winner opacity, 1
            # on miss/plane lanes; M = strongest rejected front blocker's
            # opacity, 0 if none).  Scaling ALL of this bounce's radiance
            # (miss shader included) and the carried throughput by the
            # detached ratio s = p / stop_grad(p) == 1 leaves every value
            # unchanged while its vjp contributes L * d log p — the exact
            # REINFORCE visibility gradient dw * (L_front - L_behind) in
            # expectation.  The round-4 one-sided blend measured AD/FD =
            # 0.49 on geometry leaves because it dropped the L_behind side.
            from .ops.intersect import silhouette_scale

            soft = config.silhouette_softness
            oc = wc3 - o
            tcw = jnp.sum(oc * d, -1)
            discw = wr * wr - (jnp.sum(oc * oc, -1) - tcw * tcw)
            xsw = jnp.clip(
                discw / (silhouette_scale(soft, wr) + 1e-12), -30.0, 30.0
            )
            from .ops.intersect import grad_capped_sqrt, validity_scale

            sphere_win = alive & hit.hit
            if pw_mask is not None:
                sphere_win = sphere_win & ~pw_mask
            we = jnp.where(sphere_win, 1.0 / (1.0 + jnp.exp(-xsw)), 1.0)
            # Winner validity probability (round 5): V = P(t_raw beats the
            # t_min coin) — the smoothed candidate gate (see
            # intersect_scene_soft).  Recomputed differentiably from the
            # winner attributes; the realized t used everywhere is the
            # CLAMPED max(t_raw, t_min).
            sqw = grad_capped_sqrt(
                jnp.maximum(discw, 1e-12), silhouette_scale(soft, wr)
            )
            tnw = tcw - sqw
            t_raw_w = jnp.where(tnw > config.t_min, tnw, tcw + sqw)
            v_w = jax.nn.sigmoid(jnp.clip(
                (t_raw_w - config.t_min) / (validity_scale(soft, wr) + 1e-12),
                -30.0, 30.0,
            ))
            ve = jnp.where(sphere_win, v_w, 1.0)
            bi = jnp.maximum(blk, 0)
            bc = scene.centers[bi]
            brr = scene.radii[bi]
            ocb = bc - o
            tcb = jnp.sum(ocb * d, -1)
            discb = brr * brr - (jnp.sum(ocb * ocb, -1) - tcb * tcb)
            xsb = jnp.clip(
                discb / (silhouette_scale(soft, brr) + 1e-12), -30.0, 30.0
            )
            # Blocker probabilities: recorded, live lane, and its would-be
            # (clamped) hit t strictly in front of the FINAL winner.  With
            # the validity coin the blocker may have failed EITHER coin;
            # the joint factor over the SHARED (u7, uv) pair is
            #   p = We Ve - min(We, Wb) min(Ve, Vb)
            # (P(winner passes both and blocker fails at least one)).
            sqb = jnp.sqrt(jnp.maximum(discb, 1e-12))
            tnb = tcb - sqb
            t_raw_b = jnp.where(tnb > config.t_min, tnb, tcb + sqb)
            t_b = jnp.maximum(t_raw_b, config.t_min)
            v_b = jax.nn.sigmoid(jnp.clip(
                (t_raw_b - config.t_min)
                / (validity_scale(soft, brr) + 1e-12),
                -30.0, 30.0,
            ))
            bvalid = (blk >= 0) & alive & (t_b < hit.t)
            wb = jnp.where(bvalid, 1.0 / (1.0 + jnp.exp(-xsb)), 0.0)
            vb = jnp.where(bvalid, v_b, 1.0)
            # The floor caps the REINFORCE weight |d p| / p on near-
            # impossible outcomes (variance control; grad is 0 below it).
            from .ops.intersect import SIL_P_FLOOR

            blk_term = jnp.where(
                bvalid, jnp.minimum(we, wb) * jnp.minimum(ve, vb), 0.0
            )
            if ph_t is not None:
                # Crossing factor (see the stochastic winner select above):
                # q = P(sphere wins) from the DIFFERENTIABLE t's — t_w via
                # the same value-exact capped sqrt as the bounce, t_p via
                # ray_plane_intersection (the plane offset's cotangent rides
                # it).  Saturates to exactly 1 outside the band (f32
                # sigmoid(+-30)); phantom-winner double-edges keep only the
                # crossing term (their We is handled on sphere-win lanes
                # only — documented single-competitor approximation).
                from .ops.intersect import crossing_scale

                t_w = jnp.maximum(t_raw_w, config.t_min)
                sigx = crossing_scale(soft, wr)
                # Single-slot semantics: where the plane stochastically beat
                # an IN-BAND accepted sphere, the crossing loser takes the
                # (single) blocker slot, dropping any front blocker.
                steal = (
                    pw_mask & cross_valid
                    & (jax.lax.stop_gradient(t_w - ph_t)
                       < 30.0 * jax.lax.stop_gradient(sigx))
                )
                blk_term = jnp.where(steal, 0.0, blk_term)
                qf = crossing_probability(ph_t, t_w, sigx, pw_mask)
                qf = jnp.where(cross_valid & alive, qf, 1.0)
            # Floor ONLY the acceptance probability (we - m): as a DIFFERENCE
            # of sigmoids its score dp/p is heavy-tailed (blocker ~ winner),
            # and the floor's one-sided clip there is a bounded bias.  The
            # crossing factor qf must stay OUTSIDE the floor: a logistic's
            # score is bounded (d log q = (1-q) darg, d log(1-q) = -q darg),
            # and flooring it breaks the A/B pair cancellation — the realized
            # -plane tail (1-q < floor) zeroes while the realized-sphere side
            # keeps +dq L_A, leaving a net wrong-signed bias measured at ~35%
            # of the crossing term.
            p_out = we * ve - blk_term
            den = jnp.maximum(p_out, SIL_P_FLOOR)
            if ph_t is not None:
                den = den * qf
            tp = tp * (den / jax.lax.stop_gradient(den))[:, None]

        # Miss shader: sky gradient, terminal (SingleThreadPathTracer.hpp:11-19).
        miss = alive & ~hit.hit
        rad = rad + tp * sky_color(d, scene.sky_lo, scene.sky_hi) * miss[:, None]
        live = alive & hit.hit
        surviving = live & scattered
        tp = jnp.where(surviving[:, None], tp * att, tp)
        o = jnp.where(live[:, None], hit.point, o)
        d = jnp.where(surviving[:, None], new_d, d)
        if config.rr_start_depth:
            # Russian roulette: unbiased early termination by throughput.
            q = jnp.clip(jnp.max(tp, axis=-1), 0.05, 1.0)
            kill = (b >= jnp.uint32(config.rr_start_depth)) & (unif[:, 6] >= q)
            surviving = surviving & ~kill
            boost = (b >= jnp.uint32(config.rr_start_depth)) & surviving
            tp = jnp.where(boost[:, None], tp / q[:, None], tp)
        # Previous-winner carry (validity coin's hard-gate target): the
        # sphere the chain just bounced off; -1 on plane/miss lanes.
        prev = widx if widx is not None else jnp.full_like(prev, -1)
        return (o, d, tp, rad, surviving, prev), None

    n = origins.shape[0]
    tp0, rad0, alive0, prev0 = _vary_like(
        (jnp.ones((n, 3), jnp.float32), jnp.zeros((n, 3), jnp.float32),
         jnp.ones((n,), bool), jnp.full((n,), -1, jnp.int32)),
        (origins, dirs, keys),
    )
    init = (origins, dirs, tp0, rad0, alive0, prev0)
    # The bounce materializes [rays, spheres] intersection intermediates,
    # so its backward rematerializes per bounce (jax.checkpoint) to stay
    # memory-feasible (SURVEY.md S7 hard part 4).
    (o, d, tp, rad, alive, _prev), _ = jax.lax.scan(
        jax.checkpoint(bounce), init, jnp.arange(config.max_depth, dtype=jnp.uint32)
    )
    # Rays still alive after the bounce budget return black (Shirley), like
    # the wavefront tracer's dropped 10th-pass rays (TaskBasedPathTracer.hpp:81).
    return rad


def render_pixels(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    key,
    pixel_ids,
    sample_ids,
):
    """Radiance for explicit (pixel, sample) pairs — the sharding-friendly
    core unit: any slice of the global (pixel, sample) grid renders
    identically regardless of which device computes it."""
    keys = ray_keys(key, pixel_ids, sample_ids)
    jit4 = camera_jitter(keys)
    origins, dirs = generate_rays(camera, config.width, config.height, pixel_ids, jit4)
    return trace_rays(origins, dirs, keys, scene, config)


def _render_block_pallas(
    scene, camera, config, key, pixel_ids, sample_offset, n_samples,
):
    """Forward-kernel radiance sum and per-pixel loop iterations (the
    kernel's work counter) for a pixel block (ops/pallas_forward)."""
    from .ops.pallas_forward import pack_params, pack_scene, render_block

    interpret = _kernel_interpret(config)
    table = pack_scene(scene)
    params = pack_params(scene, camera, config.width, config.height)
    kd = key if key.dtype == jnp.uint32 else jax.random.key_data(key)
    return render_block(
        pixel_ids, table, params, kd, sample_offset,
        n_samples=n_samples, max_depth=config.max_depth,
        width=config.width, height=config.height,
        t_min=config.t_min, t_max=config.t_max,
        rr_start_depth=config.rr_start_depth,
        use_plane=scene.plane is not None, interpret=interpret,
    )


def render_pixel_block(scene, camera, config, key, pixel_ids, sample_offset, n_samples):
    """Radiance sum over ``n_samples`` consecutive sample ids for an explicit
    block of pixels. Returns [len(pixel_ids), 3] radiance sum (not averaged).

    This is the unit each device computes under ``shard_map``: the reference's
    analog is one image tile rendered by one worker thread
    (include/Renderer.hpp:242-255) — but here *which* device renders a block
    cannot change the result, because all randomness is keyed by global
    (pixel, sample) ids.  On the jnp path samples are folded in
    ``spp_chunk``-sized scan steps to bound live memory.
    """
    if config.use_pallas:
        # The kernel loops over samples in-lane, so no chunking is needed.
        rad, _ = _render_block_pallas(
            scene, camera, config, key, pixel_ids, sample_offset, n_samples
        )
        return rad

    p = pixel_ids.shape[0]
    chunk = spp_chunk(config, p, n_samples)
    n_steps = n_samples // chunk

    def step(acc, i):
        off = sample_offset + i * chunk
        pids = jnp.tile(pixel_ids, (chunk,))
        sids = jnp.repeat(off + jnp.arange(chunk, dtype=jnp.int32), p)
        rad = render_pixels(scene, camera, config, key, pids, sids)
        return acc + jnp.sum(rad.reshape(chunk, p, 3), axis=0), None

    if n_steps > 1:
        # Rematerialize each chunk under autodiff: otherwise the scan saves
        # every chunk's residuals and chunking would bound nothing.
        # Forward-only jit is unaffected.
        step = jax.checkpoint(step)

    acc0 = _vary_like(jnp.zeros((p, 3), jnp.float32), (pixel_ids, sample_offset, key))
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(n_steps))
    return acc


def render_sample_batch(scene, camera, config, key, sample_offset, n_samples):
    """Sum of radiance over ``n_samples`` consecutive sample ids for every
    pixel. Returns [P, 3] radiance sum (not yet averaged).

    Delegates to render_pixel_block over the full pixel range, so the jnp
    path's spp chunking bounds live (and, under autodiff, rematerialized
    residual) memory here too.
    """
    pixel_ids = jnp.arange(config.num_pixels, dtype=jnp.int32)
    return render_pixel_block(
        scene, camera, config, key, pixel_ids, sample_offset, n_samples
    )


def init_state(config: RenderConfig, key) -> RenderState:
    return RenderState(
        accum=jnp.zeros((config.height, config.width, 3), jnp.float32),
        sample_count=jnp.zeros((), jnp.int32),
        next_key=key,
    )


@functools.partial(jax.jit, static_argnames=("config", "n_samples"))
def accumulate(
    state: RenderState, scene: Scene, camera: Camera, config: RenderConfig, n_samples: int
) -> RenderState:
    """Progressive accumulation: fold ``n_samples`` more spp into the state.

    Deterministic resume: sample ids continue from ``state.sample_count``, so
    stop/checkpoint/restart yields the bit-identical image as an
    uninterrupted run (the reference loses everything on a crash —
    SURVEY.md S5 checkpoint row).
    """
    chunk = config.spp_chunk or n_samples
    chunk = min(chunk, n_samples)
    if n_samples % chunk:
        # Same largest-divisor fallback as spp_chunk: spp_chunk is an upper
        # bound, not a contract (e.g. the CLI's auto-picked live preview
        # chunk need not be a multiple of it).
        chunk = next(c for c in range(chunk, 0, -1) if n_samples % c == 0)
    n_steps = n_samples // chunk

    def step(accum, i):
        off = state.sample_count + i * chunk
        batch = render_sample_batch(scene, camera, config, state.next_key, off, chunk)
        return accum + batch.reshape(config.height, config.width, 3), None

    accum, _ = jax.lax.scan(step, state.accum, jnp.arange(n_steps))
    return RenderState(
        accum=accum,
        sample_count=state.sample_count + n_samples,
        next_key=state.next_key,
    )


def render(scene: Scene, camera: Camera, config: RenderConfig, key) -> jax.Array:
    """One-shot render: [H, W, 3] gamma-corrected float image in [0, 1]."""
    state = init_state(config, key)
    state = accumulate(state, scene, camera, config, config.spp)
    return state.image(config.gamma)
