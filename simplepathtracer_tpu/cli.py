"""Command-line entry point.

Reference counterpart: ``main() -> TracePaths()`` (Main.cpp:3-6) with all
configuration as compile-time constants (include/Globals.hpp) and a GLFW
window as the only progress display.  Here: argparse over named presets
(presets.py), progressive rendering with periodic snapshots (the live-
preview analog, SURVEY.md S5), resume from snapshot, and structured
throughput metrics.

Usage:
    python -m simplepathtracer_tpu.cli render --preset cover -o cover.png
    python -m simplepathtracer_tpu.cli render --preset simple --spp 64 \\
        --snapshot-every 16 --snapshot out.npz --preview preview.png
    python -m simplepathtracer_tpu.cli render --resume out.npz -o done.png
    python -m simplepathtracer_tpu.cli invert --steps 60 -o recovered.png
    python -m simplepathtracer_tpu.cli info
"""

from __future__ import annotations

import argparse
import sys

import jax
import numpy as np

from . import checkpoint, io, metrics
from .presets import PRESETS
from .render import accumulate, init_state
from .types import RenderConfig


def _apply_overrides(config: RenderConfig, args) -> RenderConfig:
    kw = {}
    for field in ("width", "height", "spp", "max_depth", "spp_chunk"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    if getattr(args, "no_pallas", False):
        kw["use_pallas"] = False
    return config.replace(**kw) if kw else config


def cmd_render(args) -> int:
    meter = metrics.Meter(enabled=not args.quiet)
    key = jax.random.PRNGKey(args.seed)

    if args.resume:
        state, scene, config, camera = checkpoint.load(args.resume)
        config = _apply_overrides(config, args)
        if camera is None:  # v1 snapshot without a camera: fall back to preset
            camera = PRESETS[args.preset].camera_fn()
        done = int(state.sample_count)
        meter.emit({"phase": "resume", "from": args.resume, "samples_done": done})
    else:
        preset = PRESETS[args.preset]
        scene, camera, config = preset.build(jax.random.PRNGKey(args.scene_seed))
        config = _apply_overrides(config, args)
        state = init_state(config, key)
        done = 0

    server = None
    if getattr(args, "http_preview", None) is not None:
        from .preview import PreviewServer

        server = PreviewServer(port=args.http_preview)
        meter.emit({"phase": "preview", "url": f"http://localhost:{server.port}/"})

    total = config.spp
    chunk = args.snapshot_every or (total - done)
    if server is not None and not args.snapshot_every:
        # A live preview needs intermediate frames: without --snapshot-every
        # the render would run as one chunk and the first (and only) frame
        # would be pushed after it finished.  ~20 progressive updates.
        chunk = max(1, total // 20)
    with metrics.profiler_trace(args.trace):
        while done < total:
            n = min(chunk, total - done)
            with meter.phase(
                "render", paths=config.num_pixels * n, bounces=config.max_depth
            ):
                state = accumulate(state, scene, camera, config, n)
                state.accum.block_until_ready()
            done += n
            if args.snapshot:
                checkpoint.save(args.snapshot, state, scene, config, camera)
                meter.emit({"phase": "snapshot", "path": args.snapshot, "spp": done})
            if args.preview or server is not None:
                img = np.asarray(state.image(config.gamma))
                if args.preview:
                    io.save_image(args.preview, img)
                if server is not None:
                    server.update(img, status=f"{done}/{total} spp")

    out = args.output or io.default_filename(config)
    io.save_image(out, np.asarray(state.image(config.gamma)))
    meter.emit({"phase": "done", "output": out, "spp": done})
    return 0


def _invert_preset(args) -> int:
    """Preset-scale inverse rendering: perturb a preset scene's materials,
    recover them against a rendered target, ship a before|target|after
    artifact.  Gradients take the jnp bounce (grad_safe_config); the
    target and artifact renders use the preset's forward kernel where it
    can run."""
    import jax.numpy as jnp

    from . import inverse
    from .render import grad_safe_config, kernel_available

    meter = metrics.Meter(enabled=not args.quiet)
    preset = PRESETS[args.preset]
    truth, camera, config = preset.build(jax.random.PRNGKey(args.scene_seed))
    config = _apply_overrides(config, args)
    if args.spp is None and jax.default_backend() == "cpu":
        # CPU runs clamp the preset spp for runtime sanity; on the GPU the
        # fit runs the preset's actual spp.
        config = config.replace(spp=min(config.spp, 32))
    if config.rr_start_depth == 0:
        # Russian roulette defaults ON for fits: unbiased, gradients are
        # tested under it, and it shortens the mean path.
        config = config.replace(rr_start_depth=2)
    key = jax.random.PRNGKey(args.seed)
    rcfg = (
        config if config.use_pallas and kernel_available(config)
        else grad_safe_config(config)
    )

    target = inverse.render_linear(truth, camera, rcfg, jax.random.fold_in(key, 999))
    import numpy as np_

    # Perturb every non-ground albedo (the ground = the largest |radius|)
    # AND the positions of the K most prominent spheres (projected size =
    # |r| / distance) — BASELINE config 4 is "recover sphere
    # positions/albedos from target image via pixel-loss gradients".
    radii_n = np_.asarray(truth.radii)
    ground = int(np_.argmax(np_.abs(radii_n)))
    centers_n = np_.asarray(truth.centers)
    cam_o = np_.asarray(camera.origin)
    prominence = np_.abs(radii_n) / np_.linalg.norm(centers_n - cam_o, axis=1)
    prominence[ground] = 0.0
    # Geometry fit on Lambertian spheres only: metal/glass positions are
    # recoverable too, but hollow-glass SHELL PAIRS must move together and
    # pairing them here would complicate a demo whose point is config 4.
    prominence[np_.asarray(truth.material) != 0] = 0.0
    # Fit only PRIMARY-VISIBLE spheres: one exact visibility probe
    # (camera rays -> intersect_scene winner ids).  Everything else —
    # behind the camera, outside the frustum, or occluded — gets a
    # pixel-loss gradient that is pure Monte-Carlo noise, which Adam's
    # RMS normalization turns into an O(lr * steps) random walk
    # (inverse.fit docstring); ~half the cover scene's 484 spheres sit
    # behind its 20-degree camera alone.
    from .camera import generate_rays
    from .ops.intersect import intersect_scene

    # Quarter-resolution probe: intersect_scene materializes [rays,
    # spheres] intermediates (full-res would be ~5 GB x several at cover
    # scale), and spheres smaller than ~4 px are exactly the
    # noise-dominated ones the mask should exclude anyway.
    pw, ph = max(config.width // 4, 1), max(config.height // 4, 1)
    pix = jnp.arange(pw * ph, dtype=jnp.int32)
    o_p, d_p = generate_rays(
        camera, pw, ph, pix, jnp.full((pw * ph, 4), 0.5, jnp.float32),
    )
    prim = intersect_scene(o_p, d_p, truth, config.t_min, config.t_max)
    vis_idx = np_.unique(
        np_.asarray(prim.index)[np_.asarray(prim.hit)]
    )
    visible = np_.zeros(len(radii_n), bool)
    visible[vis_idx] = True
    visible[ground] = False
    prominence[~visible] = 0.0
    to_c = centers_n - cam_o
    k_geo = min(6, int((prominence > 0).sum()))
    geo_idx = np_.argsort(-prominence)[:k_geo]
    # Deterministic sub-radius offsets, projected TANGENTIAL to each
    # sphere's view ray: soft silhouettes need the perturbed and true
    # silhouettes to overlap, and a single-view Lambertian fit cannot
    # observe depth shifts anyway (scale-distance ambiguity — a
    # photogrammetry fact, not a solver property), so the demo perturbs
    # the observable subspace it claims to recover.
    dirs = np_.asarray(
        [[1, 0, 0.5], [-1, 0.3, 0], [0.4, 0, -1], [-0.5, 0.2, 0.8],
         [0.9, 0, -0.3], [-0.2, 0.4, 1]], np_.float32)[:k_geo]
    view = to_c[geo_idx] / np_.linalg.norm(
        to_c[geo_idx], axis=1, keepdims=True)
    dirs = dirs - np_.sum(dirs * view, axis=1, keepdims=True) * view
    dirs /= np_.linalg.norm(dirs, axis=1, keepdims=True)
    c_delta = np_.zeros_like(centers_n)
    c_delta[geo_idx] = dirs * (0.35 * np_.abs(radii_n[geo_idx]))[:, None]
    delta = jnp.asarray(visible.astype(np_.float32))[:, None] * 0.18
    perturbed = truth.replace(
        albedo=jnp.clip(truth.albedo + delta, 0.03, 0.97),
        centers=truth.centers + jnp.asarray(c_delta),
    )
    mask_a = {"albedo": jnp.asarray(
        visible.astype(np_.float32)[:, None] * np_.ones((1, 3), np_.float32)
    )}
    mask_c = {"centers": jnp.asarray(
        (c_delta != 0).any(axis=1, keepdims=True)
        * np_.ones((1, 3), np_.float32))}
    n_fit = float(mask_a["albedo"][:, :1].sum()) * 3.0

    def albedo_err(scene):
        d = jnp.abs(scene.albedo - truth.albedo) * mask_a["albedo"]
        # mean = the recovery metric (visible spheres dominate the image
        # loss and converge); max = the Adam random-walk bound on
        # occluded/sub-pixel spheres whose gradients are pure MC noise
        # (see inverse.fit docstring) — it GROWS with lr * steps.
        return float(d.sum() / n_fit), float(d.max())

    def center_err(scene):
        if k_geo == 0:  # tiny probes can leave no geometry candidates
            return 0.0, 0.0
        d = np_.linalg.norm(
            np_.asarray(scene.centers - truth.centers)[geo_idx], axis=1
        )
        return float(d.mean()), float(d.max())

    err0_mean, err0_max = albedo_err(perturbed)
    cerr0_mean, cerr0 = center_err(perturbed)
    before = inverse.render_linear(perturbed, camera, rcfg, key)

    def cb(phase):
        def inner(i, loss, params):
            if i % 5 == 0:
                meter.emit({"phase": phase, "step": i, "loss": loss})
        return inner

    snap_kw = lambda ph: (  # noqa: E731
        dict(snapshot_path=f"{args.snapshot}.{ph}.npz",
             snapshot_every=args.snapshot_every) if args.snapshot else {}
    )
    # Optimizer-level gradient accumulation (independent-pair estimator,
    # inverse.make_accum_grad_step) splits each step's spp into groups.
    grad_accum = getattr(args, "grad_accum", 0) or 0
    if grad_accum:
        meter.emit({"phase": "grad_accum", "groups": grad_accum,
                    "spp_per_group": config.spp // grad_accum})
    # Two-phase coordinate descent (same shape as the small demo): albedo
    # against the hard target, then geometry with soft silhouettes against
    # a soft target (soft-to-soft objective, inverse.fit docstring).
    softness = 0.02
    # Albedo converges in <40 steps; geometry needs the rest (its Adam
    # steps are capped at ~lr per step), and EXTRA albedo-only steps are
    # actively harmful — converged-but-noisy leaves random-walk (the
    # 240-step run walked a semi-visible sphere's albedo to 0.39 before
    # this cap; the joint phase then spends its budget recovering).
    s1 = max(min(args.steps // 3, 40), 1)
    stage1, losses1 = inverse.fit(
        perturbed, target, camera, config, key, steps=s1, lr=args.lr,
        leaves=("albedo",), param_mask=mask_a, callback=cb("invert_albedo"),
        grad_accum=grad_accum, **snap_kw("albedo"),
    )
    target_soft = inverse.render_linear(
        truth, camera, grad_safe_config(config).replace(
            silhouette_softness=softness),
        jax.random.fold_in(key, 999),
    )
    # Phase 2 fits albedo AND centers jointly: with albedo frozen at its
    # phase-1 residual, the center gradients partially chase shading error
    # instead of geometry (measured drift at cover scale).
    phase2_leaves = ("albedo", "centers") if k_geo else ("albedo",)
    phase2_mask = {**mask_a, **mask_c} if k_geo else mask_a
    recovered, losses2 = inverse.fit(
        stage1, target_soft, camera, config, jax.random.fold_in(key, 1),
        steps=args.steps - s1, lr=min(args.lr, 1e-2),
        leaves=phase2_leaves, softness=softness, param_mask=phase2_mask,
        callback=cb("invert_centers"), grad_accum=grad_accum,
        **snap_kw("centers"),
    )
    losses = losses1 + losses2
    err1_mean, err1_max = albedo_err(recovered)
    cerr1_mean, cerr1 = center_err(recovered)
    after = inverse.render_linear(recovered, camera, rcfg, key)
    meter.emit({
        "phase": "invert_done", "preset": args.preset,
        "spp": config.spp, "size": f"{config.width}x{config.height}",
        "loss_first": losses[0], "loss_last": losses[-1],
        "albedo_err_before": err0_mean, "albedo_err_after": err1_mean,
        "albedo_maxerr_before": err0_max, "albedo_maxerr_after": err1_max,
        "center_spheres": [int(i) for i in geo_idx],
        "center_err_before": cerr0, "center_err_after": cerr1,
        "center_err_mean_before": cerr0_mean,
        "center_err_mean_after": cerr1_mean,
    })
    if args.output:
        trip = np.concatenate(
            [np.asarray(x) for x in (before, target, after)], axis=0
        )
        io.save_image(args.output, np.clip(trip, 0, 1) ** 0.5)
        meter.emit({"phase": "artifact", "output": args.output,
                    "layout": "rows: before | target | after"})
    return 0


def cmd_invert(args) -> int:
    import jax.numpy as jnp

    from . import inverse
    from .scenes import three_sphere_scene
    from .types import make_camera

    if getattr(args, "preset", None):
        return _invert_preset(args)

    meter = metrics.Meter(enabled=not args.quiet)
    camera = make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    config = RenderConfig(width=args.width or 96, height=args.height or 48,
                          spp=args.spp or 16, max_depth=args.max_depth or 6)
    key = jax.random.PRNGKey(args.seed)

    # Ground truth scene -> target image; perturbed scene -> recover.
    # Soft-to-soft objective for geometry; ground sphere frozen (see
    # inverse.fit docstring for why both matter).
    softness = 0.05
    truth = three_sphere_scene(hollow_glass=False)
    # Hard-edge target for the albedo phase; soft-edge target for the
    # geometry phase (soft-to-soft objective, see inverse.fit docstring).
    target_hard = inverse.render_linear(
        truth, camera, config, jax.random.fold_in(key, 999)
    )
    target_soft = inverse.render_linear(
        truth, camera, config.replace(silhouette_softness=softness),
        jax.random.fold_in(key, 999),
    )
    perturbed = truth.replace(
        centers=truth.centers + jnp.asarray(
            [[0.0, 0, 0], [0.1, 0.08, 0], [-0.08, 0.08, 0], [0.08, -0.04, 0]]
        ),
        albedo=jnp.clip(truth.albedo + 0.2, 0.05, 0.95),
    )
    mask = {"centers": jnp.zeros_like(truth.centers).at[1:].set(1.0)}

    def cb(phase):
        def inner(i, loss, params):
            if i % 10 == 0:
                meter.emit({"phase": phase, "step": i, "loss": loss})
        return inner

    # Two-phase coordinate descent: materials first, then geometry with
    # soft silhouettes — jointly fitting both lets Monte-Carlo gradient
    # noise walk the geometry while the albedo error dominates the loss.
    snap = getattr(args, "snapshot", None)
    snap_kw = lambda phase: (  # noqa: E731
        dict(snapshot_path=f"{snap}.{phase}.npz",
             snapshot_every=args.snapshot_every) if snap else {}
    )
    s1 = max(args.steps // 2, 1)
    stage1, losses1 = inverse.fit(
        perturbed, target_hard, camera, config, key, steps=s1, lr=args.lr,
        leaves=("albedo",), callback=cb("invert_albedo"), **snap_kw("albedo"),
    )
    recovered, losses2 = inverse.fit(
        stage1, target_soft, camera, config, jax.random.fold_in(key, 1),
        steps=args.steps - s1, lr=min(args.lr, 1e-2),
        leaves=("centers",), softness=softness, param_mask=mask,
        callback=cb("invert_centers"), **snap_kw("centers"),
    )
    losses = losses1 + losses2
    meter.emit({
        "phase": "invert_done",
        "loss_first": losses[0], "loss_last": losses[-1],
        "center_err_before": float(jnp.abs(perturbed.centers - truth.centers).max()),
        "center_err_after": float(jnp.abs(recovered.centers - truth.centers).max()),
    })
    if args.output:
        img = inverse.render_linear(recovered, camera, config, key)
        io.save_image(args.output, np.asarray(jnp.clip(img, 0, 1) ** 0.5))
    return 0


def cmd_info(args) -> int:
    print(f"devices: {jax.devices()}")
    print("presets:")
    for p in PRESETS.values():
        c = p.config
        print(f"  {p.name:16s} {c.width}x{c.height} @{c.spp}spp depth={c.max_depth}  - {p.description}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="simplepathtracer_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a preset scene")
    r.add_argument("--preset", choices=sorted(PRESETS), default="cover")
    r.add_argument("-o", "--output", default=None, help="output image (.png/.bmp)")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--spp", type=int)
    r.add_argument("--max-depth", dest="max_depth", type=int)
    r.add_argument("--spp-chunk", dest="spp_chunk", type=int)
    r.add_argument("--no-pallas", action="store_true", help="use the jnp reference path")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--scene-seed", type=int, default=0)
    r.add_argument("--snapshot", default=None, help="snapshot file (.npz)")
    r.add_argument("--snapshot-every", type=int, default=None, metavar="SPP")
    r.add_argument("--preview", default=None, help="write partial image each chunk")
    r.add_argument(
        "--http-preview", dest="http_preview", type=int, default=None,
        metavar="PORT", nargs="?", const=0,
        help="serve a live progressive preview over HTTP (0 = random port)",
    )
    r.add_argument("--resume", default=None, help="resume from snapshot")
    r.add_argument("--trace", default=None, help="jax.profiler trace dir")
    r.add_argument("-q", "--quiet", action="store_true")
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("invert", help="inverse-rendering demo (BASELINE config 4)")
    i.add_argument(
        "--preset", choices=sorted(PRESETS), default=None,
        help="preset-scale fit: perturb this preset scene's albedos and "
             "recover them (default: the small three-sphere two-phase demo)",
    )
    i.add_argument(
        "--grad-accum", dest="grad_accum", type=int, default=0, metavar="K",
        help="split each step's spp into K independent-pair gradient "
             "groups (see inverse.make_accum_grad_step)",
    )
    i.add_argument("--steps", type=int, default=60)
    i.add_argument("--lr", type=float, default=2e-2)
    i.add_argument("--width", type=int)
    i.add_argument("--height", type=int)
    i.add_argument("--spp", type=int)
    i.add_argument("--max-depth", dest="max_depth", type=int)
    i.add_argument("--scene-seed", type=int, default=0)
    i.add_argument("--seed", type=int, default=0)
    i.add_argument(
        "--snapshot", default=None, metavar="PATH",
        help="fit-state snapshot prefix (writes PATH.albedo.npz / "
             "PATH.centers.npz; resumes from them if present)",
    )
    i.add_argument("--snapshot-every", dest="snapshot_every", type=int, default=10)
    i.add_argument("-o", "--output", default=None)
    i.add_argument("-q", "--quiet", action="store_true")
    i.set_defaults(fn=cmd_invert)

    n = sub.add_parser("info", help="list devices and presets")
    n.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    if argv is None:
        # A command-line run keeps the persistent compile cache; in-process
        # callers (tests) keep their own JAX configuration.
        from ._cache import enable_compilation_cache

        enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
