"""Smoke run of the renderer on one GPU: the quickest proof the system works.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --multi-gpu  # only the sharded phase, on 4 cards

Phases (one card):
  1. the device is a GPU, and only one;
  2. the forward kernel, compiled, against the jnp reference: the cover
     scene at 1200x800, 4 spp, depth 10, and a ground-plane scene;
  3. the render entry points at full preset shape: ``accumulate`` on the
     cover preset at 100 spp, and ``cli render`` of the cover and
     reference presets;
  4. the fit entry points: ``cli invert --preset three_sphere --steps 15``
     must beat its perturbed start, and one ``inverse.fit`` step on the
     cover preset at 1200x800 must stay finite;
  5. the tests marked ``gpu`` (tests/test_gpu_smoke.py), in this process.

``--multi-gpu`` runs ``render_sharded`` of the cover scene on a 2x2 and a
4x1 ('tiles', 'samples') mesh and ``train_step_sharded``, each against the
one-card result.

Everything runs in this one process, so one JAX client holds the card.
Any failed phase exits nonzero before the last line.  The last line is one
JSON object with the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def check_devices(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"JAX found no GPU: first device is {devs[0].platform!r}")
    if len(devs) != count:
        raise RuntimeError(f"expected {count} GPU(s), JAX sees {len(devs)}")
    return devs


def compare_images(a, b, spp, what):
    """Kernel vs jnp radiance sums over ``spp`` samples.

    Both sides draw the same counter-based random numbers, so a pixel
    differs only where a floating-point difference flips a grazing hit or
    a near tie between two spheres (the jnp scan forms the discriminant
    from matmuls, the kernel per sphere).  A flip changes that sample's
    whole path, moving the pixel's mean by up to 1/spp of its radiance.
    Such pixels sit on silhouettes: the bound is 2% of pixels off by more
    than 1e-2 and a mean difference below 1e-3.  A real kernel fault
    moves most pixels.
    """
    import numpy as np

    d = np.abs(np.asarray(a) - np.asarray(b)) / spp
    mean, share = float(d.mean()), float((d.max(axis=-1) > 1e-2).mean())
    log(f"  {what}: mean |diff| {mean:.3e}, share of pixels > 1e-2 "
        f"{share:.4f}, max {float(d.max()):.3e}")
    if not np.isfinite(np.asarray(a)).all():
        raise AssertionError(f"{what}: kernel output not finite")
    if mean >= 1e-3 or share >= 0.02:
        raise AssertionError(f"{what}: kernel and jnp path disagree")


def phase_kernel():
    import jax

    from simplepathtracer_tpu.presets import PRESETS
    from simplepathtracer_tpu.render import render_sample_batch

    key = jax.random.PRNGKey(1)
    for name in ("cover", "three_sphere_plane"):
        scene, cam, cfg = PRESETS[name].build()
        cfg = cfg.replace(spp=4, max_depth=10)
        what = f"{name} {cfg.width}x{cfg.height} @4spp"
        t0 = time.perf_counter()
        a = render_sample_batch(scene, cam, cfg, key, 0, 4)
        a.block_until_ready()
        t_k = time.perf_counter() - t0
        b = render_sample_batch(scene, cam, cfg.replace(use_pallas=False),
                                key, 0, 4)
        log(f"  {what}: kernel compile+run {t_k:.2f} s, "
            f"{scene.num_spheres} spheres")
        compare_images(a, b, 4, what)


def phase_render():
    import jax
    import numpy as np

    from simplepathtracer_tpu import cli
    from simplepathtracer_tpu.presets import PRESETS
    from simplepathtracer_tpu.render import accumulate, init_state

    scene, cam, cfg = PRESETS["cover"].build()
    state = init_state(cfg, jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    accumulate(state, scene, cam, cfg, cfg.spp).accum.block_until_ready()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = accumulate(state, scene, cam, cfg, cfg.spp)
        out.accum.block_until_ready()
        times.append(time.perf_counter() - t0)
    img = np.asarray(out.image(cfg.gamma))
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"cover render: bad image {img.shape}")
    dt = float(np.median(times))
    log(f"  accumulate cover {cfg.width}x{cfg.height} @{cfg.spp}spp: "
        f"compile+first {compile_s:.2f} s, median {dt:.4f} s, "
        f"{cfg.num_pixels * cfg.spp / dt / 1e6:.1f} M paths/s, "
        f"mean pixel {img.mean():.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        for preset in ("cover", "reference"):
            out_path = os.path.join(tmp, f"{preset}.png")
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["render", "--preset", preset, "-o", out_path])
            records = [json.loads(x) for x in err.getvalue().splitlines()
                       if x.startswith("{")]
            rend = [r for r in records if r.get("phase") == "render"]
            if rc != 0 or not os.path.exists(out_path) or not rend:
                raise AssertionError(f"cli render --preset {preset} failed")
            log(f"  cli render --preset {preset}: "
                f"{rend[-1]['paths_per_sec'] / 1e6:.1f} M paths/s "
                f"(first call, compile included), "
                f"{time.perf_counter() - t0:.1f} s total")


def phase_fit():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from simplepathtracer_tpu import cli, inverse
    from simplepathtracer_tpu.presets import PRESETS

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["invert", "--preset", "three_sphere", "--steps", "15"])
    done = [json.loads(x) for x in err.getvalue().splitlines()
            if x.startswith("{") and '"invert_done"' in x]
    if rc != 0 or not done:
        raise AssertionError("cli invert --preset three_sphere failed")
    d = done[-1]
    log(f"  cli invert three_sphere {d['size']} @{d['spp']}spp, 15 steps in "
        f"{time.perf_counter() - t0:.1f} s: loss {d['loss_first']:.5f} -> "
        f"{d['loss_last']:.5f}, albedo err {d['albedo_err_before']:.4f} -> "
        f"{d['albedo_err_after']:.4f}, center err "
        f"{d['center_err_before']:.4f} -> {d['center_err_after']:.4f}")
    # The fit moves the visible spheres' albedos and, where it perturbed
    # any, the centers of the Lambertian ones (center_err_before > 0).
    if not (d["albedo_err_after"] < d["albedo_err_before"]
            and (d["center_err_before"] == 0.0
                 or d["center_err_after"] < d["center_err_before"])):
        raise AssertionError("invert did not beat its perturbed start")

    scene, cam, cfg = PRESETS["cover"].build()
    key = jax.random.PRNGKey(0)
    target = inverse.render_linear(scene, cam, cfg, jax.random.fold_in(key, 9))
    start = scene.replace(albedo=jnp.clip(scene.albedo + 0.1, 0.0, 1.0))
    t0 = time.perf_counter()
    fitted, losses = inverse.fit(start, target, cam, cfg, key, steps=1,
                                 leaves=("albedo", "centers"))
    jax.block_until_ready(fitted.albedo)
    dt = time.perf_counter() - t0
    finite = bool(np.isfinite(np.asarray(fitted.albedo)).all()
                  and np.isfinite(np.asarray(fitted.centers)).all())
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"  inverse.fit cover {cfg.width}x{cfg.height} @{cfg.spp}spp, 1 step "
        f"(compile included) {dt:.1f} s: loss {losses[0]:.6f}, gradients "
        f"finite {finite} (Adam turns any non-finite gradient into a "
        f"non-finite parameter), peak_bytes_in_use {peak}")
    if not (np.isfinite(losses[0]) and finite):
        raise AssertionError("cover fit step is not finite")


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu_smoke.py")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit code {rc})")


def phase_multi_gpu():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from simplepathtracer_tpu.parallel import (
        loss_and_grad_sharded, make_mesh, render_accum_sharded,
        render_sharded, train_step_sharded,
    )
    from simplepathtracer_tpu.presets import PRESETS
    from simplepathtracer_tpu.render import render_sample_batch

    devs = jax.devices()
    scene, cam, cfg = PRESETS["cover"].build()
    key = jax.random.PRNGKey(4)
    one = make_mesh(tiles=1, samples=1, devices=devs[:1])
    with jax.default_device(devs[0]):
        ref = np.asarray(render_sample_batch(scene, cam, cfg, key, 0, cfg.spp))
    # Each shard runs the same per-lane code as one card, and the samples
    # axis adds its partial sums with a psum, so sums agree to f32
    # reassociation.  Where a different compilation of the shard changes a
    # last bit, a grazing hit can flip and move a pixel by up to 1/spp of
    # its radiance: the bound is under 2% of pixels off by more than 1e-4.
    for tiles, samples in ((2, 2), (4, 1)):
        mesh = make_mesh(tiles=tiles, samples=samples, devices=devs)
        acc = jax.jit(
            lambda s, c, k: render_accum_sharded(s, c, cfg, k, mesh)
        )(scene, cam, key)
        acc = np.asarray(acc)
        px = (np.abs(acc - ref) / cfg.spp).max(axis=-1)
        share = float((px > 1e-4).mean())
        t0 = time.perf_counter()
        img = render_sharded(scene, cam, cfg, key, mesh)
        img.block_until_ready()
        dt = time.perf_counter() - t0
        log(f"  render_sharded cover {cfg.width}x{cfg.height} @{cfg.spp}spp "
            f"on {tiles}x{samples}: bit-identical {bool((acc == ref).all())}, "
            f"max |diff| {float(px.max()):.2e}, share of pixels > 1e-4 "
            f"{share:.4f}, first call {dt:.2f} s")
        if share >= 0.02 or not np.isfinite(np.asarray(img)).all():
            raise AssertionError(f"sharded render {tiles}x{samples} disagrees")

    gcfg = cfg.replace(spp=4)
    target = jnp.zeros((gcfg.height, gcfg.width, 3), jnp.float32)
    lg = jax.jit(loss_and_grad_sharded, static_argnames=("config", "mesh"))
    l1, g1 = lg(scene, target, cam, gcfg, key, one)
    mesh = make_mesh(tiles=2, samples=2, devices=devs)
    l4, g4 = lg(scene, target, cam, gcfg, key, mesh)
    g1 = {k: np.asarray(v) for k, v in g1.items()}
    g4 = {k: np.asarray(v) for k, v in g4.items()}
    rel = {
        k: float(np.linalg.norm(g4[k] - g1[k]) / (np.linalg.norm(g1[k]) + 1e-12))
        for k in g1
    }
    log(f"  loss_and_grad_sharded cover @4spp 2x2 vs one card: loss "
        f"{float(l4):.6f} vs {float(l1):.6f}, relative L2 grad diff per leaf "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    # Each shard's jnp program has other shapes than one card's (P/4
    # pixels, half the samples), so XLA's code and the psum order differ
    # in the last bits.  Where that flips a grazing hit, the sample's
    # whole gradient contribution moves: the bound is 1% relative L2 per
    # leaf, and the loss to 1e-5 relative.
    if abs(float(l4) - float(l1)) > 1e-5 * abs(float(l1)) or max(rel.values()) > 1e-2:
        raise AssertionError("sharded gradients disagree with one card")
    new4, loss4 = train_step_sharded(scene, target, cam, gcfg, key, mesh)
    new1, _ = train_step_sharded(scene, target, cam, gcfg, key, one)
    pdiff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(new4), jax.tree.leaves(new1)))
    log(f"  train_step_sharded 2x2: loss {float(loss4):.6f}, max param "
        f"diff vs one card {pdiff:.2e}")
    # The SGD step moves parameters by lr (1e-2) times the gradient.
    if not np.isfinite(float(loss4)) or pdiff > 1e-4:
        raise AssertionError("sharded train step disagrees with one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the sharded phase, on 4 cards")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    try:
        import simplepathtracer_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    import jax

    from simplepathtracer_tpu._cache import enable_compilation_cache

    count = 4 if args.multi_gpu else 1
    try:
        devs = check_devices(count)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    log(f"cache: {enable_compilation_cache()}")
    phases = (
        [("multi-gpu", phase_multi_gpu)] if args.multi_gpu else [
            ("kernel vs jnp", phase_kernel),
            ("render entry points", phase_render),
            ("fit entry points", phase_fit),
            ("gpu tests", phase_gpu_tests),
        ]
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}:")
        fn()
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    for line in card_lines():
        log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
