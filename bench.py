"""Benchmark harness: prints one JSON line of throughput rows for one GPU.

Rows (cover scene, 1200x800, depth 10):
  * fwd                  — forward kernel at 100 spp, no Russian roulette
  * fwd_rr               — forward kernel with rr_start_depth=2
  * fwd_bwd_sustained_100spp — value_and_grad of the pixel MSE at the
                           100-spp preset on the jnp bounce (spp-chunked
                           with rematerialization: what `invert` sustains)
  * fwd_bwd_sustained_rr — ditto with Russian roulette (the invert default)
  * fwd_bwd_sustained_soft — ditto with soft silhouettes (geometry fits)
  * fwd_bwd_sustained_500spp(_rr) — BASELINE.json's 500-spp gradient step
  * fwd_reference_scene  — forward kernel on the reference's 10-sphere
                           scene at the same image size

Every row is the median of three post-compile calls that end in
``block_until_ready``, with the compile-plus-first-call time beside it.
The run fails, and prints an "error" field, when JAX finds no GPU.
``vs_baseline`` compares against the reference-semantics C++ CPU tracer
(native/cpu_baseline — a clean-room reimplementation of
ilia-glushchenko/SimplePathTracer's recursive tracer + <=4-thread tile
pool, measured on this host), since the reference publishes no numbers
(SURVEY.md S6).

Run: python bench.py
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

WIDTH, HEIGHT, DEPTH = 1200, 800, 10
BENCH_SPP = 100
NORTH_STAR_SPP = 500


def _timed_reps(run, reps=3):
    """Median of ``reps`` calls of ``run``: returns (median_s, [rep times])."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), [round(t, 4) for t in times]


def card_info():
    """(name, power limit) of the card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    name, _, limit = out.partition(",")
    return name.strip(), limit.strip()


def cpu_baseline_paths_per_sec():
    """Measure the C++ reference-semantics tracer (best of two runs)."""
    exe = os.path.join(REPO, "native", "cpu_baseline")
    if not os.path.exists(exe):
        subprocess.run(
            ["make", "-C", os.path.join(REPO, "native"), "cpu_baseline"],
            check=True, capture_output=True,
        )
    best = None
    for _ in range(2):
        out = subprocess.run(
            [exe, "300", "200", "16", str(DEPTH)],
            check=True, capture_output=True, text=True,
        ).stdout
        r = json.loads(out.strip().splitlines()[-1])
        if best is None or r["paths_per_sec"] > best["paths_per_sec"]:
            best = r
    return best


def _bench_forward(scene, camera, config, key, spp):
    """(median seconds, compile+first seconds, rep times) of one accumulate."""
    from simplepathtracer_tpu.render import accumulate, init_state

    state = init_state(config, key)

    def run():
        accumulate(state, scene, camera, config, spp).accum.block_until_ready()

    t0 = time.perf_counter()
    run()
    compile_s = time.perf_counter() - t0
    dt, reps = _timed_reps(run)
    return dt, compile_s, reps


def _bench_grad(scene, camera, config, key, spp, rr=0):
    """(median seconds, compile+first seconds, rep times) of one jitted
    value_and_grad of the pixel MSE on the jnp bounce."""
    import jax
    import jax.numpy as jnp

    from simplepathtracer_tpu import inverse

    gcfg = config.replace(spp=spp, rr_start_depth=rr)
    params, static_scene = inverse.split_params(scene)
    target = jnp.zeros((gcfg.height, gcfg.width, 3), jnp.float32)
    fn = jax.jit(jax.value_and_grad(inverse.pixel_loss),
                 static_argnames=("config", "leaves"))

    def run():
        loss, _ = fn(params, static_scene, target, camera, gcfg, key)
        loss.block_until_ready()

    t0 = time.perf_counter()
    run()
    compile_s = time.perf_counter() - t0
    dt, reps = _timed_reps(run)
    return dt, compile_s, reps


def main():
    metrics = []
    errors = []
    detail = {
        "config": f"{WIDTH}x{HEIGHT}@{BENCH_SPP}spp depth={DEPTH}",
        "metrics": metrics,
    }
    result = {
        "metric": "cover_scene_paths_per_sec_1gpu",
        "value": 0.0,
        "unit": "paths/s",
        "vs_baseline": 0.0,
        "detail": detail,
    }

    def fail(err):
        result["error"] = err
        if errors:
            detail["errors"] = errors
        print(json.dumps(result))
        return 1

    try:
        import jax

        from simplepathtracer_tpu._cache import enable_compilation_cache

        enable_compilation_cache()
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            return fail(f"no GPU: JAX's first device is {dev.platform!r}")
        name, limit = card_info()
        detail["device"] = {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "name": name, "power_limit": limit,
        }

        import simplepathtracer_tpu as spt
        from simplepathtracer_tpu.presets import PRESETS

        scene, camera, config = PRESETS["cover"].build()
        key = jax.random.PRNGKey(0)
        detail["config"] += f" spheres={scene.num_spheres}"
    except Exception as e:
        return fail(f"setup: {e!r}\n{traceback.format_exc(limit=3)}")

    try:
        base_pps = cpu_baseline_paths_per_sec()["paths_per_sec"]
    except Exception as e:  # the baseline is informative, not load-bearing
        errors.append(f"cpu_baseline: {e!r}")
        base_pps = None
    detail["cpu_baseline_paths_per_sec"] = base_pps

    def vs(x):
        return round(x / base_pps, 3) if base_pps else None

    def row(name, paths, timing, **extra):
        dt, compile_s, reps = timing
        pps = paths / dt
        metrics.append({
            "name": name, "value": round(pps, 1), "vs_baseline": vs(pps),
            "elapsed_s": round(dt, 4), "compile_plus_first_s": round(compile_s, 1),
            "rep_times_s": reps, **extra,
        })
        return pps

    paths = WIDTH * HEIGHT
    rows = [
        ("fwd_paths_per_sec", BENCH_SPP,
         lambda: _bench_forward(scene, camera, config, key, BENCH_SPP), {}),
        ("fwd_rr_paths_per_sec", BENCH_SPP,
         lambda: _bench_forward(scene, camera,
                                config.replace(rr_start_depth=2), key,
                                BENCH_SPP), {"rr_start_depth": 2}),
        ("fwd_bwd_sustained_100spp_paths_per_sec", BENCH_SPP,
         lambda: _bench_grad(scene, camera, config, key, BENCH_SPP), {}),
        ("fwd_bwd_sustained_rr_paths_per_sec", BENCH_SPP,
         lambda: _bench_grad(scene, camera, config, key, BENCH_SPP, rr=2),
         {"rr_start_depth": 2}),
        ("fwd_bwd_sustained_soft_paths_per_sec", BENCH_SPP,
         lambda: _bench_grad(scene, camera,
                             config.replace(silhouette_softness=0.02), key,
                             BENCH_SPP), {"silhouette_softness": 0.02}),
        ("fwd_bwd_sustained_500spp_paths_per_sec", NORTH_STAR_SPP,
         lambda: _bench_grad(scene, camera, config, key, NORTH_STAR_SPP), {}),
        ("fwd_bwd_sustained_500spp_rr_paths_per_sec", NORTH_STAR_SPP,
         lambda: _bench_grad(scene, camera, config, key, NORTH_STAR_SPP,
                             rr=2), {"rr_start_depth": 2}),
    ]
    for name, spp, timing, extra in rows:
        try:
            pps = row(name, paths * spp, timing(), spp=spp, **extra)
            if name == "fwd_paths_per_sec":
                result["value"] = round(pps, 1)
                result["vs_baseline"] = vs(pps) or 0.0
        except Exception as e:
            errors.append(f"{name}: {e!r}")

    try:
        ref_scene = spt.reference_scene()
        ref_cam = PRESETS["reference"].camera_fn()
        row("fwd_reference_scene_paths_per_sec", paths * BENCH_SPP,
            _bench_forward(ref_scene, ref_cam, config, key, BENCH_SPP),
            spp=BENCH_SPP, spheres=int(ref_scene.num_spheres))
    except Exception as e:
        errors.append(f"fwd_reference_scene: {e!r}")

    if errors:
        detail["errors"] = errors
    if result["value"] == 0.0:
        return fail("no_headline_metric")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
