"""Scaling benchmark: sharded render and train-step time vs mesh size.

BASELINE.json north star: >=85% rays/s scaling efficiency to N>=2 hosts.
Runs the sharded code path on 1, 2, 4, ... of the visible devices and
prints one JSON line per mesh point.  On the four cards of one host it
measures real scaling.  On the forced-host-device CPU backend the
"devices" share the same silicon, so flat wall clock as the mesh grows
shows only that the shard_map program balances its work (no
serialization, no replicated work growing with the mesh).

Run: python bench_scaling.py          (all visible GPUs)
     JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python bench_scaling.py          (work-balance check on the CPU)
"""

import json
import time

import numpy as np


def main():
    import jax

    import simplepathtracer_tpu as spt
    from simplepathtracer_tpu.parallel import make_mesh, render_accum_sharded

    import jax.numpy as jnp

    from simplepathtracer_tpu.parallel import train_step_sharded

    scene = spt.cover_scene(jax.random.PRNGKey(0), max_spheres=256)
    camera = spt.make_camera(
        origin=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0), vfov_deg=20.0,
        aperture=0.1, focus_dist=10.0,
    )
    config = spt.RenderConfig(width=256, height=128, spp=8, max_depth=6)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((config.height, config.width, 3), jnp.float32)
    n_dev = len(jax.devices())
    points = []
    m = 1
    while m <= n_dev:
        samples = 2 if m % 2 == 0 else 1
        mesh = make_mesh(
            tiles=m // samples, samples=samples, devices=jax.devices()[:m]
        )

        def run():
            acc = render_accum_sharded(scene, camera, config, key, mesh)
            return np.asarray(acc[0])

        def run_grad():
            # Full sharded train step (forward + backward + grad psum) —
            # the fwd+bwd north-star metric's distributed form.
            _, loss = train_step_sharded(
                scene, target, camera, config, key, mesh
            )
            return float(loss)

        run()  # compile
        t0 = time.time()
        run()
        dt = time.time() - t0
        run_grad()  # compile
        t0 = time.time()
        run_grad()
        dt_g = time.time() - t0
        paths = config.num_pixels * config.spp
        points.append({
            "devices": m,
            "mesh": dict(mesh.shape),
            "elapsed_s": round(dt, 4),
            "paths_per_sec": round(paths / dt, 1),
            "grad_elapsed_s": round(dt_g, 4),
            "grad_paths_per_sec": round(paths / dt_g, 1),
        })
        m *= 2

    base = points[0]["elapsed_s"]
    base_g = points[0]["grad_elapsed_s"]
    for p in points:
        # On shared silicon, perfect work-balance keeps wall clock flat.
        p["wallclock_vs_1dev"] = round(p["elapsed_s"] / base, 3)
        p["grad_wallclock_vs_1dev"] = round(p["grad_elapsed_s"] / base_g, 3)
        print(json.dumps(p))


if __name__ == "__main__":
    main()
