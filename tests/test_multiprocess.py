"""Two-process jax.distributed render on localhost (SURVEY.md S4 item 4).

Spawns 2 fresh CPU processes (4 virtual devices each) that federate into
one 8-device job via initialize_cluster, render the sharded accumulation
over a ('tiles': 4, 'samples': 2) mesh spanning both processes, and each
write the pixel rows local_tile_slice says they own.  The stitched image
must equal the single-(test-)process sharded render — which the
mesh-invariance tests already pin to the single-device render.
"""

import os
import subprocess
import sys
import socket

import jax
import numpy as np
import pytest

import simplepathtracer_tpu as spt
from simplepathtracer_tpu.parallel import make_mesh, render_accum_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "multiproc_worker.py"),
             coordinator, "2", str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"

    # Stitch the two halves.
    cfg = spt.RenderConfig(width=32, height=16, spp=8, max_depth=4)
    stitched = np.zeros((cfg.num_pixels, 3), np.float32)
    covered = np.zeros((cfg.num_pixels,), bool)
    for i in range(2):
        start, size = np.load(tmp_path / f"range{i}.npy")
        part = np.load(tmp_path / f"part{i}.npy")
        assert part.shape == (size, 3)
        stitched[start : start + size] = part
        covered[start : start + size] = True
    assert covered.all(), "tile slices do not cover the image"

    # Single-process sharded reference on this test process's 8 fake devices.
    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    key = jax.random.PRNGKey(7)
    mesh = make_mesh(tiles=4, samples=2, devices=jax.devices()[:8])
    expected = np.asarray(
        jax.jit(lambda s, c, k: render_accum_sharded(s, c, cfg, k, mesh))(
            scene, cam, key
        )
    )
    np.testing.assert_allclose(stitched, expected, rtol=1e-6, atol=1e-6)

    # Gradient step: both processes must hold the SAME replicated
    # (loss, grads), equal to the single-process sharded run.
    import jax.numpy as jnp

    from simplepathtracer_tpu.parallel.sharding import loss_and_grad_sharded

    target = jnp.full((cfg.height, cfg.width, 3), 0.25, jnp.float32)
    loss_ref, grads_ref = jax.jit(
        lambda s, t, c, k: loss_and_grad_sharded(s, t, c, cfg, k, mesh)
    )(scene, target, cam, key)
    g0 = np.load(tmp_path / "grads0.npz")
    g1 = np.load(tmp_path / "grads1.npz")
    np.testing.assert_allclose(g0["loss"], g1["loss"], rtol=0, atol=0)
    np.testing.assert_allclose(g0["loss"], np.asarray(loss_ref), rtol=1e-6)
    for k, v in grads_ref.items():
        np.testing.assert_allclose(g0[k], g1[k], rtol=0, atol=0)
        np.testing.assert_allclose(g0[k], np.asarray(v), rtol=1e-5, atol=1e-7)


def _run_generation(tmp_path, mode, expected_rc, also_ok=(), env=None):
    if env is None:
        env = {
            k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
        }
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(REPO, "tests", "multiproc_worker.py"),
             coordinator, "2", str(i), str(tmp_path), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode in (expected_rc,) + tuple(also_ok), (
            f"{mode} worker {i}: rc {p.returncode} != {expected_rc}\n"
            f"{out[-3000:]}"
        )


@pytest.mark.slow
def test_two_process_fit_crash_resume_bit_identical(tmp_path):
    """Multi-host TRAINING-LOOP dress rehearsal (round-5 VERDICT item 6):
    a 2-process sharded Adam fit with train-state checkpointing, killed
    mid-fit and resumed by fresh processes.

    Asserts, strongest first: (a) crash+resume == the uninterrupted
    2-process fit BIT-FOR-BIT (replicated optimizer state, history-free
    step keys, exact train-state snapshots); (b) both processes hold
    identical replicated results; (c) the 2-process fit matches a
    single-(test-)process sharded fit on the same 4x2 mesh to fp-reorder
    tolerance (multi-controller XLA may schedule reductions differently,
    same bound class as the render/grad assertions above)."""
    import jax.numpy as jnp

    from simplepathtracer_tpu import inverse
    from simplepathtracer_tpu.render import render_sample_batch

    full_dir = tmp_path / "full"
    cr_dir = tmp_path / "crashresume"
    full_dir.mkdir()
    cr_dir.mkdir()
    _run_generation(full_dir, "fit", 0)
    _run_generation(cr_dir, "fit_crash", 17, also_ok=(1,))
    assert os.path.exists(cr_dir / "fit_snap.npz")
    _run_generation(cr_dir, "fit_resume", 0)

    full0 = np.load(full_dir / "fit0.npz")
    full1 = np.load(full_dir / "fit1.npz")
    res0 = np.load(cr_dir / "fit0.npz")
    res1 = np.load(cr_dir / "fit1.npz")
    # (b) replicated across processes, bit-exact.
    np.testing.assert_array_equal(full0["albedo"], full1["albedo"])
    np.testing.assert_array_equal(res0["albedo"], res1["albedo"])
    # (a) crash+resume == uninterrupted, bit-exact (params AND loss curve).
    np.testing.assert_array_equal(res0["albedo"], full0["albedo"])
    np.testing.assert_array_equal(res0["losses"], full0["losses"])
    assert len(res0["losses"]) == 6

    # (c) single-process sharded fit on this process's 8 fake devices.
    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    fcfg = spt.RenderConfig(width=24, height=12, spp=4, max_depth=3)
    key = jax.random.PRNGKey(7)
    tkey = jax.random.fold_in(key, 999)
    target = (
        render_sample_batch(scene, cam, fcfg, tkey, 0, fcfg.spp) / fcfg.spp
    ).reshape(fcfg.height, fcfg.width, 3)
    perturbed = scene.replace(albedo=jnp.clip(scene.albedo + 0.2, 0.05, 0.95))
    mesh = make_mesh(tiles=4, samples=2, devices=jax.devices()[:8])
    fitted, losses = inverse.fit_sharded(
        perturbed, target, cam, fcfg, key, mesh,
        steps=6, lr=5e-2, leaves=("albedo",),
    )
    np.testing.assert_allclose(
        res0["albedo"], np.asarray(fitted.albedo), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        res0["losses"], np.asarray(losses, np.float64), rtol=1e-5, atol=1e-8
    )
    # The fit made progress (loss decreased).
    assert losses[-1] < losses[0]


@pytest.mark.slow
def test_two_process_crash_and_resume(tmp_path):
    """Failure recovery for a MULTI-HOST render (VERDICT r2 missing #4):
    both workers snapshot their tile slices at half the spp and then DIE
    (os._exit mid-job); a second generation of workers restores from the
    per-process snapshots, finishes the remaining spp, and the stitched
    image must equal the uninterrupted sharded render."""
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }

    def run_generation(mode, expected_rc, also_ok=()):
        port = _free_port()
        coordinator = f"127.0.0.1:{port}"
        procs = [
            subprocess.Popen(
                [sys.executable,
                 os.path.join(REPO, "tests", "multiproc_worker.py"),
                 coordinator, "2", str(i), str(tmp_path), mode],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            for i in range(2)
        ]
        for i, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            assert p.returncode in (expected_rc,) + tuple(also_ok), (
                f"{mode} worker {i}: rc {p.returncode} != {expected_rc}\n"
                f"{out[-3000:]}"
            )

    # Both hosts die after the snapshot barrier; whichever process the
    # coordination service reaps first may exit 1 instead of 17 (the
    # leader's death tears down the peer) — both are "host died mid-job".
    run_generation("crash", 17, also_ok=(1,))
    assert os.path.exists(tmp_path / "shard_snap.proc0of2.npz")
    assert os.path.exists(tmp_path / "shard_snap.proc1of2.npz")
    run_generation("resume", 0)   # fresh processes restore and finish

    cfg = spt.RenderConfig(width=32, height=16, spp=8, max_depth=4)
    stitched = np.zeros((cfg.num_pixels, 3), np.float32)
    for i in range(2):
        start, size = np.load(tmp_path / f"range{i}.npy")
        stitched[start : start + size] = np.load(tmp_path / f"part{i}.npy")

    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    key = jax.random.PRNGKey(7)
    mesh = make_mesh(tiles=4, samples=2, devices=jax.devices()[:8])
    expected = np.asarray(
        jax.jit(lambda s, c, k: render_accum_sharded(s, c, cfg, k, mesh))(
            scene, cam, key
        )
    )
    np.testing.assert_allclose(stitched, expected, rtol=1e-6, atol=1e-6)
