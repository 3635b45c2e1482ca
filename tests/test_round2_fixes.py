"""Regression tests for the round-2 correctness fixes: gradient entry
points must accept forward-kernel presets, checkpoints must round-trip the
full config, the RNG slot-map depth limit must be enforced, and the jnp
path's spp chunks must bound memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import checkpoint, inverse
from simplepathtracer_tpu.parallel import make_mesh, train_step_sharded
from simplepathtracer_tpu.render import grad_safe_config


def _pallas_preset_cfg(**kw):
    """A preset-like config: forward fast path enabled (interpret on CPU)."""
    return spt.RenderConfig(use_pallas=True, pallas_interpret=True, **kw)


def test_grad_safe_config_downgrades_pallas():
    cfg = _pallas_preset_cfg(width=16, height=8, spp=2, max_depth=3)
    safe = grad_safe_config(cfg)
    assert not safe.use_pallas
    # No-op for already-differentiable configs.
    cfg2 = spt.RenderConfig(width=16, height=8)
    assert grad_safe_config(cfg2) is cfg2


def test_train_step_sharded_accepts_pallas_preset():
    """VERDICT weak #2: train_step_sharded(..., use_pallas=True) used to
    raise deep inside shard_map."""
    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    cfg = _pallas_preset_cfg(width=16, height=8, spp=4, max_depth=3)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(tiles=2, samples=2, devices=jax.devices()[:4])
    target = jnp.full((cfg.height, cfg.width, 3), 0.3, jnp.float32)
    new_scene, loss = train_step_sharded(scene, target, cam, cfg, key, mesh)
    assert np.isfinite(float(loss))
    # Gradients actually flowed (albedo moved).
    assert not np.allclose(np.asarray(new_scene.albedo), np.asarray(scene.albedo))


def test_inverse_fit_accepts_pallas_preset():
    """ADVICE medium: inverse.fit crashed for any use_pallas=True config."""
    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    cfg = _pallas_preset_cfg(width=12, height=8, spp=2, max_depth=3)
    key = jax.random.PRNGKey(1)
    target = inverse.render_linear(scene, cam, grad_safe_config(cfg), key)
    fitted, losses = inverse.fit(
        scene, target, cam, cfg, key, steps=2, lr=1e-2, leaves=("albedo",)
    )
    assert len(losses) == 2 and all(np.isfinite(l) for l in losses)


def test_checkpoint_roundtrips_full_config(tmp_path):
    """ADVICE low: rr_start_depth / silhouette_softness were silently
    dropped by snapshots."""
    cfg = spt.RenderConfig(
        width=16, height=8, spp=4, max_depth=4, rr_start_depth=2,
        pallas_interpret=True, silhouette_softness=0.02, spp_chunk=2,
    )
    scene = spt.simple_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1))
    key = jax.random.PRNGKey(5)
    s = spt.accumulate(spt.init_state(cfg, key), scene, cam, cfg, 2)
    p = str(tmp_path / "snap.npz")
    checkpoint.save(p, s, scene, cfg, cam)
    _, _, cfg_l, _ = checkpoint.load(p)
    assert cfg_l == cfg  # every field, not a hand-picked subset


def test_checkpoint_resume_bit_identical_with_rr(tmp_path):
    """Bit-identical resume for the RR config the bench headlines."""
    cfg = spt.RenderConfig(width=16, height=8, spp=8, max_depth=6, rr_start_depth=2)
    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1))
    key = jax.random.PRNGKey(9)
    full = spt.accumulate(spt.init_state(cfg, key), scene, cam, cfg, 3)
    full = spt.accumulate(full, scene, cam, cfg, 5)
    half = spt.accumulate(spt.init_state(cfg, key), scene, cam, cfg, 3)
    p = str(tmp_path / "rr.npz")
    checkpoint.save(p, half, scene, cfg, cam)
    s_l, scene_l, cfg_l, cam_l = checkpoint.load(p)
    assert cfg_l.rr_start_depth == 2
    resumed = spt.accumulate(s_l, scene_l, cam_l, cfg_l, 5)
    np.testing.assert_array_equal(np.asarray(resumed.accum), np.asarray(full.accum))


def test_max_depth_slot_map_limit():
    """ADVICE low: depth > 30 would silently reuse the camera RNG slots."""
    with pytest.raises(ValueError, match="slot"):
        spt.RenderConfig(max_depth=31)
    spt.RenderConfig(max_depth=30)  # boundary ok


@pytest.mark.parametrize("bytes_limit", [None, 8 << 30, 64 << 30, 80 << 30])
def test_grad_safe_config_bounds_residual_memory(bytes_limit):
    """Preset-scale spp must be chunked on the jnp path: the backward keeps
    per-(ray, bounce) residuals and [rays, spheres] intermediates alive,
    so an unchunked inverse.fit(PRESETS['cover'].config) (spp=100) would
    run out of memory.  The chunk follows the device's memory limit (None:
    no stats, the host budget)."""
    import sys

    R = sys.modules["simplepathtracer_tpu.render"]
    cfg = grad_safe_config(spt.RenderConfig(
        width=1200, height=800, spp=100, max_depth=10, use_pallas=True,
    ))
    assert not cfg.use_pallas
    budget = R.ray_budget(bytes_limit)
    if bytes_limit is None:
        assert budget == R._HOST_RAY_BUDGET
    else:
        assert budget == int(bytes_limit * R._MEMORY_SHARE) // R._BYTES_PER_RAY
    chunk = R.spp_chunk(cfg, cfg.num_pixels, cfg.spp, bytes_limit)
    assert 1 <= chunk < cfg.spp and cfg.spp % chunk == 0
    assert chunk * cfg.num_pixels <= max(budget, cfg.num_pixels)
    # Small configs stay unchunked (no needless scan in the trace).
    small = spt.RenderConfig(width=48, height=24, spp=2)
    assert R.spp_chunk(small, small.num_pixels, 2, bytes_limit) == 2
    # An explicit user chunk is an upper bound, rounded to a divisor.
    assert R.spp_chunk(cfg.replace(spp_chunk=5), cfg.num_pixels, 100,
                       bytes_limit) == 5
    assert R.spp_chunk(cfg.replace(spp_chunk=7), cfg.num_pixels, 100,
                       bytes_limit) == 5


def test_chunked_gradients_match_unchunked():
    """spp-chunked (rematerialized) gradients == one-batch gradients."""
    from simplepathtracer_tpu import inverse

    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    key = jax.random.PRNGKey(5)
    target = jnp.zeros((16, 32, 3), jnp.float32)
    params, static_scene = inverse.split_params(scene)

    def grads(chunk):
        cfg = spt.RenderConfig(
            width=32, height=16, spp=4, max_depth=5, spp_chunk=chunk
        )
        _, g = jax.value_and_grad(inverse.pixel_loss)(
            params, static_scene, target, cam, cfg, key
        )
        return g

    g0 = grads(0)
    g1 = grads(1)
    for k in g0:
        np.testing.assert_allclose(
            np.asarray(g1[k]), np.asarray(g0[k]), rtol=1e-5, atol=1e-7
        )


def test_auto_chunked_render_matches_unchunked(monkeypatch):
    """With a ray budget of one spp of pixels the jnp path renders in
    one-sample chunks; the sums equal the one-batch render's."""
    import sys

    from simplepathtracer_tpu.render import render_sample_batch

    R = sys.modules["simplepathtracer_tpu.render"]
    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=4)
    key = jax.random.PRNGKey(3)
    whole = np.asarray(render_sample_batch(scene, cam, cfg, key, 0, 4))
    monkeypatch.setattr(R, "_HOST_RAY_BUDGET", cfg.num_pixels)
    assert R.spp_chunk(cfg, cfg.num_pixels, 4) == 1
    chunked = np.asarray(render_sample_batch(scene, cam, cfg, key, 0, 4))
    np.testing.assert_allclose(chunked, whole, rtol=1e-5, atol=1e-6)
