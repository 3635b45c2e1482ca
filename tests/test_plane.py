"""Ray-plane intersection (reference Collision.hpp:73-85 semantics —
dead code there, standalone-but-tested here)."""

import jax
import jax.numpy as jnp
import numpy as np

from simplepathtracer_tpu.ops.plane import ray_plane_intersection


def _rays(o, d):
    o = jnp.asarray(o, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(d, jnp.float32).reshape(-1, 3)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def test_straight_down_onto_ground():
    o, d = _rays([[0, 2, 0]], [[0, -1, 0]])
    h = ray_plane_intersection(o, d, normal=(0, 1, 0), offset=0.0)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 2.0, rtol=1e-6)
    np.testing.assert_allclose(h.point[0], [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(h.normal[0], [0, 1, 0], atol=1e-6)


def test_parallel_ray_misses():
    o, d = _rays([[0, 1, 0]], [[1, 0, 0]])
    h = ray_plane_intersection(o, d, normal=(0, 1, 0), offset=0.0)
    assert not bool(h.hit[0])


def test_behind_ray_misses():
    o, d = _rays([[0, 2, 0]], [[0, 1, 0]])
    h = ray_plane_intersection(o, d, normal=(0, 1, 0), offset=0.0)
    assert not bool(h.hit[0])


def test_offset_plane_and_faceforward():
    # Plane y = 3 (n=(0,1,0), k=-3), ray from above: face normal points up
    # toward the ray (-? the ray travels -y so the forward face is +y).
    o, d = _rays([[0, 5, 0]], [[0, -1, 0]])
    h = ray_plane_intersection(o, d, normal=(0, 1, 0), offset=-3.0)
    assert bool(h.hit[0])
    np.testing.assert_allclose(h.t[0], 2.0, rtol=1e-6)
    np.testing.assert_allclose(h.normal[0], [0, 1, 0], atol=1e-6)
    # From below, the face-forward normal flips.
    o2, d2 = _rays([[0, 0, 0]], [[0, 1, 0]])
    h2 = ray_plane_intersection(o2, d2, normal=(0, 1, 0), offset=-3.0)
    assert bool(h2.hit[0])
    np.testing.assert_allclose(h2.normal[0], [0, -1, 0], atol=1e-6)


def test_gradients_wrt_offset():
    o, d = _rays([[0.3, 2, 0.1]], [[0.1, -1, 0.05]])

    def t_of(k):
        return ray_plane_intersection(o, d, (0, 1, 0), k).t[0]

    g = jax.grad(t_of)(0.0)
    eps = 1e-3
    fd = (t_of(eps) - t_of(-eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)


# ---------------------------------------------------------------------------
# Ground-plane scene integration (scenes.with_ground_plane): the plane is
# live in the jnp bounce AND both Pallas kernels (VERDICT r2 next #10).
# ---------------------------------------------------------------------------

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import checkpoint, inverse
from simplepathtracer_tpu.scenes import with_ground_plane


def _floating_scene():
    """Spheres above a plane, NO ground sphere — the plane is the ground."""
    base = spt.three_sphere_scene(hollow_glass=False)
    keep = slice(1, None)  # drop the huge ground sphere
    scene = base.replace(
        centers=base.centers[keep], radii=base.radii[keep],
        albedo=base.albedo[keep], material=base.material[keep],
        fuzz=base.fuzz[keep], ior=base.ior[keep],
    )
    return with_ground_plane(scene, point=(0.0, -0.5, 0.0))


def _cam():
    return spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)


def test_plane_renders_and_differs_from_no_plane():
    scene = _floating_scene()
    cfg = spt.RenderConfig(width=32, height=24, spp=4, max_depth=4)
    key = jax.random.PRNGKey(0)
    img = np.asarray(spt.render(scene, _cam(), cfg, key))
    img_no = np.asarray(spt.render(scene.replace(plane=None), _cam(), cfg, key))
    assert np.isfinite(img).all()
    # The lower half must show the plane (brighter than sky-only lower half
    # is not guaranteed, but the images must differ substantially there).
    assert np.abs(img[12:] - img_no[12:]).mean() > 0.02


def test_plane_bounce_kernel_matches_jnp():
    """Forward kernel through render() with the plane == jnp bounce."""
    scene = _floating_scene()
    cfg_kw = dict(width=32, height=24, spp=4, max_depth=4)
    key = jax.random.PRNGKey(11)
    a = np.asarray(spt.render(scene, _cam(), spt.RenderConfig(**cfg_kw), key))
    b = np.asarray(spt.render(
        scene, _cam(),
        spt.RenderConfig(**cfg_kw, use_pallas=True, pallas_interpret=True),
        key,
    ))
    d = np.abs(a - b)
    assert d.mean() < 1e-4 and (d > 1e-2).mean() < 5e-3, (d.mean(), d.max())


def test_plane_persistent_kernel_matches_jnp():
    """Forward kernel's per-block entry with the plane == jnp bounce."""
    from simplepathtracer_tpu.render import _render_block_pallas
    import jax.numpy as jnp

    scene = _floating_scene()
    cfg = spt.RenderConfig(width=32, height=16, spp=4, max_depth=4,
                           use_pallas=True, pallas_interpret=True)
    key = jax.random.PRNGKey(3)
    pixel_ids = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    acc_k = np.asarray(
        _render_block_pallas(scene, _cam(), cfg, key, pixel_ids, 0, cfg.spp)[0]
    )
    from simplepathtracer_tpu.render import render_sample_batch

    acc_j = np.asarray(render_sample_batch(
        scene, _cam(), cfg.replace(use_pallas=False), key, 0, cfg.spp
    ))
    d = np.abs(acc_k - acc_j) / cfg.spp
    assert d.mean() < 1e-4 and (d > 1e-2).mean() < 5e-3, (d.mean(), d.max())


def test_plane_gradients_flow():
    """Gradient entry points accept a forward-kernel plane config (the jnp
    bounce runs) and every leaf's gradient is finite, the plane's included."""
    import jax.numpy as jnp

    scene = _floating_scene()
    cfg = spt.RenderConfig(width=24, height=16, spp=4, max_depth=3,
                           use_pallas=True)
    key = jax.random.PRNGKey(5)
    target = jnp.zeros((16, 24, 3), jnp.float32)
    params, static_scene = inverse.split_params(scene)
    loss, grads = jax.value_and_grad(inverse.pixel_loss)(
        params, static_scene, target, _cam(), cfg, key
    )
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), k
    assert np.abs(np.asarray(grads["albedo"])).max() > 0
    assert np.abs(np.asarray(grads["plane"])[3:]).max() > 0
    # The values equal the explicit jnp-path gradients.
    loss2, grads2 = jax.value_and_grad(inverse.pixel_loss)(
        params, static_scene, target, _cam(),
        cfg.replace(use_pallas=False), key,
    )
    np.testing.assert_allclose(float(loss), float(loss2), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(
            np.asarray(grads[k]), np.asarray(grads2[k]), rtol=1e-5, atol=1e-7
        )


def test_plane_checkpoint_roundtrip(tmp_path):
    scene = _floating_scene()
    cfg = spt.RenderConfig(width=16, height=8, spp=2, max_depth=2)
    state = spt.accumulate(
        spt.init_state(cfg, jax.random.PRNGKey(0)), scene, _cam(), cfg, 2
    )
    p = str(tmp_path / "plane_snap.npz")
    checkpoint.save(p, state, scene, cfg, _cam())
    _, scene2, _, _ = checkpoint.load(p)
    assert scene2.plane is not None
    np.testing.assert_array_equal(np.asarray(scene2.plane), np.asarray(scene.plane))
    # And a plane-free scene round-trips plane=None.
    checkpoint.save(p, state, scene.replace(plane=None), cfg)
    _, scene3, _, _ = checkpoint.load(p)
    assert scene3.plane is None


def test_plane_sharded_matches_unsharded():
    """Ground-plane scene through the ('tiles','samples') mesh: sharding
    cannot change values (randomness keyed by global ids)."""
    import jax.numpy as jnp

    from simplepathtracer_tpu.parallel import make_mesh, render_accum_sharded
    from simplepathtracer_tpu.render import render_sample_batch

    scene = _floating_scene()
    cfg = spt.RenderConfig(width=32, height=16, spp=4, max_depth=3)
    key = jax.random.PRNGKey(1)
    mesh = make_mesh(tiles=4, samples=2)
    sharded = np.asarray(jax.jit(
        lambda s, c, k: render_accum_sharded(s, c, cfg, k, mesh)
    )(scene, _cam(), key))
    single = np.asarray(render_sample_batch(scene, _cam(), cfg, key, 0, cfg.spp))
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-6)
