"""Camera-leaf gradients (round-5 VERDICT item 7): FD validation + pose
recovery via inverse.fit_camera, and path equivalence jnp vs fused."""

import jax
import jax.numpy as jnp
import numpy as np

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse


def _setup(softness=0.0, spp=16, **cfg_kw):
    scene = spt.three_sphere_scene(hollow_glass=False)
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    cfg = spt.RenderConfig(width=48, height=24, spp=spp, max_depth=3,
                           silhouette_softness=softness, **cfg_kw)
    key = jax.random.PRNGKey(3)
    return scene, cam, cfg, key


def test_camera_gradient_fd_smooth():
    """Soft config: a camera zoom (vfov) shifts every silhouette, so the
    two-sided estimator must carry the visibility terms through the ray
    origins/directions — AD vs FD on the camera leaf.  Lambertian
    materials (specular chains' BSDF-coin discontinuities are a separate,
    documented axis: measured AD/FD ~0.68 with metal+glass vs 0.97
    Lambertian at 512 spp)."""
    scene, cam, cfg, key = _setup(softness=0.05, spp=256)
    scene = scene.replace(material=jnp.zeros_like(scene.material))
    target = inverse.render_linear(
        scene, cam.replace(vfov_deg=jnp.asarray(62.0, jnp.float32)),
        cfg, jax.random.PRNGKey(99),
    )
    params, cam0 = inverse.split_camera(cam)

    def loss(p, k):
        return inverse.camera_pixel_loss(p, cam0, scene, target, cfg, k)

    g = jax.grad(loss)(params, key)
    # vfov: a smooth zoom parameter (every ray direction changes smoothly).
    ad = float(g["vfov_deg"])
    eps = 0.05
    up = dict(params, vfov_deg=params["vfov_deg"] + eps)
    dn = dict(params, vfov_deg=params["vfov_deg"] - eps)
    fd = (float(loss(up, key)) - float(loss(dn, key))) / (2 * eps)
    assert np.isfinite(ad) and ad != 0.0
    np.testing.assert_allclose(ad, fd, rtol=0.25)
    # Descending the gradient reduces the loss (all leaves).
    l0 = float(loss(params, key))
    step = {k: params[k] - 0.02 * v / (jnp.max(jnp.abs(v)) + 1e-12)
            for k, v in g.items()}
    assert float(loss(step, key)) < l0


def test_camera_pose_fit_recovers_origin():
    """Pose recovery: perturb the camera origin, fit it back against a
    soft-to-soft target (silhouette edges carry the pose signal)."""
    scene, cam, cfg, key = _setup(softness=0.05, spp=16)
    target = inverse.render_linear(
        scene, cam, cfg, jax.random.PRNGKey(99)
    )
    bad = cam.replace(
        origin=cam.origin + jnp.asarray([0.06, -0.05, 0.0], jnp.float32)
    )
    fitted, losses = inverse.fit_camera(
        scene, target, bad, cfg, key, steps=40, lr=8e-3,
        leaves=("origin",), softness=0.05,
    )
    err0 = float(jnp.linalg.norm(bad.origin - cam.origin))
    err1 = float(jnp.linalg.norm(fitted.origin - cam.origin))
    assert err1 < err0 * 0.5, (err0, err1, losses[::10])
