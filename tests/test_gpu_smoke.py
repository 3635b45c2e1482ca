"""Compiled forward kernel and GPU gradient fits, on the card.

The CPU suite checks the forward kernel in interpret mode; compiled for
the GPU it goes through Triton, whose lowering can differ (libdevice
math, the NaN-rejecting sphere scan, the bitcast in the uniform-float
conversion).  These tests pin the compiled kernel against the jnp
reference and run the gradient fits at sizes only the card makes quick.
They are marked ``gpu``, skip elsewhere, and run on the card through

    python chip_smoke.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse, scenes
from simplepathtracer_tpu.types import Material

pytestmark = pytest.mark.gpu


def _kernel_vs_jnp(scene, cam, **kw):
    key = jax.random.PRNGKey(11)
    cfg = spt.RenderConfig(**kw)
    a = np.asarray(spt.render(scene, cam, cfg, key))
    b = np.asarray(spt.render(scene, cam, cfg.replace(use_pallas=True), key))
    return np.abs(a - b)


def test_forward_kernel_matches_jnp_compiled():
    """64x32@4spp, hollow glass: compiled kernel vs jnp path."""
    d = _kernel_vs_jnp(
        spt.three_sphere_scene(hollow_glass=True),
        spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0),
        width=64, height=32, spp=4, max_depth=6,
    )
    assert d.mean() < 1e-4, f"mean diff {d.mean()}"
    assert (d > 1e-3).mean() < 5e-3, f"outlier fraction {(d > 1e-3).mean()}"


def test_forward_kernel_plane_rr_defocus_matches_jnp_compiled():
    """Ground plane, Russian roulette and a thin lens, compiled."""
    d = _kernel_vs_jnp(
        spt.with_ground_plane(spt.three_sphere_scene(hollow_glass=True)),
        spt.make_camera(origin=(0, 0.3, -1.5), lookat=(0, 0, 1),
                        vfov_deg=60.0, aperture=0.1),
        width=96, height=48, spp=8, max_depth=8, rr_start_depth=2,
    )
    assert d.mean() < 1e-4, f"mean diff {d.mean()}"
    assert (d > 1e-3).mean() < 5e-3, f"outlier fraction {(d > 1e-3).mean()}"


def test_jnp_gradient_matches_fd_on_gpu():
    """Albedo gradients of the jnp bounce on the GPU against central
    finite differences with common random numbers (the loss is smooth in
    albedo)."""
    scene = spt.three_sphere_scene(hollow_glass=True)
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    cfg = spt.RenderConfig(width=64, height=32, spp=8, max_depth=6)
    key = jax.random.PRNGKey(7)
    target = jnp.full((cfg.height, cfg.width, 3), 0.3, jnp.float32)
    params, static_scene = inverse.split_params(scene, ("albedo",))

    def f(a):
        return inverse.pixel_loss({"albedo": a}, static_scene, target, cam,
                                  cfg, key, ("albedo",))

    g = jax.grad(f)(params["albedo"])
    assert np.isfinite(np.asarray(g)).all()
    eps = 1e-3
    for i, ch in [(1, 0), (2, 1), (3, 2)]:
        da = jnp.zeros_like(params["albedo"]).at[i, ch].set(eps)
        fd = (f(params["albedo"] + da) - f(params["albedo"] - da)) / (2 * eps)
        np.testing.assert_allclose(float(g[i, ch]), float(fd), rtol=5e-2,
                                   atol=1e-6)


def test_plane_offset_fit_converges_on_chip():
    """Plane-OFFSET recovery: the soft-silhouette offset gradient needs
    production-scale sampling (320x160@256spp per step) to beat its Monte
    Carlo noise, which the card makes quick."""

    def mk(k):
        return spt.Scene(
            centers=jnp.asarray([[0.0, 4.0, 2.0]], jnp.float32),
            radii=jnp.asarray([2.5], jnp.float32),
            albedo=jnp.asarray([[0.9, 0.4, 0.2]], jnp.float32),
            material=jnp.asarray([int(Material.LAMBERTIAN)], jnp.int32),
            fuzz=jnp.zeros((1,), jnp.float32),
            ior=jnp.ones((1,), jnp.float32),
            sky_lo=jnp.asarray([1.0, 1.0, 1.0], jnp.float32),
            sky_hi=jnp.asarray([0.2, 0.5, 1.0], jnp.float32),
            plane=jnp.asarray([0.0, 1.0, 0.0, k, 0.85, 0.85, 0.6],
                              jnp.float32),
        )

    scene = mk(0.5)
    cam = spt.make_camera(origin=(0, 1.0, 0), lookat=(0, 0.0, 2.0),
                          vfov_deg=50)
    soft = 0.15
    cfg = spt.RenderConfig(width=320, height=160, spp=256, max_depth=4)
    key = jax.random.PRNGKey(3)
    target = inverse.render_linear(
        scene, cam, cfg.replace(silhouette_softness=soft),
        jax.random.fold_in(key, 9),
    )
    mask = {"plane": jnp.zeros((7,), jnp.float32).at[3].set(1.0)}
    rec, _ = inverse.fit(
        mk(0.8), target, cam, cfg, key, steps=40, lr=8e-3, leaves=("plane",),
        softness=soft, param_mask=mask,
    )
    err0, err1 = 0.3, abs(float(rec.plane[3]) - 0.5)
    assert err1 < err0 * 0.25, f"offset fit did not converge: {err1:.4f}"


def test_buried_radius_fit_converges_on_chip():
    """Intersection-edge recovery: a half-buried sphere's radius, whose
    loss signal lives at its intersection CIRCLE with the ground plane —
    the edge class the crossing + validity coins own (the one-sided
    estimator measured AD/FD = -0.49 there: wrong-signed, the fit would
    run AWAY from truth).  Asserts a 5x error reduction."""
    sc = scenes._scene_from_lists(
        [[0.0, -0.5, 1.0], [0.9, -0.35, 1.3], [-0.85, -0.62, 0.9]],
        [0.4, 0.3, 0.35],
        [[0.1, 0.2, 0.5], [0.8, 0.6, 0.2], [0.7, 0.15, 0.15]],
        [Material.LAMBERTIAN] * 3, [0.0] * 3, [1.5] * 3,
        scenes.SHIRLEY_SKY_LO, scenes.SHIRLEY_SKY_HI,
    )
    truth = scenes.with_ground_plane(sc)
    cam = spt.make_camera(origin=(0.0, 0.5, -1.2), lookat=(0.0, -0.35, 1.0),
                          vfov_deg=55)
    cfg = spt.RenderConfig(
        width=256, height=128, spp=128, max_depth=5, use_pallas=True,
        silhouette_softness=0.05,
    )
    key = jax.random.PRNGKey(0)
    target = inverse.render_linear(
        truth, cam, cfg.replace(use_pallas=False, silhouette_softness=0.0),
        jax.random.PRNGKey(42),
    )
    start = truth.replace(radii=truth.radii.at[0].set(0.30))
    mask = {"radii": jnp.zeros((3,), jnp.float32).at[0].set(1.0)}
    rec, _ = inverse.fit(
        start, target, cam, cfg, key, steps=80, lr=2e-2,
        leaves=("radii",), param_mask=mask, softness=0.05,
    )
    err0, err1 = 0.1, abs(float(rec.radii[0]) - 0.4)
    assert err1 < err0 * 0.2, f"buried-radius fit did not converge: {err1:.4f}"
