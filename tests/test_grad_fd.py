"""Gradients of the jnp bounce against central finite differences, leaf by
leaf, across the scene classes the gradient path serves.

The loss is a deterministic function of the parameters for a fixed key
(common random numbers), and piecewise smooth: a hit selection or a coin
only flips where a parameter crosses an edge.  So for every leaf on which
the sampled paths depend smoothly at this size, autodiff along a random
direction must equal a central finite difference:

  * albedo, sky and the plane's albedo scale radiance multilinearly (RR
    off), in every class, soft and crossing included — the soft
    estimator's detached ratio is 1 in value and depends on geometry only;
  * in the hard classes (sphere, reference, plane) the geometry and
    material leaves move hit points and scatter directions continuously,
    and a small image with a small step crosses no edge.

Geometry leaves under soft silhouettes are unbiased only in expectation
(their per-sample gradient carries the REINFORCE score), so they are
checked statistically in tests/test_crossing.py and tests/test_inverse.py.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse, scenes
from simplepathtracer_tpu.types import Material

_SMOOTH = ("albedo", "sky_lo", "sky_hi", "plane_albedo")


def _floating():
    base = spt.three_sphere_scene(hollow_glass=False)
    keep = slice(1, None)
    sc = base.replace(
        centers=base.centers[keep], radii=base.radii[keep],
        albedo=base.albedo[keep], material=base.material[keep],
        fuzz=base.fuzz[keep], ior=base.ior[keep],
    )
    return scenes.with_ground_plane(sc, point=(0.0, -0.5, 0.0))


def _poke():
    sc = scenes._scene_from_lists(
        [[0.0, -0.5, 1.0], [0.9, -0.35, 1.3], [-0.85, -0.62, 0.9]],
        [0.4, 0.3, 0.35],
        [[0.1, 0.2, 0.5], [0.8, 0.6, 0.2], [0.7, 0.15, 0.15]],
        [Material.LAMBERTIAN] * 3, [0.0] * 3, [1.5] * 3,
        scenes.SHIRLEY_SKY_LO, scenes.SHIRLEY_SKY_HI,
    )
    return scenes.with_ground_plane(sc)


_CLASSES = {
    # name: (scene factory, camera kwargs, softness)
    "sphere": (lambda: spt.three_sphere_scene(hollow_glass=False),
               dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60), 0.0),
    "plane": (_floating,
              dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60), 0.0),
    "reference": (spt.reference_scene,
                  dict(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90), 0.0),
    "soft": (lambda: spt.three_sphere_scene(hollow_glass=False),
             dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60), 0.05),
    "crossing": (_poke, dict(origin=(0.0, 0.5, -1.2),
                             lookat=(0.0, -0.35, 1.0), vfov_deg=55), 0.05),
}


@functools.lru_cache(maxsize=None)
def _problem(cls):
    """(params, jitted image, jitted MSE gradient, MSE cotangent) for one
    scene class."""
    make, cam_kw, soft = _CLASSES[cls]
    scene = make()
    cam = spt.make_camera(**cam_kw)
    cfg = spt.RenderConfig(width=12, height=8, spp=2, max_depth=3,
                           silhouette_softness=soft)
    key = jax.random.PRNGKey(21)
    target = jnp.full((cfg.height, cfg.width, 3), 0.3, jnp.float32)
    params, static_scene = inverse.split_params(scene)

    def image(p):
        return inverse.render_linear(
            inverse.merge_params(p, static_scene), cam, cfg, key)

    def loss(p):
        return inverse.pixel_loss(p, static_scene, target, cam, cfg, key)

    img0 = np.asarray(jax.jit(image)(params), np.float64)
    cot = 2.0 * (img0 - np.asarray(target)) / img0.size
    return params, jax.jit(image), jax.jit(jax.grad(loss)), cot


def _cases():
    out = []
    for cls in _CLASSES:
        leaves = ["centers", "radii", "albedo", "fuzz", "ior", "sky_lo", "sky_hi"]
        if cls in ("plane", "crossing"):
            leaves += ["plane_offset", "plane_albedo"]
        for leaf in leaves:
            if cls in ("soft", "crossing") and leaf not in _SMOOTH:
                continue
            # The reference's r=1000 ground sphere puts f32 cancellation
            # noise into every hit point near it, so its geometry is not
            # smooth at FD resolution; its one glass sphere stays out of
            # these 96 pixels (ior gradient exactly 0).
            if cls == "reference" and leaf in ("centers", "radii", "ior"):
                continue
            out.append((cls, leaf))
    return out


def _direction(params, leaf):
    """A random unit direction in one leaf (the plane split into offset and
    albedo; its normal is not a parameter)."""
    name = "plane" if leaf.startswith("plane") else leaf
    rng = np.random.default_rng(zlib.crc32(leaf.encode()))
    v = rng.standard_normal(np.shape(params[name])).astype(np.float32)
    if leaf == "plane_offset":
        v = np.zeros(7, np.float32)
        v[3] = 1.0
    elif leaf == "plane_albedo":
        v[:4] = 0.0
    v /= np.linalg.norm(v)
    return name, jnp.asarray(v)


@pytest.mark.parametrize("cls,leaf", _cases())
def test_ad_matches_central_fd(cls, leaf):
    """d MSE along v against the central difference of the image, weighted
    by the MSE's cotangent at the base point (the same first-order
    quantity).  Differencing images pixel by pixel, before any sum, keeps
    f32 cancellation to the pixels the step actually changes."""
    params, image, grad, cot = _problem(cls)
    name, v = _direction(params, leaf)
    ad = float(jnp.vdot(grad(params)[name], v))
    eps = 1e-3 if leaf in _SMOOTH else 3e-4

    def at(t):
        p = dict(params)
        p[name] = params[name] + t * v
        return np.asarray(image(p), np.float64)

    fd = float(np.sum(cot * (at(eps) - at(-eps)))) / (2 * eps)
    assert np.isfinite(ad)
    assert abs(ad - fd) <= 2e-2 * abs(fd) + 1e-6, (ad, fd)
