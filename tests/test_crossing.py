"""Opaque-opaque intersection-edge (t-crossing) estimator — round 5.

The stochastic plane-vs-sphere WINNER SELECT (sphere beats the plane iff
t_s < t_p + logit(ux) * sigma_x, coin slot 128 + b) runs in the jnp bounce;
the realized outcome's probability rides the
detached REINFORCE ratio.  Scenes here have spheres POKING THROUGH the
ground plane so the crossing band is actually exercised (the pre-existing
plane tests keep their spheres clear of it).

The companion VALIDITY coin (same eval, word 1) softens the t > t_min
candidate gate whose far-root flips at phantom-continuation origins
carried the other major share of the edge mass; the chain's previous
winner keeps the hard gate (its own far root sits at exactly 0 — a coin
there re-validates bounces as in-place self-hits).

Validated here: finite, energy-sane deep soft renders, a finite gradient
where the sphere leads the plane far beyond the crossing band, and the
estimator's sign fix (the buried sphere's radius gradient measured AD/FD =
-0.49 WRONG-SIGNED one-sided; with both coins it is positive and O(1) —
BASELINE.md's late-round-5 section has the full study; the remaining
unowned class is the near/far-root SELECT jump).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse, scenes
from simplepathtracer_tpu.types import Material


def _poke_scene():
    sc = scenes._scene_from_lists(
        [[0.0, -0.5, 1.0], [0.9, -0.35, 1.3], [-0.85, -0.62, 0.9]],
        [0.4, 0.3, 0.35],
        [[0.1, 0.2, 0.5], [0.8, 0.6, 0.2], [0.7, 0.15, 0.15]],
        [Material.LAMBERTIAN, Material.LAMBERTIAN, Material.LAMBERTIAN],
        [0.0, 0.0, 0.0], [1.5, 1.5, 1.5],
        scenes.SHIRLEY_SKY_LO, scenes.SHIRLEY_SKY_HI,
    )
    return scenes.with_ground_plane(sc)


def _setup(width=32, height=16, spp=4, depth=4, **cfg_kw):
    scene = _poke_scene()
    cam = spt.make_camera(origin=(0.0, 0.5, -1.2), lookat=(0.0, -0.35, 1.0),
                          vfov_deg=55)
    cfg = spt.RenderConfig(width=width, height=height, spp=spp,
                           max_depth=depth, silhouette_softness=0.05,
                           **cfg_kw)
    return scene, cam, cfg, jax.random.PRNGKey(7)


def test_validity_coin_no_self_hits_no_nan():
    """Regression: a validity band centered at t_min would re-validate the
    chain's own sphere (far root exactly 0) on ~45% of bounces — in-place
    self-hit loops that surfaced as rare-sample NaNs at depth 3.  The
    previous-winner hard gate must keep deep soft renders finite and
    energy-sane."""
    scene, cam, cfg, key = _setup(width=48, height=24, spp=1024, depth=4)
    img = np.asarray(inverse.render_linear(scene, cam, cfg, key))
    assert np.isfinite(img).all()
    # Self-hit loops eat throughput: the mean must stay near the hard
    # render's (soft smoothing alone moves it well under 5%).
    hard = np.asarray(inverse.render_linear(
        scene, cam, cfg.replace(silhouette_softness=0.0, spp=256), key
    ))
    assert abs(img.mean() - hard.mean()) < 0.05 * hard.mean(), (
        img.mean(), hard.mean()
    )


def test_crossing_fixes_buried_radius_gradient_sign():
    """The headline estimator check: d loss / d radius of the half-buried
    sphere.  One-sided round 4 measured AD/FD = -0.49 (WRONG-SIGNED: the
    intersection-circle edge mass was invisible); with the crossing +
    validity coins the jnp AD must carry the same sign as CRN finite
    differences and an O(1) fraction of their magnitude (~0.44 at this
    depth-3 MSE config at high spp; the crossing-zoom scene reads
    0.86-0.89 — the remaining unowned class is the near/far-root select
    jump, BASELINE.md late round 5)."""
    scene, cam, cfg, key = _setup(width=48, height=24, spp=512, depth=3)
    prng = np.random.default_rng(11)
    pert = scene.replace(
        centers=scene.centers + jnp.asarray(
            0.04 * prng.standard_normal(scene.centers.shape), jnp.float32),
        radii=scene.radii * jnp.asarray(
            1.0 + 0.05 * prng.standard_normal(scene.radii.shape), jnp.float32),
    )
    target = inverse.render_linear(pert, cam, cfg, jax.random.PRNGKey(99))
    params, static_scene = inverse.split_params(scene)

    @jax.jit
    def loss_fn(p):
        return inverse.pixel_loss(p, static_scene, target, cam, cfg, key)

    g = jax.grad(loss_fn)(params)
    v = jnp.zeros(3).at[0].set(1.0)  # buried sphere's radius
    ad = float(jnp.vdot(g["radii"], v))
    eps = 4e-3

    def at(t):
        p = dict(params)
        p["radii"] = params["radii"] + t * v
        return float(loss_fn(p))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert fd != 0.0
    ratio = ad / fd
    assert 0.3 < ratio < 1.8, (ad, fd, ratio)


@pytest.mark.parametrize("lead", [-40.0, -17.0, 0.3, 17.0, 40.0])
@pytest.mark.parametrize("plane_won", [True, False], ids=["plane", "sphere"])
def test_crossing_probability_finite_far_outside_band(lead, plane_won):
    """The realized select's probability stays positive, and its detached
    ratio's gradient finite, however far one surface leads: with the
    sphere ahead by ~17 sigma, 1 - sigmoid(arg) rounds to 0 in f32 and a
    realized plane win made den / stop_grad(den) = 0 / 0."""
    from simplepathtracer_tpu.render import crossing_probability

    sig = jnp.float32(0.05)
    ph_t = jnp.float32(2.0)
    t_w = ph_t - lead * sig          # lead > 0: the sphere is nearer
    if lead >= 17.0:
        arg = jnp.clip((ph_t - t_w) / (sig + 1e-12), -30.0, 30.0)
        assert float(1.0 - jax.nn.sigmoid(arg)) == 0.0  # the old form

    def ratio(t):
        den = crossing_probability(ph_t, t, sig, jnp.bool_(plane_won))
        return den / jax.lax.stop_gradient(den)

    val, g = jax.value_and_grad(ratio)(t_w)
    assert float(val) == 1.0
    assert np.isfinite(float(g))
    den = float(crossing_probability(ph_t, t_w, sig, jnp.bool_(plane_won)))
    assert 0.0 < den <= 1.0
