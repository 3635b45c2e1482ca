"""Inverse rendering (BASELINE config 4): gradients recover scene params."""

import jax
import jax.numpy as jnp
import numpy as np

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse


def _setup():
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    cfg = spt.RenderConfig(width=48, height=24, spp=8, max_depth=4)
    key = jax.random.PRNGKey(0)
    truth = spt.three_sphere_scene(hollow_glass=False)
    target = inverse.render_linear(truth, cam, cfg, jax.random.fold_in(key, 999))
    return truth, target, cam, cfg, key


def test_gradients_finite_and_nonzero():
    truth, target, cam, cfg, key = _setup()
    perturbed = truth.replace(albedo=jnp.clip(truth.albedo + 0.2, 0, 1))
    params, static_scene = inverse.split_params(perturbed)
    loss, grads = jax.value_and_grad(inverse.pixel_loss)(
        params, static_scene, target, cam, cfg, key
    )
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), f"non-finite grad for {k}"
    assert np.abs(np.asarray(grads["albedo"])).max() > 0


def test_fit_recovers_albedo():
    truth, target, cam, cfg, key = _setup()
    perturbed = truth.replace(albedo=jnp.clip(truth.albedo + 0.25, 0.05, 0.95))
    recovered, losses = inverse.fit(
        perturbed, target, cam, cfg, key, steps=25, lr=5e-2,
        leaves=("albedo",),
    )
    assert losses[-1] < losses[0] * 0.5, losses[::6]
    err_before = float(jnp.abs(perturbed.albedo - truth.albedo).mean())
    err_after = float(jnp.abs(recovered.albedo - truth.albedo).mean())
    assert err_after < err_before * 0.6, (err_before, err_after)


def test_finite_difference_albedo_gradient():
    """FD check of d loss / d albedo (SURVEY.md S4 item 3).

    Albedo enters the loss continuously (throughput products), so FD and
    autodiff must agree tightly.  Geometry parameters (centers/radii) carry
    silhouette/visibility terms that the reparameterized gradient
    intentionally omits (hit selection is locally constant), so those are
    checked for descent direction only, below.
    """
    truth, target, cam, cfg, key = _setup()
    base = truth.replace(albedo=jnp.clip(truth.albedo + 0.1, 0, 1))
    params, static_scene = inverse.split_params(base, leaves=("albedo",))

    def f(a):
        return inverse.pixel_loss(
            {"albedo": a}, static_scene, target, cam, cfg, key, ("albedo",)
        )

    g = jax.grad(f)(params["albedo"])
    eps = 1e-3
    for i, ch in [(1, 0), (2, 2)]:
        da = jnp.zeros_like(params["albedo"]).at[i, ch].set(eps)
        fd = (f(params["albedo"] + da) - f(params["albedo"] - da)) / (2 * eps)
        np.testing.assert_allclose(float(g[i, ch]), float(fd), rtol=5e-2, atol=1e-6)


def test_soft_silhouette_center_gradient_descends():
    """With the first-bounce soft-silhouette blend, center gradients carry
    visibility terms and following them reduces the loss (pure interior
    gradients cannot do this — the silhouette term dominates position
    recovery and is dropped by the detached argmin)."""
    truth, target, cam, cfg, key = _setup()
    cfg_soft = cfg.replace(silhouette_softness=0.05)
    base = truth.replace(centers=truth.centers.at[1, 1].add(0.08))
    params, static_scene = inverse.split_params(base, leaves=("centers",))

    def f(c):
        return inverse.pixel_loss(
            {"centers": c}, static_scene, target, cam, cfg_soft, key, ("centers",)
        )

    g = jax.grad(f)(params["centers"])
    # The perturbed sphere's y gradient must point back toward the truth
    # (loss increases with +y, so d loss / d y > 0).
    assert float(g[1, 1]) > 0, np.asarray(g)
    l0 = float(f(params["centers"]))
    l1 = float(f(params["centers"] - 0.02 * g / (jnp.abs(g).max() + 1e-9)))
    assert l1 < l0, (l0, l1)


def test_fit_recovers_center_offset():
    """BASELINE config 4: recover a sphere position from the image.

    Soft-to-soft objective (target rendered with the same silhouette
    softness) and the ground sphere frozen via param_mask — without the
    mask, Adam's RMS normalization random-walks the huge ground sphere on
    Monte-Carlo gradient noise and wrecks the scene.
    """
    truth, _, cam, cfg, key = _setup()
    cfg_soft = cfg.replace(silhouette_softness=0.05)
    target = inverse.render_linear(truth, cam, cfg_soft, jax.random.fold_in(key, 999))
    perturbed = truth.replace(centers=truth.centers.at[1, 1].add(0.1))
    mask = {"centers": jnp.zeros_like(truth.centers).at[1:].set(1.0)}
    recovered, losses = inverse.fit(
        perturbed, target, cam, cfg, key, steps=40, lr=1e-2,
        leaves=("centers",), softness=0.05, param_mask=mask,
    )
    err_before = float(jnp.abs(perturbed.centers[1] - truth.centers[1]).max())
    err_after = float(jnp.abs(recovered.centers[1] - truth.centers[1]).max())
    assert err_after < err_before * 0.5, (err_before, err_after)
    # The frozen ground sphere must not have moved at all.
    np.testing.assert_array_equal(
        np.asarray(recovered.centers[0]), np.asarray(truth.centers[0])
    )


def test_fit_snapshot_resume_bit_identical(tmp_path):
    """Interrupt/resume of a fit == the uninterrupted run, bit for bit.

    The training-loop analog of checkpoint.py's render resume guarantee:
    step keys are fold_in(key, i) (history-independent), and the snapshot
    carries the full (params, Adam state, step) so continuation is exact.
    """
    truth, target, cam, cfg, key = _setup()
    perturbed = truth.replace(albedo=jnp.clip(truth.albedo + 0.2, 0.0, 1.0))
    fit_key = jax.random.PRNGKey(21)

    ref_scene, ref_losses = inverse.fit(
        perturbed, target, cam, cfg, fit_key, steps=6, lr=5e-2,
        leaves=("albedo",),
    )

    snap = str(tmp_path / "fit.npz")
    # "Crash" after 3 steps: run with a snapshot, then resume to 6.
    inverse.fit(
        perturbed, target, cam, cfg, fit_key, steps=3, lr=5e-2,
        leaves=("albedo",), snapshot_path=snap, snapshot_every=3,
    )
    resumed_scene, resumed_losses = inverse.fit(
        perturbed, target, cam, cfg, fit_key, steps=6, lr=5e-2,
        leaves=("albedo",), snapshot_path=snap, snapshot_every=3,
    )
    assert resumed_losses[:3] == ref_losses[:3]
    assert resumed_losses[3:] == ref_losses[3:]
    np.testing.assert_array_equal(
        np.asarray(resumed_scene.albedo), np.asarray(ref_scene.albedo)
    )


def test_fit_recovers_ior():
    """The glass sphere's refraction index is advertised as differentiable
    (DIFF_LEAVES) — prove a fit actually recovers it (VERDICT r2 weak #7).
    The signal is the refraction distortion of the background seen through
    the glass, so the camera looks at the glass sphere."""
    cam = spt.make_camera(origin=(-1.0, 0.0, -0.6), lookat=(-1.0, 0.0, 1.0),
                          vfov_deg=60)
    cfg = spt.RenderConfig(width=48, height=32, spp=16, max_depth=6)
    key = jax.random.PRNGKey(4)
    truth = spt.three_sphere_scene(hollow_glass=False)
    target = inverse.render_linear(truth, cam, cfg, jax.random.fold_in(key, 999))

    start = truth.replace(ior=truth.ior.at[3].set(2.2))
    # Freeze every slot but the glass sphere's: the other iors are inert
    # (zero gradient through the material select) but Adam would random-walk
    # them on MC noise if any leaked.
    mask = {"ior": jnp.zeros_like(truth.ior).at[3].set(1.0)}
    recovered, losses = inverse.fit(
        start, target, cam, cfg, key, steps=40, lr=3e-2,
        leaves=("ior",), param_mask=mask,
    )
    err_before = abs(float(start.ior[3]) - 1.5)
    err_after = abs(float(recovered.ior[3]) - 1.5)
    assert err_after < err_before * 0.5, (
        f"ior {float(start.ior[3])} -> {float(recovered.ior[3])} (truth 1.5); "
        f"losses {losses[::10]}"
    )


def test_fit_recovers_sky():
    """sky_lo / sky_hi ride in DIFF_LEAVES — prove a fit recovers them.
    The sky enters radiance linearly (miss shader + throughput products),
    so this converges fast."""
    truth, _, cam, cfg, key = _setup()
    target = inverse.render_linear(truth, cam, cfg, jax.random.fold_in(key, 999))
    start = truth.replace(
        sky_lo=jnp.asarray([0.9, 0.4, 0.2], jnp.float32),   # sunset instead
        sky_hi=jnp.asarray([0.2, 0.2, 0.7], jnp.float32),
    )
    recovered, losses = inverse.fit(
        start, target, cam, cfg, key, steps=30, lr=5e-2,
        leaves=("sky_lo", "sky_hi"),
    )
    for leaf in ("sky_lo", "sky_hi"):
        err_before = float(jnp.abs(getattr(start, leaf) - getattr(truth, leaf)).mean())
        err_after = float(jnp.abs(getattr(recovered, leaf) - getattr(truth, leaf)).mean())
        assert err_after < err_before * 0.35, (leaf, err_before, err_after, losses[::8])


def test_fit_sharded_recovers_albedo(tmp_path):
    """Multi-chip Adam fit (inverse.fit_sharded) over the 8-device mesh:
    optimizes like the single-device fit and resumes bit-identically from
    a fit-state snapshot."""
    from simplepathtracer_tpu.parallel import make_mesh

    truth, _, cam, cfg, key = _setup()
    target = inverse.render_linear(truth, cam, cfg, jax.random.fold_in(key, 999))
    perturbed = truth.replace(albedo=jnp.clip(truth.albedo + 0.25, 0.05, 0.95))
    mesh = make_mesh(tiles=4, samples=2)

    recovered, losses = inverse.fit_sharded(
        perturbed, target, cam, cfg, key, mesh, steps=15, lr=5e-2,
        leaves=("albedo",),
    )
    assert losses[-1] < losses[0] * 0.6, losses[::4]
    err_before = float(jnp.abs(perturbed.albedo - truth.albedo).mean())
    err_after = float(jnp.abs(recovered.albedo - truth.albedo).mean())
    assert err_after < err_before * 0.7, (err_before, err_after)

    # Snapshot/resume: interrupted-at-8 + resumed must equal uninterrupted.
    snap = str(tmp_path / "sfit.npz")
    inverse.fit_sharded(
        perturbed, target, cam, cfg, key, mesh, steps=8, lr=5e-2,
        leaves=("albedo",), snapshot_path=snap, snapshot_every=8,
    )
    resumed, losses_r = inverse.fit_sharded(
        perturbed, target, cam, cfg, key, mesh, steps=15, lr=5e-2,
        leaves=("albedo",), snapshot_path=snap, snapshot_every=100,
    )
    np.testing.assert_array_equal(
        np.asarray(resumed.albedo), np.asarray(recovered.albedo)
    )
    assert losses_r[8:] == losses[8:]


def test_grad_accum_vjp_linearity():
    """The gradient-accumulated estimator's accumulation is EXACT: with the
    same cotangent, sum_k vjp over disjoint sample groups equals the vjp of
    the full-spp render (linearity of accumulation over sample ids)."""
    import numpy as np

    scene = spt.three_sphere_scene(hollow_glass=False)
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=3)
    key = jax.random.PRNGKey(3)
    params, ss = inverse.split_params(scene)
    ct = jax.random.normal(jax.random.PRNGKey(9), (8, 16, 3), jnp.float32)

    from simplepathtracer_tpu.render import render_sample_batch

    def f_full(p):
        acc = render_sample_batch(
            inverse.merge_params(p, ss), cam, cfg, key, 0, 4
        )
        return acc.reshape(8, 16, 3) / 4.0

    _, pull = jax.vjp(f_full, params)
    g_full = pull(ct)[0]

    def f_group(p, off):
        acc = render_sample_batch(
            inverse.merge_params(p, ss), cam, cfg.replace(spp=2), key, off, 2
        )
        return acc.reshape(8, 16, 3) / 4.0

    g_sum = None
    for off in (0, 2):
        _, pull_k = jax.vjp(lambda p: f_group(p, off), params)
        g = pull_k(ct)[0]
        g_sum = g if g_sum is None else jax.tree.map(
            lambda a, b: a + b, g_sum, g
        )
    for k in g_full:
        np.testing.assert_allclose(
            np.asarray(g_sum[k]), np.asarray(g_full[k]), rtol=1e-5,
            atol=1e-7, err_msg=k,
        )


def test_grad_accum_fit_recovers_albedo():
    """End-to-end: fit(grad_accum=2) optimizes with the independent-pair
    estimator — the path BASELINE config 5's 2000 spp takes on one chip."""
    scene = spt.three_sphere_scene(hollow_glass=False)
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    cfg = spt.RenderConfig(width=24, height=12, spp=8, max_depth=3)
    key = jax.random.PRNGKey(2)
    target = inverse.render_linear(scene, cam, cfg, jax.random.fold_in(key, 9))
    perturbed = scene.replace(albedo=jnp.clip(scene.albedo + 0.25, 0.05, 0.95))
    recovered, losses = inverse.fit(
        perturbed, target, cam, cfg, key, steps=12, lr=5e-2,
        leaves=("albedo",), grad_accum=2,
    )
    assert losses[-1] < losses[0] * 0.7, losses[::4]
    err0 = float(jnp.abs(perturbed.albedo - scene.albedo).mean())
    err1 = float(jnp.abs(recovered.albedo - scene.albedo).mean())
    assert err1 < err0 * 0.7, (err0, err1)


def test_decoupled_loss_value_and_unbiased_gradient():
    """pixel_loss_decoupled (round 5): the VALUE equals the full-spp MSE
    (the stop-gradient identity), and its gradient kills the
    score-residual covariance — at the TRUTH with a same-estimator
    target-free probe, the mean gradient over keys must be consistent
    with zero where the coupled estimator measured a 10-sigma spurious
    z-component (the sphere marched toward the camera under Adam)."""
    truth, _, cam, cfg, key = _setup()
    cfg_soft = cfg.replace(silhouette_softness=0.05)
    target = inverse.render_linear(
        truth, cam, cfg_soft, jax.random.fold_in(key, 999)
    )
    params, ss = inverse.split_params(truth, leaves=("centers",))
    lv_c = float(inverse.pixel_loss(
        params, ss, target, cam, cfg_soft, key, ("centers",)
    ))
    lv_d = float(inverse.pixel_loss_decoupled(
        params, ss, target, cam, cfg_soft, key, ("centers",)
    ))
    # Same (pixel, sample) set, same per-sample values; only the
    # accumulation split differs (two half-range sums vs one scan).
    np.testing.assert_allclose(lv_d, lv_c, rtol=1e-6)

    gfn = jax.jit(jax.grad(inverse.pixel_loss_decoupled),
                  static_argnames=("config", "leaves"))
    gs = np.stack([
        np.asarray(gfn(params, ss, target, cam, cfg_soft,
                       jax.random.PRNGKey(s), ("centers",))["centers"])
        for s in range(24)
    ])
    mean, sem = gs.mean(0), gs.std(0) / np.sqrt(24)
    # Sphere 1's z-component read mean ~7e-3 at sem ~7e-4 with the coupled
    # estimator; decoupled it must be statistically near zero (target
    # noise keeps it from exact zero — allow 3.5 sigma + a small floor).
    z = abs(mean[1, 2])
    assert z < 3.5 * sem[1, 2] + 2e-3, (mean[1], sem[1])
