"""Inverse rendering: recover scene parameters from a target image.

BASELINE.json configs[3]: "recover sphere positions/albedos from target
image via pixel-loss gradients".  The reference has no analog (it is not
differentiable); this module is the capability this build adds on top —
the whole render is a pure function of the Scene pytree, so
``jax.value_and_grad`` of a pixel loss w.r.t. scene leaves flows through the
bounce scan (rematerialized per bounce via jax.checkpoint), the
reparameterized hit point, and the throughput products (SURVEY.md S7
stages 4).

Discrete structure (hit selection, material switch, Schlick coin flips) is
treated as locally constant — standard score-free reparameterization; see
ops/intersect.py and ops/materials.py for the detach points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .render import grad_safe_config, kernel_available, render_sample_batch
from .types import Camera, RenderConfig, Scene

# Leaves that receive gradients (same set as parallel/sharding.py).
# ``plane`` is the optional [7] ground plane (None on sphere-only scenes —
# None is an empty pytree, so it is harmless in params dicts/optimizers);
# only its offset + albedo (entries 3:7) receive gradients, the unit
# normal is structurally detached in every path.
DIFF_LEAVES = (
    "centers", "radii", "albedo", "fuzz", "ior", "sky_lo", "sky_hi", "plane",
)


def split_params(scene: Scene, leaves=DIFF_LEAVES):
    # Leaves the scene doesn't carry (plane=None on sphere-only scenes) are
    # dropped so params dicts stay pure-array pytrees everywhere.
    params = {
        k: v for k in leaves if (v := getattr(scene, k)) is not None
    }
    return params, scene


def merge_params(params, scene: Scene) -> Scene:
    return scene.replace(**params)


def render_linear(scene, camera, config, key):
    """Sample-mean *linear* radiance image [H, W, 3] (pre-gamma) — the
    quantity losses are defined on."""
    acc = render_sample_batch(scene, camera, config, key, 0, config.spp)
    return (acc / config.spp).reshape(config.height, config.width, 3)


def pixel_loss(params, static_scene, target, camera, config, key, leaves=DIFF_LEAVES):
    """Mean squared error in linear radiance.

    Always differentiable: ``grad_safe_config`` swaps a forward-kernel
    ``use_pallas`` preset for the jnp bounce.
    """
    config = grad_safe_config(config)
    scene = merge_params(params, static_scene)
    img = render_linear(scene, camera, config, key)
    return jnp.mean((img - target) ** 2)


def pixel_loss_decoupled(params, static_scene, target, camera, config, key,
                         leaves=DIFF_LEAVES):
    """MSE whose VALUE is the full-spp render's but whose GRADIENT is the
    independent-pair estimator: residual from the first half of the sample
    range (detached), pullback through the second half.

    Why: the two-sided silhouette estimator's REINFORCE score terms share
    their acceptance coins with the image the residual is built from, so
    plain value_and_grad(pixel_loss) differentiates MSE-of-means PLUS the
    theta-dependent sample variance — measured as a ~10-sigma spurious
    z-gradient at the truth for an 8-spp fit (the sphere drifts toward the
    camera).  Splitting the sample range decorrelates residual and score,
    E[ct . grad] factorizes, and the bias term vanishes — same trick as
    make_accum_grad_step, at unchanged per-step cost (half the samples
    render forward-only).  Used by ``fit`` whenever softness > 0.
    """
    config = grad_safe_config(config)
    scene = merge_params(params, static_scene)
    spp = int(config.spp)
    h = max(spp // 2, 1)
    sg = jax.lax.stop_gradient
    sgscene = jax.tree.map(sg, scene)
    acc_a = render_sample_batch(sgscene, camera, config, key, 0, h)
    acc_b = render_sample_batch(scene, camera, config, key, h, spp - h)
    t = target.reshape(-1, 3)
    img = (acc_a + acc_b) / spp
    value = jnp.mean((img - t) ** 2)
    resid = sg(2.0 * (acc_a / h - t) / t.size)
    gterm = jnp.sum(resid * acc_b) / (spp - h)
    # Value is exactly the full-spp MSE; gradient is d gterm only.
    return sg(value - gterm) + gterm


def make_accum_grad_step(static_scene, target, camera, config,
                         n_groups: int):
    """Gradient-accumulated loss/grad for spp beyond one dispatch's budget.

    For very high spp (e.g. BASELINE config 5's 2000 on a single card) a
    monolithic ``value_and_grad`` rematerializes every chunk in one
    program.  This splits the work at the OPTIMIZER level with the
    independent-pair estimator:

      * one fast FORWARD-ONLY render of all spp (the forward kernel if
        the preset uses it) produces the image and the pixel cotangent
        ct = 2 (img - target) / N, with an INDEPENDENT key;
      * the gradient is assembled as sum_k vjp_k(ct) over ``n_groups``
        disjoint sample ranges, each its own jitted call (one group's
        residuals alive at a time).

    Because the residual factor (img - target) and the differentiated
    factor use independent samples, E[ct . grad_k] factorizes — this is
    UNBIASED for the true objective grad E[img], and in fact drops the
    per-batch variance-gradient term the naive single-sample-set MSE
    estimator carries.  Values are NOT bitwise comparable to pixel_loss
    (different estimator, same minimizer); linearity of the vjp
    accumulation IS exact and tested.

    Returns ``step(params, key) -> (loss, grads)``.
    """
    import functools as _ft

    gcfg = grad_safe_config(config)
    assert config.spp % n_groups == 0, (config.spp, n_groups)
    sub_spp = config.spp // n_groups
    # The value-pass image must see the SAME estimator as the gradient
    # groups: the forward-only kernel ignores soft silhouettes, so soft
    # configs (and backends without the kernel) take the jnp forward.
    fwd_cfg = (
        config
        if config.use_pallas and kernel_available(config)
        and config.silhouette_softness == 0.0
        else gcfg
    )

    @_ft.partial(jax.jit, static_argnames=())
    def _fwd_image(params, key):
        scene = merge_params(params, static_scene)
        return render_linear(scene, camera, fwd_cfg, key)

    @jax.jit
    def _group_grad(params, ct, key, offset):
        def f(p):
            scene = merge_params(p, static_scene)
            acc = render_sample_batch(
                scene, camera, gcfg.replace(spp=sub_spp), key, offset,
                sub_spp,
            )
            return acc.reshape(target.shape) / config.spp

        _, pull = jax.vjp(f, params)
        return pull(ct)[0]

    def step(params, key):
        img = _fwd_image(params, jax.random.fold_in(key, 7777))
        loss = jnp.mean((img - target) ** 2)
        ct = 2.0 * (img - target) / float(np.prod(target.shape))
        grads = None
        for k in range(n_groups):
            g = _group_grad(params, ct, key, k * sub_spp)
            grads = g if grads is None else jax.tree.map(
                lambda a, b: a + b, grads, g
            )
        return loss, grads

    return step


# Camera leaves that receive gradients under fit_camera (round 5): the
# pose + intrinsics the VERDICT names.  vup stays fixed (a unit-ish
# reference direction; optimizing it without a norm constraint drifts),
# aperture/focus_dist are available but off by default (their loss signal
# is defocus blur, which MC noise swamps at fit scale).
CAMERA_LEAVES = ("origin", "lookat", "vfov_deg")


def split_camera(camera: Camera, leaves=CAMERA_LEAVES):
    return {k: getattr(camera, k) for k in leaves}, camera


def merge_camera(params, camera: Camera) -> Camera:
    return camera.replace(**params)


def camera_pixel_loss(cam_params, camera0, scene, target, config, key,
                      decoupled=False):
    """MSE in linear radiance as a function of CAMERA parameters.

    Camera gradients flow through the differentiable ray generation
    (camera.generate_rays) into the jnp bounce.  With ``decoupled`` (soft
    configs) the gradient uses the independent-pair estimator, same
    rationale as pixel_loss_decoupled.
    """
    config = grad_safe_config(config)
    camera = merge_camera(cam_params, camera0)
    if not decoupled:
        acc = render_sample_batch(scene, camera, config, key, 0, config.spp)
        img = (acc / config.spp).reshape(target.shape)
        return jnp.mean((img - target) ** 2)
    spp = int(config.spp)
    h = max(spp // 2, 1)
    sg = jax.lax.stop_gradient
    cam_sg = jax.tree.map(sg, camera)
    acc_a = render_sample_batch(scene, cam_sg, config, key, 0, h)
    acc_b = render_sample_batch(scene, camera, config, key, h, spp - h)
    t = target.reshape(-1, 3)
    img = (acc_a + acc_b) / spp
    value = jnp.mean((img - t) ** 2)
    resid = sg(2.0 * (acc_a / h - t) / t.size)
    gterm = jnp.sum(resid * acc_b) / (spp - h)
    return sg(value - gterm) + gterm


def fit_camera(
    scene: Scene,
    target,
    camera_init: Camera,
    config: RenderConfig,
    key,
    steps: int = 100,
    lr: float = 1e-2,
    leaves=CAMERA_LEAVES,
    callback=None,
    softness: float = 0.02,
):
    """Adam-optimize camera pose/intrinsics against a target image
    (pose recovery — the camera-side counterpart of ``fit``).

    ``softness`` enables the two-sided silhouette estimator: a camera
    move shifts every silhouette, and for sky-lit Lambertian scenes the
    edges carry most of the pose signal (interior shading is nearly
    view-independent).  Soft-to-soft objective + decoupled-residual
    gradient, like scene-geometry fits.  Returns (camera, losses).
    """
    opt = make_optimizer(lr)
    params, camera0 = split_camera(camera_init, leaves)
    opt_state = opt.init(params)
    if softness:
        config = config.replace(silhouette_softness=float(softness))
    decoupled = config.silhouette_softness > 0.0

    @jax.jit
    def step_fn(params, opt_state, step_key):
        loss, grads = jax.value_and_grad(camera_pixel_loss)(
            params, camera0, scene, target, config, step_key,
            decoupled=decoupled,
        )
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    losses = []
    for i in range(steps):
        params, opt_state, loss = step_fn(
            params, opt_state, jax.random.fold_in(key, i)
        )
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1], params)
    return merge_camera(params, camera0), losses


class InverseState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    step: jax.Array


def make_optimizer(lr: float = 1e-2):
    return optax.adam(lr)


def init(scene: Scene, lr: float = 1e-2, leaves=DIFF_LEAVES) -> InverseState:
    params, _ = split_params(scene, leaves)
    opt = make_optimizer(lr)
    return InverseState(params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))


def _save_fit_state(path, params, opt_state, step, losses):
    """Atomic snapshot of an in-progress fit (np.savez + rename)."""
    import os

    import numpy as np

    leaves_flat, _ = jax.tree.flatten((params, opt_state))
    tmp = f"{path}.tmp-{os.getpid()}"  # np.savez appends .npz
    np.savez(
        tmp,
        version=np.int64(1),
        step=np.int64(step),
        losses=np.asarray(losses, np.float64),
        n_leaves=np.int64(len(leaves_flat)),
        **{f"leaf{i}": np.asarray(x) for i, x in enumerate(leaves_flat)},
    )
    os.replace(tmp + ".npz", path)


def _load_fit_state(path, params_template, opt_state_template):
    """Restore (params, opt_state, step, losses) from a fit snapshot.

    The pytree structure is rebuilt from templates (a fresh split_params +
    opt.init), so only array leaves live in the file — same recipe as
    checkpoint.py's full-config serialization.
    """
    import numpy as np

    with np.load(path) as z:
        version = int(z["version"])
        if version != 1:
            raise ValueError(
                f"unsupported fit snapshot version {version} in {path!r} "
                "(expected 1) — stale or corrupt snapshot; delete it to "
                "start the fit fresh"
            )
        n = int(z["n_leaves"])
        flat = [jnp.asarray(z[f"leaf{i}"]) for i in range(n)]
        step = int(z["step"])
        losses = [float(x) for x in z["losses"]]
    treedef = jax.tree.structure((params_template, opt_state_template))
    params, opt_state = jax.tree.unflatten(treedef, flat)
    return params, opt_state, step, losses


def fit(
    scene_init: Scene,
    target,
    camera: Camera,
    config: RenderConfig,
    key,
    steps: int = 100,
    lr: float = 1e-2,
    leaves=DIFF_LEAVES,
    callback=None,
    softness: float = 0.02,
    param_mask=None,
    snapshot_path=None,
    snapshot_every: int = 0,
    grad_accum: int = 0,
):
    """Adam-optimize the scene's differentiable leaves against a target.

    ``grad_accum=K > 0`` switches each step to the gradient-accumulated
    independent-pair estimator (make_accum_grad_step): one fast forward of
    all spp for the image/cotangent, then K disjoint-sample vjp calls — for
    spp beyond what one dispatch should hold (BASELINE config 5 on a
    single card).

    Each step uses a fresh base key so gradient noise is decorrelated across
    steps (stochastic gradient over path samples).  ``softness`` enables the
    first-bounce soft-silhouette blend (render.py) so geometry parameters
    receive visibility gradients; for geometry fits, render the target with
    the same softness (soft-to-soft) and anneal toward 0 — a hard target
    against a soft render biases the objective at every silhouette.

    ``param_mask``: optional dict {leaf: 0/1 array} freezing entries (e.g.
    freeze the ground sphere while recovering object positions).  Frozen
    entries matter because Adam's RMS normalization turns Monte-Carlo
    gradient noise on otherwise-converged parameters into O(lr) random
    walks.  Returns (scene, losses list).

    ``snapshot_path`` + ``snapshot_every``: checkpoint/resume for the
    optimization loop — the training-step analog of checkpoint.py's render
    snapshots.  Every N steps the (params, Adam state, step, losses) are
    written atomically; if the file already exists when fit() starts, the
    run resumes from it.  Resume is BIT-IDENTICAL to an uninterrupted run:
    step keys are fold_in(key, i), independent of history (tested in
    tests/test_inverse.py).
    """
    import os
    opt = make_optimizer(lr)
    params, static_scene = split_params(scene_init, leaves)
    opt_state = opt.init(params)
    if softness and any(k in leaves for k in ("centers", "radii", "plane")):
        config = config.replace(silhouette_softness=float(softness))
    accum_step = (
        make_accum_grad_step(static_scene, target, camera, config, grad_accum)
        if grad_accum else None
    )

    # Soft (two-sided stochastic-transparency) objectives use the
    # decoupled-residual gradient: see pixel_loss_decoupled.
    loss_impl = (
        pixel_loss_decoupled if config.silhouette_softness > 0.0
        else pixel_loss
    )

    @jax.jit
    def step_fn(params, opt_state, step_key):
        loss, grads = jax.value_and_grad(loss_impl)(
            params, static_scene, target, camera, config, step_key, leaves,
        )
        if param_mask is not None:
            grads = {
                k: g * param_mask[k] if k in param_mask else g
                for k, g in grads.items()
            }
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if param_mask is not None:
            params = {
                k: jnp.where(param_mask[k] > 0, p, getattr(scene_init, k))
                if k in param_mask else p
                for k, p in params.items()
            }
        return params, opt_state, loss

    @jax.jit
    def apply_fn(params, opt_state, grads):
        if param_mask is not None:
            grads = {
                k: g * param_mask[k] if k in param_mask else g
                for k, g in grads.items()
            }
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if param_mask is not None:
            params = {
                k: jnp.where(param_mask[k] > 0, p, getattr(scene_init, k))
                if k in param_mask else p
                for k, p in params.items()
            }
        return params, opt_state

    losses = []
    start = 0
    if snapshot_path and os.path.exists(snapshot_path):
        params, opt_state, start, losses = _load_fit_state(
            snapshot_path, params, opt_state
        )
    for i in range(start, steps):
        if accum_step is not None:
            loss, grads = accum_step(params, jax.random.fold_in(key, i))
            params, opt_state = apply_fn(params, opt_state, grads)
        else:
            params, opt_state, loss = step_fn(
                params, opt_state, jax.random.fold_in(key, i)
            )
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1], params)
        if snapshot_path and snapshot_every and (i + 1) % snapshot_every == 0:
            _save_fit_state(snapshot_path, params, opt_state, i + 1, losses)
    return merge_params(params, static_scene), losses


def fit_sharded(  # noqa: C901
    scene_init: Scene,
    target,
    camera: Camera,
    config: RenderConfig,
    key,
    mesh,
    steps: int = 100,
    lr: float = 1e-2,
    leaves=DIFF_LEAVES,
    callback=None,
    param_mask=None,
    snapshot_path=None,
    snapshot_every: int = 0,
):
    """Multi-device Adam fit: the distributed training loop of this framework.

    Each step runs ``parallel.sharding.loss_and_grad_sharded`` — sharded
    forward render over the ('tiles', 'samples') mesh, sharded backward
    bounce, psum gradient all-reduce — then a replicated Adam update.
    Because loss/grads are replicated outputs, every process holds
    identical optimizer state, so multi-host fits need no extra
    synchronization; snapshots use the same fit-state format as ``fit``
    and are written by PROCESS 0 ONLY (the state is replicated; concurrent
    writers to one shared-storage path could collide on the temp file).
    Every process loads the same path on resume — atomic rename means a
    reader never sees a partial file.

    Reference counterpart: none (the reference has no training loop); this
    is BASELINE.json config 4 scaled to the mesh.
    """
    import os

    from .parallel.sharding import loss_and_grad_sharded

    opt = make_optimizer(lr)
    params, static_scene = split_params(scene_init, leaves)
    opt_state = opt.init(params)
    config = grad_safe_config(config)

    @functools.partial(jax.jit, static_argnames=())
    def step_fn(params, opt_state, step_key):
        scene = merge_params(params, static_scene)
        loss, grads = loss_and_grad_sharded(
            scene, target, camera, config, step_key, mesh
        )
        grads = {k: grads[k] for k in params}
        if param_mask is not None:
            grads = {
                k: g * param_mask[k] if k in param_mask else g
                for k, g in grads.items()
            }
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    losses = []
    start = 0
    if snapshot_path and os.path.exists(snapshot_path):
        params, opt_state, start, losses = _load_fit_state(
            snapshot_path, params, opt_state
        )
    for i in range(start, steps):
        params, opt_state, loss = step_fn(
            params, opt_state, jax.random.fold_in(key, i)
        )
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1], params)
        if (
            snapshot_path and snapshot_every
            and (i + 1) % snapshot_every == 0
            and jax.process_index() == 0
        ):
            _save_fit_state(snapshot_path, params, opt_state, i + 1, losses)
    return merge_params(params, static_scene), losses
