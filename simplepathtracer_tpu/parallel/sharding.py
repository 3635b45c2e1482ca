"""Multi-device rendering: device meshes, sharded render, sharded train step.

Reference counterpart: the tile scheduler + thread pool
(include/Renderer.hpp:257-302) — the reference splits the image into
threadCount^2 tiles and fans them out over detached std::threads throttled by
an atomic counter + condition_variable, writing into one shared framebuffer.
Here the form is SPMD: a 2-D ``jax.sharding.Mesh`` with axes

    ("tiles", "samples")

where image pixels are sharded along ``tiles`` and samples-per-pixel along
``samples``.  Scene/camera parameters are replicated (they are tiny), the
partial sample accumulations are combined with ``lax.psum`` over the
``samples`` axis, and the output image stays sharded over ``tiles``.  The
cards of one host are joined all to all, so the mesh shape follows the
algorithm: any split of devices between the axes costs the same links.  There is no shared-mutable framebuffer and no throttling — XLA
schedules the SPMD program; the condvar dance has no equivalent because it
solved a problem (oversubscription of a shared CPU) that the mesh does not
have.

Determinism: every random number is keyed by global (pixel, sample) ids
(ops/sampling.py), so the sharded render is bit-identical to the
single-device render for any mesh shape — asserted by
tests/test_sharding.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..render import grad_safe_config, render_pixel_block
from ..types import Camera, RenderConfig, Scene

# jax>=0.6 exposes shard_map at top level; keep a fallback for older trees.
try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def make_mesh(tiles: int | None = None, samples: int = 1, devices=None) -> Mesh:
    """Build a ('tiles', 'samples') mesh over the available devices.

    With ``tiles=None`` all devices not used by ``samples`` go to the tile
    axis.  The per-step collective is the sample-axis psum.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if tiles is None:
        assert n % samples == 0, f"{n} devices not divisible by samples={samples}"
        tiles = n // samples
    assert tiles * samples == n, f"mesh {tiles}x{samples} != {n} devices"
    import numpy as np

    dev_array = np.asarray(devices).reshape(tiles, samples)
    return Mesh(dev_array, ("tiles", "samples"))


def _block_sizes(config: RenderConfig, mesh: Mesh):
    nt, ns = mesh.shape["tiles"], mesh.shape["samples"]
    p_total = config.num_pixels
    assert p_total % nt == 0, f"{p_total} pixels not divisible by tiles={nt}"
    assert config.spp % ns == 0, f"{config.spp} spp not divisible by samples={ns}"
    return p_total // nt, config.spp // ns


def render_accum_sharded(
    scene: Scene, camera: Camera, config: RenderConfig, key, mesh: Mesh,
    sample_offset: int = 0, n_samples: int | None = None,
):
    """Sharded radiance accumulation: returns [P, 3] radiance *sum* over
    ``n_samples`` spp (default all of config.spp), laid out sharded over the
    ``tiles`` mesh axis.

    Each (tile, sample) shard renders its pixel block for its sample slice;
    the sample axis is reduced with ``psum`` so every tile shard holds the
    full-spp sum for its pixels.  ``sample_offset`` continues the global
    sample-id sequence — the resume hook for sharded checkpointing
    (checkpoint.save_sharded): because all randomness is keyed by global
    (pixel, sample) ids, accumulating [0, k) then [k, spp) is bit-identical
    to one [0, spp) pass.
    """
    if n_samples is None:
        n_samples = config.spp
    p_local, _ = _block_sizes(config, mesh)
    ns = mesh.shape["samples"]
    assert n_samples % ns == 0, f"{n_samples} spp not divisible by samples={ns}"
    s_local = n_samples // ns

    def body(scene, camera, key):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("samples")
        pixel_ids = ti * p_local + jnp.arange(p_local, dtype=jnp.int32)
        acc = render_pixel_block(
            scene, camera, config, key, pixel_ids,
            sample_offset + si * s_local, s_local,
        )
        return jax.lax.psum(acc, "samples")

    # check_vma must be off for the forward kernel: the Pallas interpreter
    # (CPU tests) evaluates the kernel jaxpr without replaying the implicit
    # varying-axis casts, tripping the checker.  Forward rendering has no
    # transpose, so the check adds no safety here; the gradient path
    # (loss_and_grad_sharded) keeps the jnp bounce and full checking.
    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P("tiles"),
        check_vma=not config.use_pallas,
    )
    return f(scene, camera, key)


@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def render_sharded(scene: Scene, camera: Camera, config: RenderConfig, key, mesh: Mesh):
    """Sharded one-shot render -> [H, W, 3] gamma-corrected image in [0, 1]."""
    acc = render_accum_sharded(scene, camera, config, key, mesh)
    img = (acc / config.spp).reshape(config.height, config.width, 3)
    return jnp.clip(img, 0.0, 1.0) ** (1.0 / config.gamma)


# ---------------------------------------------------------------------------
# Differentiable sharded step (the "training step" of this framework:
# one inverse-rendering gradient step on scene parameters).
# ---------------------------------------------------------------------------

_DIFF_LEAVES = (
    "centers", "radii", "albedo", "fuzz", "ior", "sky_lo", "sky_hi", "plane",
)


def split_scene(scene: Scene):
    """Split a Scene into (differentiable params dict, static remainder).

    Leaves the scene doesn't carry (plane=None on sphere-only scenes) are
    dropped so the params dict stays a pure-array pytree.
    """
    params = {
        k: v for k in _DIFF_LEAVES if (v := getattr(scene, k)) is not None
    }
    return params, scene


def merge_scene(params, scene: Scene) -> Scene:
    return scene.replace(**params)


def loss_and_grad_sharded(
    scene: Scene, target, camera: Camera, config: RenderConfig, key, mesh: Mesh
):
    """Sharded pixel-MSE loss + gradient w.r.t. differentiable scene leaves.

    ``target``: [H, W, 3] *linear* radiance target (pre-gamma).  Loss is the
    mean squared error of the per-pixel sample-mean radiance.  Parameter
    gradients from every (tile, sample) shard are combined by the psum
    autodiff inserts over both mesh axes (scene params are replicated).

    The config is downgraded via ``grad_safe_config``: the forward kernel
    cannot be differentiated, so presets with ``use_pallas=True`` switch
    to the jnp bounce here instead of crashing inside shard_map.
    """
    config = grad_safe_config(config)
    p_local, s_local = _block_sizes(config, mesh)
    p_total = config.num_pixels
    inv_spp = 1.0 / config.spp

    def body(scene, camera, key, target_local):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("samples")
        pixel_ids = ti * p_local + jnp.arange(p_local, dtype=jnp.int32)
        params, rest = split_scene(scene)

        def local_loss(params):
            sc = merge_scene(params, rest)
            acc = render_pixel_block(
                sc, camera, config, key, pixel_ids, si * s_local, s_local
            )
            # Cross-sample mean must happen before squaring: psum over the
            # sample axis inside the differentiated function.
            mean = jax.lax.psum(acc, "samples") * inv_spp
            return jnp.sum((mean - target_local) ** 2) / (p_total * 3)

        loss, grads = jax.value_and_grad(local_loss)(params)
        # loss is sample-invariant already (psum inside); tiles contribute
        # disjoint pixels, so sum them.  Gradients are w.r.t. the *replicated*
        # (unvarying) params, so autodiff already inserted the psum over both
        # mesh axes when transposing the implicit broadcast — no explicit
        # all-reduce needed (adding one would multiply by the shard count).
        loss = jax.lax.psum(loss, "tiles")
        return loss, grads

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("tiles")),
        out_specs=(P(), P()),
    )
    target_flat = target.reshape(p_total, 3)
    return f(scene, camera, key, target_flat)


@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def train_step_sharded(
    scene: Scene,
    target,
    camera: Camera,
    config: RenderConfig,
    key,
    mesh: Mesh,
    lr=1e-2,
):
    """One SGD step on the differentiable scene leaves. Returns (scene, loss).

    This is the full distributed "training step" of the framework: sharded
    forward render, sharded backward bounce scan (rematerialized per bounce
    via jax.checkpoint), psum gradient all-reduce, replicated update.
    """
    loss, grads = loss_and_grad_sharded(scene, target, camera, config, key, mesh)
    params, rest = split_scene(scene)
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return merge_scene(new_params, rest), loss
