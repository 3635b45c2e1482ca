"""Scene generators: pure functions ``(key?, **cfg) -> Scene``.

Reference counterparts (include/SceneGenerators.hpp):
  * ``reference_scene``  <- InitSpheres (SceneGenerators.hpp:68-133): ground
    sphere r=1e3 at y=-1000.5 plus a 3x3 grid of r=0.5 spheres, hard-coded
    colors, 2 metal / 1 glass / 6 diffuse.
  * ``random_scene``     <- GenerateSpheres (SceneGenerators.hpp:6-66): huge
    ground sphere + 3 feature spheres + a jittered lattice of small random
    spheres with overlap rejection and a diffuse-biased material draw.
  * ``cover_scene``      — Shirley's "Ray Tracing in One Weekend" cover
    (BASELINE config 3), which the reference's random scene imitates.
  * ``simple_scene`` / ``three_sphere_scene`` — BASELINE configs 1-2.

Unlike the reference these take an explicit PRNG key (the reference seeds a
thread_local engine from the wall clock, include/Random.hpp:40-44) and return
an immutable pytree instead of mutating globals.  Static-shape discipline:
random scenes draw a *fixed-size* sphere pool and mask rejected slots by
moving them far below the ground with radius ~0 (XLA needs static shapes; a
dead sphere that can never be hit is the static-shape analog of pop_back).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .types import Material, Scene

# Reference sky: initColor {137,207,240}/255 scaled by (dir.y+1)/2
# (include/Globals.hpp:29, include/SingleThreadPathTracer.hpp:11-19)
REF_SKY_HI = np.array([137.0, 207.0, 240.0], np.float32) / 255.0
REF_SKY_LO = np.zeros(3, np.float32)
# Shirley sky: lerp(white, (.5,.7,1), (dir.y+1)/2)
SHIRLEY_SKY_LO = np.array([1.0, 1.0, 1.0], np.float32)
SHIRLEY_SKY_HI = np.array([0.5, 0.7, 1.0], np.float32)


def _scene_from_lists(centers, radii, albedo, material, fuzz, ior, sky_lo, sky_hi):
    return Scene(
        centers=jnp.asarray(np.asarray(centers, np.float32)),
        radii=jnp.asarray(np.asarray(radii, np.float32)),
        albedo=jnp.asarray(np.asarray(albedo, np.float32)),
        material=jnp.asarray(np.asarray(material, np.int32)),
        fuzz=jnp.asarray(np.asarray(fuzz, np.float32)),
        ior=jnp.asarray(np.asarray(ior, np.float32)),
        sky_lo=jnp.asarray(sky_lo),
        sky_hi=jnp.asarray(sky_hi),
    )


def simple_scene() -> Scene:
    """BASELINE config 1: one Lambertian sphere + ground sphere."""
    return _scene_from_lists(
        centers=[[0.0, -100.5, 1.0], [0.0, 0.0, 1.0]],
        radii=[100.0, 0.5],
        albedo=[[0.5, 0.5, 0.5], [0.7, 0.3, 0.3]],
        material=[Material.LAMBERTIAN, Material.LAMBERTIAN],
        fuzz=[0.0, 0.0],
        ior=[1.5, 1.5],
        sky_lo=SHIRLEY_SKY_LO,
        sky_hi=SHIRLEY_SKY_HI,
    )


def three_sphere_scene(hollow_glass: bool = True) -> Scene:
    """BASELINE config 2: Lambertian / metal / dielectric trio with optional
    hollow glass via a nested negative-radius sphere."""
    centers = [
        [0.0, -100.5, 1.0],   # ground
        [0.0, 0.0, 1.0],      # center lambertian
        [1.0, 0.0, 1.0],      # right metal
        [-1.0, 0.0, 1.0],     # left glass
    ]
    radii = [100.0, 0.5, 0.5, 0.5]
    albedo = [[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [0.8, 0.6, 0.2], [1.0, 1.0, 1.0]]
    material = [Material.LAMBERTIAN, Material.LAMBERTIAN, Material.METAL, Material.DIELECTRIC]
    fuzz = [0.0, 0.0, 0.2, 0.0]
    ior = [1.5, 1.5, 1.5, 1.5]
    if hollow_glass:
        centers.append([-1.0, 0.0, 1.0])
        radii.append(-0.4)  # negative radius => inward normal => hollow shell
        albedo.append([1.0, 1.0, 1.0])
        material.append(Material.DIELECTRIC)
        fuzz.append(0.0)
        ior.append(1.5)
    return _scene_from_lists(
        centers, radii, albedo, material, fuzz, ior, SHIRLEY_SKY_LO, SHIRLEY_SKY_HI
    )


def reference_scene() -> Scene:
    """The reference's hard-coded REFERENCE scene (SceneGenerators.hpp:68-133).

    Geometry, colors and materials match InitSpheres exactly; fuzz follows
    its deterministic default (g_diffuses[2]=0, others 0.01 before the
    randomized overwrite — we keep the deterministic base so renders are
    reproducible; the reference's randomized fuzz is wall-clock seeded).
    """
    colors = np.array(
        [
            [30, 144, 255], [10, 255, 110], [110, 10, 255], [255, 100, 230],
            [200, 255, 110], [210, 10, 255], [255, 100, 150], [50, 255, 200],
            [10, 210, 255], [255, 100, 220],
        ],
        np.float32,
    ) / 255.0
    centers = np.array(
        [
            [0, -1e3 - 0.5, 0],
            [-1, 0, 0], [0, 0, 0], [1, 0, 0],
            [-1, 1, 0], [0, 1, 0], [1, 1, 0],
            [-1, 2, 0], [0, 2, 0], [1, 2, 0],
        ],
        np.float32,
    )
    radii = np.array([1e3] + [0.5] * 9, np.float32)
    M = Material
    material = [
        M.LAMBERTIAN, M.LAMBERTIAN, M.METAL, M.LAMBERTIAN, M.LAMBERTIAN,
        M.DIELECTRIC, M.LAMBERTIAN, M.LAMBERTIAN, M.METAL, M.LAMBERTIAN,
    ]
    fuzz = np.full(10, 0.01, np.float32)
    fuzz[2] = 0.0  # g_diffuses[2] = 0 (SceneGenerators.hpp:132)
    ior = np.full(10, 1.5, np.float32)  # nGlass (SingleThreadPathTracer.hpp:51)
    return _scene_from_lists(
        centers, radii, colors, material, fuzz, ior, REF_SKY_LO, REF_SKY_HI
    )


def random_scene(key, max_spheres: int = 512) -> Scene:
    """The reference's RANDOM scene (SceneGenerators.hpp:6-66), static-shape.

    Ground sphere r=1e6 + three r=3 feature spheres (glass/metal/diffuse) +
    a z in [0,20) step-1.25 lattice with widening x bound, 50% spawn chance,
    radius U(0.3,0.5), jittered position, overlap rejection against the
    feature spheres.  The reference's material draw
    min(round(U(0.5,6.0)),3) is diffuse-biased (~58% diffuse / 17% glass /
    8% metal, never skybox — SURVEY.md S2); we reproduce that *distribution*
    with the intended material semantics.  Rejected/unspawned lattice slots
    become dead spheres (tiny radius, far below ground) so the sphere count
    is static for XLA.
    """
    ks = jax.random.split(key, 8)
    # -- fixed spheres ----------------------------------------------------
    # Documented divergence: the reference's ground sphere is r=1e6
    # (SceneGenerators.hpp:9-10), but at that radius f32 positions only
    # resolve to ~0.06 units, which shows up as concentric banding on every
    # surface (the reference's own f32/SSE build has the identical limit).
    # r=1e4 is geometrically indistinguishable over the 20-unit scene
    # (sagitta < 5e-3) and resolves to ~1e-3 units — below t_min.
    fixed_centers = np.array(
        [[0, -1e4, 0], [0, 3, 10], [5, 3, 5], [-7, 3, 14]], np.float32
    )
    fixed_radii = np.array([1e4, 3, 3, 3], np.float32)
    fixed_albedo = np.array(
        [[30, 144, 255], [255, 255, 255], [230, 230, 230], [223, 55, 132]],
        np.float32,
    ) / 255.0
    fixed_mat = np.array(
        [Material.LAMBERTIAN, Material.DIELECTRIC, Material.METAL, Material.LAMBERTIAN],
        np.int32,
    )
    fixed_fuzz = np.array([0.0, 0.0, 0.01, 0.0], np.float32)

    # -- lattice (static shape: all candidate slots, masked) --------------
    zs, xs = [], []
    for z in np.arange(0.0, 20.0, 1.25):
        bound = abs(z) * 0.85
        for x in np.arange(-5.0 - bound, 6.0 + bound, 1.25):
            zs.append(z)
            xs.append(x)
    n_slots = len(xs)
    n_rand = max_spheres - len(fixed_radii)
    if n_slots > n_rand:  # keep static budget; truncate farthest slots
        xs, zs = xs[:n_rand], zs[:n_rand]
        n_slots = n_rand
    base_x = jnp.asarray(np.array(xs, np.float32))
    base_z = jnp.asarray(np.array(zs, np.float32))

    spawn = jax.random.uniform(ks[0], (n_slots,)) > 0.5
    radius = jax.random.uniform(ks[1], (n_slots,), minval=0.3, maxval=0.5)
    jitter = jax.random.uniform(ks[2], (n_slots, 2), minval=0.0, maxval=0.3)
    cx = base_x + jitter[:, 0]
    cz = base_z + jitter[:, 1]
    centers = jnp.stack([cx, radius, cz], axis=-1)

    # overlap rejection against the 3 feature spheres (SceneGenerators.hpp:42)
    feat_c = jnp.asarray(fixed_centers[1:])
    feat_r = jnp.asarray(fixed_radii[1:])
    gap = (
        jnp.linalg.norm(centers[:, None, :] - feat_c[None, :, :], axis=-1)
        - radius[:, None]
        - feat_r[None, :]
    )
    ok = jnp.all(gap >= 0.5, axis=-1) & spawn

    albedo = jax.random.uniform(ks[3], (n_slots, 3))
    # material distribution of min(round(U(0.5,6.0)),3): see docstring
    draw = jnp.clip(jnp.round(jax.random.uniform(ks[4], (n_slots,), minval=0.5, maxval=6.0)), 1, 3)
    ref_to_ours = jnp.asarray(
        [Material.LAMBERTIAN, Material.METAL, Material.DIELECTRIC, Material.LAMBERTIAN],
        jnp.int32,
    )
    material = ref_to_ours[draw.astype(jnp.int32)]
    fuzz = jax.random.uniform(ks[5], (n_slots,)) * (jax.random.uniform(ks[6], (n_slots,)) > 0.2)

    # dead spheres for rejected slots: unhittable and harmless
    dead_center = jnp.asarray([0.0, -2e6, 0.0])
    centers = jnp.where(ok[:, None], centers, dead_center)
    radius = jnp.where(ok, radius, 1e-4)

    pad = n_rand - n_slots
    def cat(a, b, pad_val):
        b = jnp.asarray(b)
        if pad > 0:
            pad_shape = (pad,) + b.shape[1:]
            b = jnp.concatenate([b, jnp.full(pad_shape, pad_val, b.dtype)], 0)
        return jnp.concatenate([jnp.asarray(a), b], 0)

    return Scene(
        centers=cat(fixed_centers, centers, -2e6),
        radii=cat(fixed_radii, radius, 1e-4),
        albedo=cat(fixed_albedo, albedo, 0.0),
        material=cat(fixed_mat, material.astype(jnp.int32), 0),
        fuzz=cat(fixed_fuzz, fuzz.astype(jnp.float32), 0.0),
        ior=jnp.full((max_spheres,), 1.5, jnp.float32),
        sky_lo=jnp.asarray(REF_SKY_LO),
        sky_hi=jnp.asarray(REF_SKY_HI),
    )


def cover_scene(key, max_spheres: int = 512) -> Scene:
    """Shirley's cover scene (BASELINE config 3): ground + 3 feature spheres
    + a 22x22 jittered grid of small spheres (diffuse 80% / metal 15% /
    glass 5%), static-shape with dead-sphere masking."""
    ks = jax.random.split(key, 8)
    fixed_centers = np.array(
        [[0, -1000, 0], [0, 1, 0], [-4, 1, 0], [4, 1, 0]], np.float32
    )
    fixed_radii = np.array([1000, 1, 1, 1], np.float32)
    fixed_albedo = np.array(
        [[0.5, 0.5, 0.5], [1, 1, 1], [0.4, 0.2, 0.1], [0.7, 0.6, 0.5]], np.float32
    )
    fixed_mat = np.array(
        [Material.LAMBERTIAN, Material.DIELECTRIC, Material.LAMBERTIAN, Material.METAL],
        np.int32,
    )
    fixed_fuzz = np.zeros(4, np.float32)

    grid = [(a, b) for a in range(-11, 11) for b in range(-11, 11)]
    n_slots = len(grid)  # 484
    n_rand = max_spheres - 4
    grid = grid[:n_rand]
    n_slots = len(grid)
    ga = jnp.asarray(np.array([g[0] for g in grid], np.float32))
    gb = jnp.asarray(np.array([g[1] for g in grid], np.float32))

    jit_xy = jax.random.uniform(ks[0], (n_slots, 2)) * 0.9
    cx = ga + jit_xy[:, 0]
    cz = gb + jit_xy[:, 1]
    centers = jnp.stack([cx, jnp.full_like(cx, 0.2), cz], -1)
    # reject near the big spheres (Shirley: |c - (4,0.2,0)| > 0.9)
    ok = jnp.linalg.norm(centers - jnp.asarray([4.0, 0.2, 0.0]), axis=-1) > 0.9

    mat_draw = jax.random.uniform(ks[1], (n_slots,))
    material = jnp.where(
        mat_draw < 0.8,
        Material.LAMBERTIAN,
        jnp.where(mat_draw < 0.95, Material.METAL, Material.DIELECTRIC),
    ).astype(jnp.int32)
    diff_albedo = jax.random.uniform(ks[2], (n_slots, 3)) * jax.random.uniform(ks[3], (n_slots, 3))
    metal_albedo = jax.random.uniform(ks[4], (n_slots, 3), minval=0.5, maxval=1.0)
    albedo = jnp.where((material == Material.METAL)[:, None], metal_albedo, diff_albedo)
    albedo = jnp.where((material == Material.DIELECTRIC)[:, None], 1.0, albedo)
    fuzz = jax.random.uniform(ks[5], (n_slots,), minval=0.0, maxval=0.5) * (
        material == Material.METAL
    )

    dead_center = jnp.asarray([0.0, -2e6, 0.0])
    centers = jnp.where(ok[:, None], centers, dead_center)
    radius = jnp.where(ok, 0.2, 1e-4)

    pad = n_rand - n_slots
    def cat(a, b, pad_val):
        b = jnp.asarray(b)
        if pad > 0:
            pad_shape = (pad,) + b.shape[1:]
            b = jnp.concatenate([b, jnp.full(pad_shape, pad_val, b.dtype)], 0)
        return jnp.concatenate([jnp.asarray(a), b], 0)

    return Scene(
        centers=cat(fixed_centers, centers, -2e6),
        radii=cat(fixed_radii, radius, 1e-4),
        albedo=cat(fixed_albedo, albedo, 0.0),
        material=cat(fixed_mat, material, 0),
        fuzz=cat(fixed_fuzz, fuzz, 0.0),
        ior=jnp.full((max_spheres,), 1.5, jnp.float32),
        sky_lo=jnp.asarray(SHIRLEY_SKY_LO),
        sky_hi=jnp.asarray(SHIRLEY_SKY_HI),
    )


def with_ground_plane(
    scene: Scene,
    normal=(0.0, 1.0, 0.0),
    point=(0.0, -0.5, 0.0),
    albedo=(246 / 255.0, 219 / 255.0, 219 / 255.0),
) -> Scene:
    """Attach a Lambertian infinite plane to a scene.

    Defaults are the reference's (dead) plane constants: planeNormal
    {0,1,0}, planePoint {0,-0.5,0}, planeColor {246,219,219}
    (include/Globals.hpp:26-28).  The plane is live in every path: the jnp
    bounce (forward and gradient) and the forward kernel, where it costs
    about one extra sphere per scan.

    An infinite plane is better-conditioned than the radius-1e3/1e6 ground
    spheres the reference actually uses (SceneGenerators.hpp:84, 9-10): no
    catastrophic cancellation in r^2 - |oc|^2 at grazing distance.
    """
    n = jnp.asarray(normal, jnp.float32)
    n = n / jnp.linalg.norm(n)
    k = -jnp.dot(n, jnp.asarray(point, jnp.float32))
    plane7 = jnp.concatenate(
        [n, jnp.reshape(k, (1,)), jnp.asarray(albedo, jnp.float32)]
    )
    return scene.replace(plane=plane7)


def compact_scene(scene: Scene, pad_multiple: int = 4) -> Scene:
    """Drop dead padding slots (host-side, eager arrays only).

    Random scene generators keep a static sphere budget and mask rejected
    slots as unhittable dead spheres (tiny radius far below the ground).
    Every scan is O(total slots), so trimming the ~5% dead slots is free
    throughput.  The live set is unchanged, so the image is identical up
    to argmin tie order.  Pads the live count up to ``pad_multiple`` with
    one repeated dead slot.
    """
    radii = np.asarray(scene.radii)
    centers = np.asarray(scene.centers)
    live = (np.abs(radii) > 1e-3) & (centers[:, 1] > -1e6)
    order = np.argsort(~live, kind="stable")  # live first, original order
    n_live = int(live.sum())
    n_keep = -(-max(n_live, 1) // pad_multiple) * pad_multiple
    keep = order[:n_keep]
    return scene.replace(
        centers=jnp.asarray(centers[keep]),
        radii=jnp.asarray(radii[keep]),
        albedo=jnp.asarray(np.asarray(scene.albedo)[keep]),
        material=jnp.asarray(np.asarray(scene.material)[keep]),
        fuzz=jnp.asarray(np.asarray(scene.fuzz)[keep]),
        ior=jnp.asarray(np.asarray(scene.ior)[keep]),
    )


SCENES = {
    "simple": lambda key=None, **kw: simple_scene(),
    "three_sphere": lambda key=None, **kw: three_sphere_scene(**kw),
    "reference": lambda key=None, **kw: reference_scene(),
    "random": lambda key=None, **kw: random_scene(key if key is not None else jax.random.PRNGKey(0), **kw),
    "cover": lambda key=None, **kw: cover_scene(key if key is not None else jax.random.PRNGKey(0), **kw),
}
