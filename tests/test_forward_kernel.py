"""The GPU forward kernel (ops/pallas_forward.py) in interpret mode against
the jnp wavefront.

Both paths draw the same counter-based random numbers, so radiance agrees
sample for sample up to floating-point reassociation; a pixel differs by
more than that only where an fp difference flips a grazing hit (the jnp
scan builds the discriminant from matmuls, the kernel per sphere), and a
flip changes that sample's whole path.  At these tiny sizes one flipped
sample moves the image mean more than all the reassociation noise, so the
bound is on pixels: under 2% of them differ by more than 1e-4.  A kernel
fault moves most pixels.  The compiled kernel is checked on the card by
tests/test_gpu_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplepathtracer_tpu as spt
from simplepathtracer_tpu.ops import pallas_forward as pf
from simplepathtracer_tpu.render import _render_block_pallas, render_sample_batch

_CAM_TRIO = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90)


def _scene(name):
    if name == "spheres":
        return spt.three_sphere_scene(hollow_glass=False), spt.make_camera(**_CAM_TRIO)
    if name == "hollow_glass":
        return spt.three_sphere_scene(hollow_glass=True), spt.make_camera(**_CAM_TRIO)
    if name == "plane":
        return (spt.with_ground_plane(spt.three_sphere_scene(hollow_glass=True)),
                spt.make_camera(**_CAM_TRIO))
    if name == "reference":
        return spt.reference_scene(), spt.make_camera(
            origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90)
    if name == "defocus":
        return (spt.compact_scene(spt.cover_scene(jax.random.PRNGKey(0),
                                                  max_spheres=48)),
                spt.make_camera(origin=(13, 2, 3), lookat=(0, 0, 0),
                                vfov_deg=20, aperture=0.1, focus_dist=10.0))
    raise ValueError(name)


def _compare(scene, cam, cfg, key, offset=0, n=None):
    n = n or cfg.spp
    a = np.asarray(render_sample_batch(
        scene, cam, cfg.replace(use_pallas=True, pallas_interpret=True), key,
        offset, n))
    b = np.asarray(render_sample_batch(scene, cam, cfg, key, offset, n))
    assert np.isfinite(a).all()
    _assert_close(a, b, n)
    return a


def _assert_close(a, b, n):
    px = (np.abs(a - b) / n).max(axis=-1)
    assert (px > 1e-4).mean() < 0.02, np.sort(px)[-8:]


@pytest.mark.parametrize("rr", [0, 2], ids=["rr_off", "rr_on"])
@pytest.mark.parametrize(
    "name", ["spheres", "hollow_glass", "plane", "reference", "defocus"])
def test_kernel_matches_jnp(name, rr):
    scene, cam = _scene(name)
    cfg = spt.RenderConfig(width=24, height=16, spp=3, max_depth=6,
                           rr_start_depth=rr)
    _compare(scene, cam, cfg, jax.random.PRNGKey(2))


@pytest.mark.parametrize("depth", [1, 2])
def test_kernel_matches_jnp_shallow(depth):
    """Depth budgets of one and two bounces: the lane's sample ends exactly
    where the jnp scan stops."""
    scene, cam = _scene("plane")
    cfg = spt.RenderConfig(width=16, height=8, spp=3, max_depth=depth)
    _compare(scene, cam, cfg, jax.random.PRNGKey(5))


def test_pack_params_plane_slots():
    """The plane's seven numbers sit in the parameter block; a scene
    without a plane leaves them zero."""
    scene, cam = _scene("plane")
    prm = np.asarray(pf.pack_params(scene, cam, 8, 4))
    np.testing.assert_array_equal(prm[pf._PLANE:pf._PLANE + 7],
                                  np.asarray(scene.plane))
    prm0 = np.asarray(pf.pack_params(scene.replace(plane=None), cam, 8, 4))
    assert not prm0[pf._PLANE:pf._PLANE + 7].any()


def test_kernel_pixel_count_not_multiple_of_block():
    """231 pixels: the last block's padding lanes start finished and their
    outputs are dropped."""
    scene, cam = _scene("plane")
    cfg = spt.RenderConfig(width=33, height=7, spp=2, max_depth=5)
    assert cfg.num_pixels % pf.BLOCK
    _compare(scene, cam, cfg, jax.random.PRNGKey(4))


def test_kernel_nonzero_sample_offset():
    """Sample ids continue from the offset: samples [5, 8) of the kernel
    equal the jnp path's, and differ from samples [0, 3)."""
    scene, cam = _scene("hollow_glass")
    cfg = spt.RenderConfig(width=16, height=8, spp=3, max_depth=5)
    key = jax.random.PRNGKey(6)
    a = _compare(scene, cam, cfg, key, offset=5)
    b = np.asarray(render_sample_batch(
        scene, cam, cfg.replace(use_pallas=True, pallas_interpret=True), key,
        0, 3))
    assert np.abs(a - b).mean() > 1e-3


def test_kernel_iteration_counts():
    """Per-pixel loop iterations lie in [spp, spp * max_depth]; sky pixels
    (straight up, no sphere) cost exactly one iteration per sample."""
    scene = spt.three_sphere_scene(hollow_glass=True)
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 5, 1), vfov_deg=30)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=6,
                           pallas_interpret=True, use_pallas=True)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    rad, counts = _render_block_pallas(scene, cam, cfg, jax.random.PRNGKey(0),
                                       pix, 0, 4)
    c = np.asarray(counts)
    assert rad.shape == (cfg.num_pixels, 3) and c.shape == (cfg.num_pixels,)
    assert (c >= 4).all() and (c <= 4 * cfg.max_depth).all()
    assert (c == 4).any()


def test_kernel_permuted_pixel_order():
    """The kernel renders any pixel order: values follow the pixel ids."""
    scene, cam = _scene("plane")
    cfg = spt.RenderConfig(width=16, height=8, spp=2, max_depth=4,
                           use_pallas=True, pallas_interpret=True)
    key = jax.random.PRNGKey(8)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    perm = jax.random.permutation(jax.random.PRNGKey(1), pix)
    a, _ = _render_block_pallas(scene, cam, cfg, key, pix, 0, 2)
    b, _ = _render_block_pallas(scene, cam, cfg, key, perm, 0, 2)
    np.testing.assert_array_equal(np.asarray(a)[np.asarray(perm)], np.asarray(b))


def test_pack_scene_layout():
    """The packed table holds the scene's rows in the kernel's order, and
    the reference scene renders as the jnp path does."""
    scene = spt.reference_scene()
    s = scene.num_spheres
    t = np.asarray(pf.pack_scene(scene)).reshape(pf._N_ROWS, s)
    np.testing.assert_array_equal(t[pf._CX], np.asarray(scene.centers[:, 0]))
    np.testing.assert_array_equal(t[pf._R], np.asarray(scene.radii))
    np.testing.assert_array_equal(t[pf._AB], np.asarray(scene.albedo[:, 2]))
    np.testing.assert_array_equal(t[pf._MAT], np.asarray(scene.material))
    np.testing.assert_array_equal(t[pf._IOR], np.asarray(scene.ior))
    cam = spt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90)
    cfg = spt.RenderConfig(width=16, height=16, spp=2, max_depth=5)
    _compare(scene, cam, cfg, jax.random.PRNGKey(3))


def test_pack_params_camera_matches_generate_rays():
    """The kernel's camera block reproduces camera.generate_rays."""
    from simplepathtracer_tpu.camera import generate_rays

    scene, cam = _scene("defocus")
    w, h = 12, 8
    prm = np.asarray(pf.pack_params(scene, cam, w, h))
    assert prm.shape == (pf._N_PARAMS,)
    pix = jnp.asarray([0, 5, 95], jnp.int32)
    jit4 = jnp.asarray([[0.5, 0.5, 0.0, 0.0]] * 3, jnp.float32)
    o, d = generate_rays(cam, w, h, pix, jit4)
    c = prm[pf._CAM:]
    x, y = np.asarray(pix) % w, np.asarray(pix) // w
    s01, t01 = (x + 0.5) / w, 1.0 - (y + 0.5) / h
    dd = c[3:6] + s01[:, None] * c[6:9] + t01[:, None] * c[9:12] - c[0:3]
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    np.testing.assert_allclose(dd, np.asarray(d), atol=1e-5)
    np.testing.assert_allclose(np.broadcast_to(c[0:3], (3, 3)), np.asarray(o),
                               atol=1e-6)
    np.testing.assert_allclose(prm[pf._SKY:pf._SKY + 6], np.concatenate(
        [np.asarray(scene.sky_lo), np.asarray(scene.sky_hi)]))


@pytest.mark.parametrize("tiles,samples", [(4, 2), (8, 1), (2, 4)])
def test_kernel_under_shard_map_matches_jnp(tiles, samples):
    """The kernel inside shard_map on a ('tiles', 'samples') mesh of the 8
    CPU devices, plane scene: the sharded sum matches the jnp path's."""
    from simplepathtracer_tpu.parallel import make_mesh, render_accum_sharded

    scene, cam = _scene("plane")
    cfg = spt.RenderConfig(width=32, height=8, spp=4, max_depth=4,
                           use_pallas=True, pallas_interpret=True)
    key = jax.random.PRNGKey(9)
    mesh = make_mesh(tiles=tiles, samples=samples)
    acc = np.asarray(jax.jit(
        lambda s, c, k: render_accum_sharded(s, c, cfg, k, mesh)
    )(scene, cam, key))
    ref = np.asarray(render_sample_batch(
        scene, cam, cfg.replace(use_pallas=False), key, 0, cfg.spp))
    _assert_close(acc, ref, cfg.spp)


def test_kernel_refuses_cpu_without_interpret():
    """The capability check: on the CPU the kernel runs only when
    pallas_interpret asks for it, never by a silent fallback."""
    from simplepathtracer_tpu.render import kernel_available

    scene, cam = _scene("spheres")
    cfg = spt.RenderConfig(width=8, height=4, spp=1, max_depth=2,
                           use_pallas=True)
    assert jax.default_backend() == "cpu"
    assert not kernel_available(cfg)
    assert kernel_available(cfg.replace(pallas_interpret=True))
    with pytest.raises(RuntimeError, match="needs a GPU.*pallas_interpret"):
        spt.render(scene, cam, cfg, jax.random.PRNGKey(0))


def test_kernel_compiles_on_gpu_backend(monkeypatch):
    """On a GPU backend the check asks for the compiled kernel."""
    import sys

    R = sys.modules["simplepathtracer_tpu.render"]
    cfg = spt.RenderConfig(use_pallas=True)
    monkeypatch.setattr(R.jax, "default_backend", lambda: "gpu")
    assert R.kernel_available(cfg)
    assert R._kernel_interpret(cfg) is False
    assert R._kernel_interpret(cfg.replace(pallas_interpret=True)) is True


def test_unit_float_matches_sampling():
    """The kernel's bitcast u32 -> [0, 1) conversion equals ops/sampling's."""
    from simplepathtracer_tpu.ops.sampling import _to_unit_float

    bits = jax.random.bits(jax.random.PRNGKey(0), (4096,), jnp.uint32)
    bits = jnp.concatenate([bits, jnp.asarray([0, 255, 256, 2**32 - 1],
                                              jnp.uint32)])
    np.testing.assert_array_equal(np.asarray(pf._unit_float(bits)),
                                  np.asarray(_to_unit_float(bits)))


@pytest.mark.parametrize("mat", [0, 1, 2], ids=["lambertian", "metal", "dielectric"])
def test_kernel_scatter_matches_materials(mat):
    """The kernel's per-lane scatter equals ops/materials.scatter_attrs on
    random incidences, normals (both faces) and uniforms."""
    from simplepathtracer_tpu.ops.materials import scatter_attrs

    n = 512
    k = jax.random.split(jax.random.PRNGKey(mat), 4)
    d = jax.random.normal(k[0], (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    nrm = jax.random.normal(k[1], (n, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    u = jax.random.uniform(k[2], (n, 8))
    alb = jax.random.uniform(k[3], (n, 3))
    matv = jnp.full((n,), mat, jnp.int32)
    fz = jnp.full((n,), 0.3)
    io = jnp.full((n,), 1.5)
    ref_d, ref_att, ref_ok = scatter_attrs(d, nrm, matv, alb, fz, io, u)
    out = pf._scatter(
        d[:, 0], d[:, 1], d[:, 2], nrm[:, 0], nrm[:, 1], nrm[:, 2],
        matv.astype(jnp.float32), alb[:, 0], alb[:, 1], alb[:, 2], fz, io,
        tuple(u[:, i] for i in range(6)),
    )
    np.testing.assert_allclose(np.stack(out[:3], -1), np.asarray(ref_d),
                               atol=2e-5)
    np.testing.assert_allclose(np.stack(out[3:6], -1), np.asarray(ref_att),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out[6]), np.asarray(ref_ok))
