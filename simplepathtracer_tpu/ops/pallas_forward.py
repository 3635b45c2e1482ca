"""Forward render megakernel for the GPU: Pallas through Triton.

One lane (one GPU thread) owns one pixel for the whole render.  It traces
that pixel's ``n_samples`` paths one after another: when a path ends (sky,
absorption, depth budget or Russian roulette) the lane adds its radiance to
a register accumulator and starts the same pixel's next sample in place.
Ray state never leaves registers; device memory sees the pixel ids going in
and one radiance sum per pixel coming out.  A block of lanes loops until
every lane has finished its samples, so the expected work per lane is
``n_samples * (mean path length + 1)`` sphere scans, not
``n_samples * max_depth`` as in the per-bounce wavefront of ``render.py``.

The sphere scan reads one packed table ``[10 * S]`` with scalar loads
whose address is the same for every lane (served from cache), and tracks
only the nearest ``(t, index)``; the winner's attributes are gathered once
per iteration after the scan.

Randomness is the same counter-based threefry stream as the jnp path
(ops/sampling.py: counter ``(pixel, sample << 8 | slot)``), so the image
agrees with ``render.trace_rays`` sample for sample up to floating-point
reassociation.  The kernel is forward-only: gradients use the jnp bounce.

Reference counterpart: the whole per-tile render loop
(include/SingleThreadPathTracer.hpp:114-137: pixel, sample and bounce loops,
camera, RNG, shading) in one kernel; in-place regeneration plays the part of
the wavefront tracer's queue refill (TaskBasedPathTracer.hpp:61-79).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..types import Material
from .sampling import threefry2x32

# Lanes per program and warps per program.  A warp (32 lanes) is the unit
# of divergence, and a block loops until its slowest lane is done, so
# one-warp blocks waste the least on stragglers (measured fastest of
# 32..256 lanes and 1..8 warps on an H100; Triton's pipeline stages
# measured flat from 1 to 4, so its default stays — PERF.md).
BLOCK = 32
NUM_WARPS = 1

# Rows of the packed sphere table.
_CX, _CY, _CZ, _R, _AR, _AG, _AB, _MAT, _FUZZ, _IOR = range(10)
_N_ROWS = 10
# Layout of the f32 parameter block: sky lo/hi rgb, ground plane (unit
# normal, offset, albedo rgb), camera (origin, lower_left, horizontal,
# vertical, u, v, lens radius).
_SKY, _PLANE, _CAM = 0, 6, 13
_N_PARAMS = 32


def pack_scene(scene):
    """The packed f32 sphere table ``[10 * S]`` the kernel scans."""
    rows = [
        scene.centers[:, 0], scene.centers[:, 1], scene.centers[:, 2],
        scene.radii,
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.material.astype(jnp.float32), scene.fuzz, scene.ior,
    ]
    return jnp.concatenate([r.astype(jnp.float32) for r in rows])


def pack_params(scene, camera, width: int, height: int):
    """The f32[32] block of sky, plane and camera constants.

    The camera constants use the same basis math as camera.generate_rays,
    so in-kernel primary rays match the jnp path's.
    """
    from ..camera import camera_basis

    u, v, w = camera_basis(camera)
    half_h = jnp.tan(jnp.deg2rad(camera.vfov_deg) * 0.5)
    half_w = (width / height) * half_h
    fd = camera.focus_dist
    lower_left = camera.origin - fd * (half_w * u + half_h * v + w)
    horizontal = 2.0 * half_w * fd * u
    vertical = 2.0 * half_h * fd * v
    plane = scene.plane if scene.plane is not None else jnp.zeros((7,))
    return jnp.concatenate([
        scene.sky_lo, scene.sky_hi, plane,
        camera.origin, lower_left, horizontal, vertical, u, v,
        jnp.reshape(0.5 * camera.aperture, (1,)),
    ]).astype(jnp.float32)


def _unit_float(bits):
    """u32 -> f32 in [0, 1) from the top 24 bits (as ops/sampling.py)."""
    i = jax.lax.bitcast_convert_type(bits >> jnp.uint32(8), jnp.int32)
    return i.astype(jnp.float32) * np.float32(2.0**-24)


def _scatter(dx, dy, dz, nx, ny, nz, mat, ar, ag, ab, fz, io, u):
    """Lambertian/metal/dielectric scatter on lanes; the semantics of
    ops/materials.scatter_attrs.  Returns the scattered unit direction,
    the rgb attenuation and the metal-absorption mask."""
    front = dx * nx + dy * ny + dz * nz < 0.0
    fsign = jnp.where(front, 1.0, -1.0)
    nfx, nfy, nfz = nx * fsign, ny * fsign, nz * fsign
    d_dot_nf = dx * nfx + dy * nfy + dz * nfz
    cos_t = jnp.minimum(-d_dot_nf, 1.0)

    def unit_or_normal(x, y, z):
        n2 = x * x + y * y + z * z
        inv = jax.lax.rsqrt(jnp.maximum(n2, 1e-20))
        deg = n2 <= 1e-12
        return (jnp.where(deg, nfx, x * inv), jnp.where(deg, nfy, y * inv),
                jnp.where(deg, nfz, z * inv))

    # Lambertian: face normal + a uniform point on the unit sphere.
    zl = 1.0 - 2.0 * u[0]
    rl = jnp.sqrt(jnp.maximum(1.0 - zl * zl, 0.0))
    phl = np.float32(2.0 * np.pi) * u[1]
    lamx, lamy, lamz = unit_or_normal(
        nfx + rl * jnp.cos(phl), nfy + rl * jnp.sin(phl), nfz + zl
    )

    # Metal: mirror + fuzz * a uniform point in the unit ball.
    rfx = dx - 2.0 * d_dot_nf * nfx
    rfy = dy - 2.0 * d_dot_nf * nfy
    rfz = dz - 2.0 * d_dot_nf * nfz
    zm = 1.0 - 2.0 * u[2]
    rm = jnp.sqrt(jnp.maximum(1.0 - zm * zm, 0.0))
    phm = np.float32(2.0 * np.pi) * u[3]
    ball = jnp.cbrt(u[4]) * fz
    metx, mety, metz = unit_or_normal(
        rfx + ball * rm * jnp.cos(phm), rfy + ball * rm * jnp.sin(phm),
        rfz + ball * zm,
    )
    metal_ok = metx * nfx + mety * nfy + metz * nfz > 0.0

    # Dielectric: Schlick coin + sqrt-free total-internal-reflection test.
    eta = jnp.where(front, 1.0 / io, io)
    cannot = eta * eta * jnp.maximum(1.0 - cos_t * cos_t, 0.0) > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    refl_p = r0 + (1.0 - r0) * (omc * omc) * (omc * omc) * omc
    do_refl = cannot | (u[5] < refl_p)
    ppx = eta * (dx + cos_t * nfx)
    ppy = eta * (dy + cos_t * nfy)
    ppz = eta * (dz + cos_t * nfz)
    par = jnp.sqrt(jnp.maximum(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz), 1e-12))
    diex, diey, diez = unit_or_normal(
        jnp.where(do_refl, rfx, ppx - par * nfx),
        jnp.where(do_refl, rfy, ppy - par * nfy),
        jnp.where(do_refl, rfz, ppz - par * nfz),
    )

    is_metal = mat == float(Material.METAL)
    is_diel = mat == float(Material.DIELECTRIC)
    sdx = jnp.where(is_diel, diex, jnp.where(is_metal, metx, lamx))
    sdy = jnp.where(is_diel, diey, jnp.where(is_metal, mety, lamy))
    sdz = jnp.where(is_diel, diez, jnp.where(is_metal, metz, lamz))
    atr = jnp.where(is_diel, 1.0, ar)
    atg = jnp.where(is_diel, 1.0, ag)
    atb = jnp.where(is_diel, 1.0, ab)
    return sdx, sdy, sdz, atr, atg, atb, metal_ok | ~is_metal


def _kernel(
    tab_ref,   # f32[10 * S] packed sphere table
    par_ref,   # f32[32] sky, plane, camera
    key_ref,   # u32[3] cipher key k0, k1 and the first sample id
    pix_ref,   # u32[BLOCK] global pixel id of each lane
    out_r, out_g, out_b,  # f32[BLOCK] radiance sums
    out_n,                # f32[BLOCK] loop iterations spent on the lane
    *, n_pixels: int, n_spheres: int, n_samples: int, max_depth: int,
    width: int, height: int, t_min: float, t_max: float,
    rr_start_depth: int, use_plane: bool, block: int,
):
    f32, u32, i32 = jnp.float32, jnp.uint32, jnp.int32
    k0, k1, soff = key_ref[0], key_ref[1], key_ref[2]
    pix = pix_ref[...]
    pix_i = jax.lax.bitcast_convert_type(pix, i32)
    xf = (pix_i % width).astype(f32)
    yf = (pix_i // width).astype(f32)
    lane = pl.program_id(0) * block + jax.lax.iota(i32, block)
    # Padding lanes start with every sample done.
    s0 = jnp.where(lane < n_pixels, 0, n_samples).astype(i32)
    cam = [par_ref[_CAM + k] for k in range(19)]

    def uniforms(c1):
        w0, w1 = threefry2x32(k0, k1, pix, c1)
        return _unit_float(w0), _unit_float(w1)

    def scan(ox, oy, oz, dx, dy, dz):
        def one_sphere(s, c):
            bt, bi = c
            ocx = tab_ref[_CX * n_spheres + s] - ox
            ocy = tab_ref[_CY * n_spheres + s] - oy
            ocz = tab_ref[_CZ * n_spheres + s] - oz
            sr = tab_ref[_R * n_spheres + s]
            tc = ocx * dx + ocy * dy + ocz * dz
            disc = sr * sr - (ocx * ocx + ocy * ocy + ocz * ocz - tc * tc)
            sq = jnp.sqrt(disc)
            t_near = tc - sq
            t = jnp.where(t_near > t_min, t_near, tc + sq)
            ok = (t > t_min) & (t < bt)
            return jnp.where(ok, t, bt), jnp.where(ok, s, bi)

        # A miss (negative discriminant) gives a NaN t, and every
        # comparison with NaN is false: the sphere never wins.
        init = (jnp.full((block,), t_max, f32), jnp.full((block,), -1, i32))
        return jax.lax.fori_loop(0, n_spheres, one_sphere, init)

    def body(c):
        (s, alive_f, b, ox, oy, oz, dx, dy, dz, tr, tg, tb,
         acr, acg, acb, itc) = c
        alive = alive_f > 0.0

        # ---- regenerate finished lanes with the pixel's next sample -----
        regen = ~alive & (s < n_samples)
        c1b = (soff + s.astype(u32)) << u32(8)
        jx, jy = uniforms(c1b | u32(124))
        lu, lv = uniforms(c1b | u32(125))
        s01 = (xf + jx) * np.float32(1.0 / width)
        t01 = 1.0 - (yf + jy) * np.float32(1.0 / height)
        lr = jnp.sqrt(lu) * cam[18]
        th = np.float32(2.0 * np.pi) * lv
        ou, ov = lr * jnp.cos(th), lr * jnp.sin(th)
        nox = cam[0] + ou * cam[12] + ov * cam[15]
        noy = cam[1] + ou * cam[13] + ov * cam[16]
        noz = cam[2] + ou * cam[14] + ov * cam[17]
        ndx = cam[3] + s01 * cam[6] + t01 * cam[9] - nox
        ndy = cam[4] + s01 * cam[7] + t01 * cam[10] - noy
        ndz = cam[5] + s01 * cam[8] + t01 * cam[11] - noz
        ninv = jax.lax.rsqrt(ndx * ndx + ndy * ndy + ndz * ndz + 1e-20)
        ox, oy, oz = (jnp.where(regen, n, o) for n, o in
                      ((nox, ox), (noy, oy), (noz, oz)))
        dx, dy, dz = (jnp.where(regen, n * ninv, d) for n, d in
                      ((ndx, dx), (ndy, dy), (ndz, dz)))
        tr, tg, tb = (jnp.where(regen, 1.0, t) for t in (tr, tg, tb))
        b = jnp.where(regen, 0, b)
        alive = alive | regen
        itc = itc + jnp.where(alive, 1.0, 0.0)

        # ---- closest hit, then the winner's attributes -----------------
        t, idx = scan(ox, oy, oz, dx, dy, dz)
        hit = idx >= 0
        gi = jnp.maximum(idx, 0)

        def attr(row):
            return tab_ref[row * n_spheres + gi]

        cx, cy, cz, r = attr(_CX), attr(_CY), attr(_CZ), attr(_R)
        ar, ag, ab = attr(_AR), attr(_AG), attr(_AB)
        mat, fz, io = attr(_MAT), attr(_FUZZ), attr(_IOR)
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        nx, ny, nz = (px - cx) / r, (py - cy) / r, (pz - cz) / r
        if use_plane:
            # Lambertian ground plane {p : dot(n, p) + k = 0}: nearest
            # wins, with the plane's face-forward normal.
            pn = [par_ref[_PLANE + k] for k in range(7)]
            denom = dx * pn[0] + dy * pn[1] + dz * pn[2]
            live = jnp.abs(denom) > 1e-8
            tp = -(ox * pn[0] + oy * pn[1] + oz * pn[2] + pn[3]) / jnp.where(
                live, denom, 1.0
            )
            pw = live & (tp > t_min) & (tp < t)
            sgn = jnp.where(denom > 0.0, -1.0, 1.0)
            px = jnp.where(pw, ox + tp * dx, px)
            py = jnp.where(pw, oy + tp * dy, py)
            pz = jnp.where(pw, oz + tp * dz, pz)
            nx = jnp.where(pw, sgn * pn[0], nx)
            ny = jnp.where(pw, sgn * pn[1], ny)
            nz = jnp.where(pw, sgn * pn[2], nz)
            ar = jnp.where(pw, pn[4], ar)
            ag = jnp.where(pw, pn[5], ag)
            ab = jnp.where(pw, pn[6], ab)
            mat = jnp.where(pw, float(Material.LAMBERTIAN), mat)
            io = jnp.where(pw, 1.0, io)
            hit = hit | pw
        ninv = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz + 1e-20)
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv

        # ---- sky on misses ---------------------------------------------
        sky = 0.5 * (dy + 1.0)
        miss_f = jnp.where(alive & ~hit, 1.0, 0.0)
        acr = acr + tr * (par_ref[_SKY + 0] + (par_ref[_SKY + 3] - par_ref[_SKY + 0]) * sky) * miss_f
        acg = acg + tg * (par_ref[_SKY + 1] + (par_ref[_SKY + 4] - par_ref[_SKY + 1]) * sky) * miss_f
        acb = acb + tb * (par_ref[_SKY + 2] + (par_ref[_SKY + 5] - par_ref[_SKY + 2]) * sky) * miss_f

        # ---- scatter (bounce noise slots 4b .. 4b+2 of ops/sampling) ----
        slot0 = b.astype(u32) * u32(4)
        u0, u1 = uniforms(c1b | slot0)
        u2, u3 = uniforms(c1b | (slot0 + u32(1)))
        u4, u5 = uniforms(c1b | (slot0 + u32(2)))
        sdx, sdy, sdz, atr, atg, atb, scattered = _scatter(
            dx, dy, dz, nx, ny, nz, mat, ar, ag, ab, fz, io,
            (u0, u1, u2, u3, u4, u5),
        )

        # ---- state update -----------------------------------------------
        surv = alive & hit & scattered & (b + 1 < max_depth)
        tr = tr * jnp.where(surv, atr, 1.0)
        tg = tg * jnp.where(surv, atg, 1.0)
        tb = tb * jnp.where(surv, atb, 1.0)
        if rr_start_depth:
            # Russian roulette, as the jnp bounce (uniform column 6).
            q = jnp.clip(jnp.maximum(jnp.maximum(tr, tg), tb), 0.05, 1.0)
            u6, _ = uniforms(c1b | (slot0 + u32(3)))
            do_rr = b >= rr_start_depth
            surv = surv & ~(do_rr & (u6 >= q))
            boost = jnp.where(do_rr & surv, 1.0 / q, 1.0)
            tr, tg, tb = tr * boost, tg * boost, tb * boost
        moved = alive & hit
        ox, oy, oz = (jnp.where(moved, p, o) for p, o in
                      ((px, ox), (py, oy), (pz, oz)))
        dx, dy, dz = (jnp.where(surv, n, d) for n, d in
                      ((sdx, dx), (sdy, dy), (sdz, dz)))
        b = jnp.where(surv, b + 1, b)
        s = jnp.where(alive & ~surv, s + 1, s)
        return (s, jnp.where(surv, 1.0, 0.0), b, ox, oy, oz, dx, dy, dz,
                tr, tg, tb, acr, acg, acb, itc)

    z = jnp.zeros((block,), f32)
    one = jnp.ones((block,), f32)
    carry = (s0, z, jnp.zeros((block,), i32), z, z, z, z, z, one,
             one, one, one, z, z, z, z)
    out = jax.lax.while_loop(
        lambda c: jnp.min(c[0]) < n_samples, body, carry
    )
    out_r[...] = out[12]
    out_g[...] = out[13]
    out_b[...] = out[14]
    out_n[...] = out[15]


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_samples", "max_depth", "width", "height", "t_min", "t_max",
        "rr_start_depth", "use_plane", "interpret",
    ),
)
def render_block(
    pixel_ids, table, params, key2, sample_offset, *, n_samples, max_depth,
    width, height, t_min, t_max, rr_start_depth=0, use_plane=False,
    interpret=False,
):
    """Radiance sums over ``n_samples`` samples for each pixel id.

    Returns ([P, 3] radiance sum, [P] loop iterations spent on each pixel
    — the kernel's work counter: each iteration scans every sphere once).
    ``table``/``params`` come from pack_scene/pack_params;
    ``key2`` is the u32[2] cipher key and ``sample_offset`` the first
    global sample id (it may vary across a shard_map axis).
    """
    p = pixel_ids.shape[0]
    p_pad = -(-p // BLOCK) * BLOCK
    pix = jnp.asarray(pixel_ids).astype(jnp.uint32)
    if p_pad != p:
        pix = jnp.concatenate([pix, jnp.zeros((p_pad - p,), jnp.uint32)])
    meta = jnp.concatenate([
        jnp.asarray(key2, jnp.uint32),
        jnp.reshape(jnp.asarray(sample_offset, jnp.uint32), (1,)),
    ])
    n_spheres = table.shape[0] // _N_ROWS
    kernel = functools.partial(
        _kernel, n_pixels=p, n_spheres=n_spheres, n_samples=int(n_samples),
        max_depth=int(max_depth), width=int(width), height=int(height),
        t_min=float(t_min), t_max=float(t_max),
        rr_start_depth=int(rr_start_depth), use_plane=bool(use_plane),
        block=BLOCK,
    )
    # Under shard_map every output declares the union of the inputs'
    # varying mesh axes, and inputs are cast up to it.
    vma = frozenset()
    for x in (pix, table, params, meta):
        vma |= getattr(jax.typeof(x), "vma", frozenset())

    def to_vma(x):
        missing = vma - getattr(jax.typeof(x), "vma", frozenset())
        return jax.lax.pcast(x, tuple(missing), to="varying") if missing else x

    ins = tuple(to_vma(x) for x in (table, params, meta, pix))
    whole = [pl.BlockSpec(x.shape, lambda i: (0,)) for x in ins[:3]]
    lanes = pl.BlockSpec((BLOCK,), lambda i: (i,))
    out_r, out_g, out_b, out_n = pl.pallas_call(
        kernel,
        grid=(p_pad // BLOCK,),
        in_specs=[*whole, lanes],
        out_specs=[lanes] * 4,
        out_shape=[
            jax.ShapeDtypeStruct((p_pad,), jnp.float32, vma=vma)
            for _ in range(4)
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="spt_forward",
    )(*ins)
    rad = jnp.stack([out_r[:p], out_g[:p], out_b[:p]], axis=-1)
    return rad, out_n[:p]
