"""Independent NumPy CPU oracle with the *intended* Shirley semantics.

This is the gold standard demanded by SURVEY.md S4: the reference ships zero
tests and its only validation artifacts are eyeball BMPs, so correctness of
this build is established against this small, scalar, recursive
implementation instead.  It is written in classic recursive style (one ray
at a time, Python floats) precisely so it shares *no* structure with the
vectorized JAX wavefront — agreement between two independently-shaped
implementations is the test.

Semantics mirror the reference's material model (SingleThreadPathTracer.hpp:
11-92) with its documented bugs corrected (SURVEY.md S2): proper Lambertian
scatter (normal + unit sphere point, no hit-point-into-direction bug),
albedo attenuation instead of hard-coded 0.5 falloff, in-ball sampling with
a non-inverted rejection test, dielectric with per-sphere IOR.

RNG is numpy's Generator — *different* streams from the JAX renderer, so
comparisons are statistical (mean image within Monte-Carlo error bounds),
per SURVEY.md S4 item 2.
"""

from __future__ import annotations

import math

import numpy as np


def _normalize(v):
    return v / math.sqrt(float(v @ v) + 1e-20)


def _unit_vector(rng):
    while True:
        v = rng.normal(size=3)
        n = v @ v
        if n > 1e-12:
            return v / math.sqrt(n)


def _in_unit_ball(rng):
    while True:
        v = rng.uniform(-1, 1, size=3)
        if v @ v < 1.0:
            return v


class OracleScene:
    """Plain-numpy view of a Scene pytree."""

    def __init__(self, scene):
        self.centers = np.asarray(scene.centers, np.float64)
        self.radii = np.asarray(scene.radii, np.float64)
        self.albedo = np.asarray(scene.albedo, np.float64)
        self.material = np.asarray(scene.material, np.int32)
        self.fuzz = np.asarray(scene.fuzz, np.float64)
        self.ior = np.asarray(scene.ior, np.float64)
        self.sky_lo = np.asarray(scene.sky_lo, np.float64)
        self.sky_hi = np.asarray(scene.sky_hi, np.float64)


def _hit_scene(sc: OracleScene, o, d, t_min, t_max):
    """Closest hit by linear scan (the oracle's FindClosestIntersectionSphere)."""
    best_t, best_i = t_max, -1
    for i in range(len(sc.radii)):
        oc = sc.centers[i] - o
        tc = oc @ d
        disc = sc.radii[i] ** 2 - (oc @ oc - tc * tc)
        if disc <= 0.0:
            continue
        sq = math.sqrt(disc)
        t = tc - sq
        if not (t_min < t < t_max):
            t = tc + sq
        if t_min < t < best_t:
            best_t, best_i = t, i
    return best_t, best_i


def _sky(sc: OracleScene, d):
    s = 0.5 * (d[1] + 1.0)
    return sc.sky_lo + (sc.sky_hi - sc.sky_lo) * s


def _trace(sc: OracleScene, o, d, depth, rng, t_min=1e-3, t_max=3.0e7):
    if depth <= 0:
        return np.zeros(3)
    t, i = _hit_scene(sc, o, d, t_min, t_max)
    if i < 0:
        return _sky(sc, d)
    p = o + t * d
    n = (p - sc.centers[i]) / sc.radii[i]
    n = _normalize(n)
    front = d @ n < 0.0
    nf = n if front else -n
    mat = sc.material[i]
    if mat == 0:  # lambertian
        nd = nf + _unit_vector(rng)
        nd = nf if nd @ nd < 1e-12 else _normalize(nd)
        return sc.albedo[i] * _trace(sc, p, nd, depth - 1, rng, t_min, t_max)
    if mat == 1:  # metal
        refl = d - 2.0 * (d @ nf) * nf
        nd = refl + sc.fuzz[i] * _in_unit_ball(rng)
        if nd @ nf <= 0.0:
            return np.zeros(3)
        return sc.albedo[i] * _trace(sc, p, _normalize(nd), depth - 1, rng, t_min, t_max)
    # dielectric
    eta = 1.0 / sc.ior[i] if front else sc.ior[i]
    cos_t = min(-(d @ nf), 1.0)
    sin_t = math.sqrt(max(1.0 - cos_t * cos_t, 0.0))
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    reflect_prob = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    if eta * sin_t > 1.0 or rng.uniform() < reflect_prob:
        nd = d - 2.0 * (d @ nf) * nf
    else:
        perp = eta * (d + cos_t * nf)
        nd = perp - math.sqrt(max(1.0 - perp @ perp, 0.0)) * nf
    return _trace(sc, p, _normalize(nd), depth - 1, rng, t_min, t_max)


def render_oracle(scene, camera, width, height, spp, max_depth, seed=0, gamma=2.0):
    """Render [H, W, 3] float image in [0, 1], gamma-corrected."""
    sc = OracleScene(scene)
    rng = np.random.default_rng(seed)

    origin = np.asarray(camera.origin, np.float64)
    lookat = np.asarray(camera.lookat, np.float64)
    vup = np.asarray(camera.vup, np.float64)
    vfov = float(camera.vfov_deg)
    aperture = float(camera.aperture)
    focus = float(camera.focus_dist)

    w = _normalize(origin - lookat)
    u = _normalize(np.cross(vup, w))
    v = np.cross(w, u)
    aspect = width / height
    half_h = math.tan(math.radians(vfov) * 0.5)
    half_w = aspect * half_h
    lower_left = origin - focus * (half_w * u + half_h * v + w)
    horizontal = 2.0 * half_w * focus * u
    vertical = 2.0 * half_h * focus * v

    img = np.zeros((height, width, 3))
    for y in range(height):
        for x in range(width):
            c = np.zeros(3)
            for _ in range(spp):
                s = (x + rng.uniform()) / width
                t = 1.0 - (y + rng.uniform()) / height
                if aperture > 0:
                    r = math.sqrt(rng.uniform()) * 0.5 * aperture
                    th = 2.0 * math.pi * rng.uniform()
                    off = r * math.cos(th) * u + r * math.sin(th) * v
                else:
                    off = np.zeros(3)
                o = origin + off
                d = _normalize(lower_left + s * horizontal + t * vertical - o)
                c += _trace(sc, o, d, max_depth, rng)
            img[y, x] = c / spp
    return np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
