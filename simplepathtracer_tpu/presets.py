"""Named render presets — the BASELINE.json configs as first-class objects.

The reference's "config system" is compile-time constants
(include/Globals.hpp:8-29; changing anything means recompiling).  Here a
preset is data: (scene factory, camera, RenderConfig), overridable from the
CLI (SURVEY.md S5 "config/flag system").
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax

from . import scenes
from .types import Camera, RenderConfig, Scene, make_camera


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    scene_fn: Callable[..., Scene]   # (key) -> Scene
    camera_fn: Callable[[], Camera]
    config: RenderConfig

    def build(self, key=None):
        key = key if key is not None else jax.random.PRNGKey(0)
        return self.scene_fn(key), self.camera_fn(), self.config


PRESETS = {
    # BASELINE.json configs[0]
    "simple": Preset(
        name="simple",
        description="Single Lambertian sphere + ground, 200x100 @ 16spp depth 8",
        scene_fn=lambda key: scenes.simple_scene(),
        camera_fn=lambda: make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90),
        config=RenderConfig(width=200, height=100, spp=16, max_depth=8,
                            use_pallas=True),
    ),
    # BASELINE.json configs[1]
    "three_sphere": Preset(
        name="three_sphere",
        description="Lambertian/metal/hollow-glass trio, 400x200 @ 64spp",
        scene_fn=lambda key: scenes.three_sphere_scene(hollow_glass=True),
        camera_fn=lambda: make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90),
        config=RenderConfig(width=400, height=200, spp=64, max_depth=10,
                            use_pallas=True),
    ),
    # BASELINE.json configs[2]
    "cover": Preset(
        name="cover",
        description="Shirley cover scene (~490 spheres), 1200x800 @ 100spp, defocus",
        scene_fn=lambda key: scenes.compact_scene(scenes.cover_scene(key, max_spheres=512)),
        camera_fn=lambda: make_camera(
            origin=(13, 2, 3), lookat=(0, 0, 0), vfov_deg=20,
            aperture=0.1, focus_dist=10.0,
        ),
        config=RenderConfig(width=1200, height=800, spp=100, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
    # Infinite Lambertian ground plane (the reference's dead plane code,
    # live here in every path)
    "three_sphere_plane": Preset(
        name="three_sphere_plane",
        description="Lambertian/metal/glass trio on an INFINITE plane, 400x200 @ 64spp",
        scene_fn=lambda key: scenes.with_ground_plane(
            scenes.three_sphere_scene(hollow_glass=True)
        ),
        camera_fn=lambda: make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90),
        config=RenderConfig(width=400, height=200, spp=64, max_depth=10,
                            use_pallas=True),
    ),
    # The reference's own two scenes (SceneGenerators.hpp:68 / :6)
    "reference": Preset(
        name="reference",
        description="The reference's hard-coded 3x3 grid scene (InitSpheres)",
        scene_fn=lambda key: scenes.reference_scene(),
        camera_fn=lambda: make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90),
        config=RenderConfig(width=1440, height=1440, spp=100, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
    "random": Preset(
        name="random",
        description="The reference's randomized lattice scene (GenerateSpheres)",
        scene_fn=lambda key: scenes.compact_scene(scenes.random_scene(key, max_spheres=512)),
        camera_fn=lambda: make_camera(origin=(0, 4, -10), lookat=(0, 2, 5), vfov_deg=60),
        config=RenderConfig(width=1440, height=1440, spp=100, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
    # BASELINE.json configs[4] — the sharded multi-device config (mesh set
    # at runtime)
    "cover_multihost": Preset(
        name="cover_multihost",
        description="Cover scene 1200x800 @ 2000spp for sharded multi-device runs",
        scene_fn=lambda key: scenes.compact_scene(scenes.cover_scene(key, max_spheres=512)),
        camera_fn=lambda: make_camera(
            origin=(13, 2, 3), lookat=(0, 0, 0), vfov_deg=20,
            aperture=0.1, focus_dist=10.0,
        ),
        config=RenderConfig(width=1200, height=800, spp=2000, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
}
