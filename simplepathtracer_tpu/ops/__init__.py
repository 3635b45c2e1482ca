from .intersect import Hit, intersect_scene  # noqa: F401
from .materials import scatter, sky_color  # noqa: F401
from .sampling import (  # noqa: F401
    RayCtx,
    bounce_noise,
    camera_jitter,
    in_unit_ball,
    ray_keys,
    threefry2x32,
    unit_sphere_surface,
)
