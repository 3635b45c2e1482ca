"""Multi-device / multi-host parallelism: meshes, sharded render, sharded grad.

SPMD replacement for the reference's tile-scheduler thread pool
(include/Renderer.hpp:257-302) — see sharding.py.
"""

from .distributed import (  # noqa: F401
    initialize_cluster,
    local_tile_slice,
    make_multihost_mesh,
)
from .sharding import (  # noqa: F401
    loss_and_grad_sharded,
    make_mesh,
    merge_scene,
    render_accum_sharded,
    render_sharded,
    split_scene,
    train_step_sharded,
)
