"""Multi-host orchestration: jax.distributed init + host-spanning meshes.

Reference counterpart: none — the reference is a single process whose only
"collective layer" is a shared framebuffer + condition variable
(include/Renderer.hpp:276-292; SURVEY.md S2 "Communication backend").  The
equivalent here is ``jax.distributed.initialize`` + a mesh whose sample
shards sit on the devices of one host (the per-step psum stays on the
host's links) while tile shards span hosts (crossed only at the final
image gather).

In a multi-process job every process runs this same program;
``initialize()`` wires the processes together and ``jax.devices()`` becomes
the global device list.
The render/train code in sharding.py is already multi-host-safe: inputs are
replicated (tiny), outputs are sharded by tiles, and all randomness is
keyed by global (pixel, sample) ids so host count cannot change the image.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from .sharding import make_mesh


def _distributed_client_active() -> bool:
    """Whether jax.distributed is already initialized.

    Must NOT touch the XLA backend: calling jax.process_count()/jax.devices()
    before jax.distributed.initialize() initializes the backend, after which
    initialize() always raises.  The global_state client handle is the one
    signal that answers the question without that side effect.
    """
    try:
        from jax._src.distributed import global_state

        return global_state.client is not None
    except (ImportError, AttributeError):  # pragma: no cover - jax internals moved
        return False


def initialize_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed for a multi-host job.

    With no arguments, relies on the environment (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a cluster JAX detects itself).
    Safe to call on single-process jobs (no-op if already initialized or
    if no coordinator is configured).  Where nothing describes the cluster,
    pass ``coordinator_address`` (e.g. ``localhost:<port>``),
    ``num_processes`` and ``process_id`` explicitly.

    Call this BEFORE any jax API that touches devices; every process must
    call it so ``jax.devices()`` becomes the global device list (SURVEY.md
    S5 "Distributed communication backend").
    """
    if _distributed_client_active():
        return  # already initialized
    import os

    env_configured = (
        coordinator_address is not None
        # Explicit caller arguments are an opt-in even without an address:
        # jax.distributed can detect the coordinator from a cluster
        # manager, so initialize(num_processes=N, process_id=i) is a valid
        # launcher pattern that must not silently no-op.
        or num_processes is not None
        or process_id is not None
        or "JAX_COORDINATOR_ADDRESS" in os.environ
        or "JAX_NUM_PROCESSES" in os.environ
    )
    if not env_configured:
        # Single-process run without a coordinator: stay local.  (Silently
        # swallowing initialize() errors here would mask real cluster
        # misconfiguration, so we gate on config presence instead.)
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # _distributed_client_active probes a jax-internal handle; if that
        # internal moves it reports False and we land here on an
        # already-initialized client.  Degrade gracefully for exactly that
        # case; re-raise real cluster misconfiguration.
        if "already initialized" not in str(e).lower():
            raise


def make_multihost_mesh(samples_per_host: int = 1) -> Mesh:
    """('tiles', 'samples') mesh over every device in the job.

    Sample shards are placed on devices of the same host (the per-step
    psum stays on that host's links); tile shards span hosts (no per-step
    cross-host traffic — tiles are disjoint pixels, combined only at
    readback).
    """
    n = len(jax.devices())
    assert n % samples_per_host == 0
    return make_mesh(tiles=n // samples_per_host, samples=samples_per_host)


def local_tile_slice(mesh: Mesh, num_pixels: int):
    """(start, size) of the pixel range owned by this process's tile shards
    — what this host should write when saving a sharded render to disk."""
    nt = mesh.shape["tiles"]
    p_local = num_pixels // nt
    # Derive from the local devices' mesh coordinates.
    coords = []
    local = set(jax.local_devices())
    devs = mesh.devices
    for ti in range(devs.shape[0]):
        if any(d in local for d in devs[ti]):
            coords.append(ti)
    # The slice is only correct when this process's tile coordinates form a
    # contiguous run; a device-to-host layout that interleaves hosts along
    # the tile axis would silently save overlapping slices otherwise.
    assert coords == list(range(min(coords), max(coords) + 1)), (
        f"non-contiguous tile coordinates for this process: {coords}; "
        "build the mesh so each host owns a contiguous tile range "
        "(make_multihost_mesh does)"
    )
    start = min(coords) * p_local
    size = (max(coords) - min(coords) + 1) * p_local
    return start, size
