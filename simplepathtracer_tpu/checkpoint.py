"""Snapshot / resume for progressive renders.

The reference persists nothing mid-render — a crash loses the whole image
and the final BMP is its only artifact (include/IOHelpers.hpp:24-27;
SURVEY.md S5 "checkpoint/resume": none).  Here the checkpointable unit is
the ``RenderState`` pytree (accum image, sample count, RNG key): because
sample ids are global counters (ops/sampling.py), resuming from a snapshot
and continuing produces the bit-identical image of an uninterrupted run —
asserted by tests/test_checkpoint.py.

Format: a single ``np.savez`` archive (no orbax dependency needed for three
arrays; swap in ``orbax.checkpoint`` for multi-host sharded state if renders
ever outgrow one host's memory).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np

from .types import Camera, RenderConfig, RenderState, Scene

_FORMAT_VERSION = 3

_SCENE_FIELDS = (
    "centers", "radii", "albedo", "material", "fuzz", "ior", "sky_lo", "sky_hi"
)
_CAMERA_FIELDS = ("origin", "lookat", "vup", "vfov_deg", "aperture", "focus_dist")


def save(
    path: str, state: RenderState, scene: Scene, config: RenderConfig,
    camera: Camera | None = None,
) -> str:
    """Atomically write a snapshot (temp file + rename)."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "accum": np.asarray(state.accum, np.float32),
        "sample_count": np.asarray(state.sample_count, np.int64),
        "next_key": np.asarray(state.next_key),
        # The FULL config dataclass (v3+): earlier versions hand-listed the
        # fields and silently dropped rr_start_depth and
        # silhouette_softness, so resuming an RR render continued without RR
        # — breaking bit-identical resume exactly for the headline RR config.
        "config_json": np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), np.uint8
        ),
    }
    for f in _SCENE_FIELDS:
        payload[f"scene_{f}"] = np.asarray(getattr(scene, f))
    if scene.plane is not None:
        payload["scene_plane"] = np.asarray(scene.plane)
    if camera is not None:
        for f in _CAMERA_FIELDS:
            payload[f"camera_{f}"] = np.asarray(getattr(camera, f))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def save_sharded(
    prefix: str, acc, sample_count: int, key, scene: Scene,
    config: RenderConfig, mesh, camera: Camera | None = None,
) -> str:
    """Per-process snapshot of a tile-sharded render accumulation.

    Each process atomically writes ONLY the pixel rows its tile shards own
    (parallel/distributed.local_tile_slice) to ``{prefix}.proc{i}of{n}.npz``
    — no cross-host gather, so a snapshot of an N-host render costs each
    host 1/N of the image.  The reference analog is *nothing*: a crash
    loses its whole render (include/IOHelpers.hpp:24-27); the single-host
    analog here is ``save``.

    ``acc``: the [P, 3] radiance-sum array from render_accum_sharded
    (sharded over the ``tiles`` mesh axis).  Scene/config/camera/key are
    replicated and tiny, so every process embeds them (any surviving file
    subset that covers the tile range can restore).
    """
    import jax

    from .parallel.distributed import local_tile_slice

    start, size = local_tile_slice(mesh, config.num_pixels)
    local = np.zeros((size, 3), np.float32)
    seen = np.zeros((size,), bool)
    for shard in acc.addressable_shards:
        sl = shard.index[0]
        lo = sl.start or 0
        rows = shard.data.shape[0]
        local[lo - start : lo - start + rows] = np.asarray(shard.data)
        seen[lo - start : lo - start + rows] = True
    assert seen.all(), "addressable shards do not cover local_tile_slice"

    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "row_start": np.int64(start),
        "row_size": np.int64(size),
        "num_pixels": np.int64(config.num_pixels),
        "mesh_tiles": np.int64(mesh.shape["tiles"]),
        "mesh_samples": np.int64(mesh.shape["samples"]),
        "accum_rows": local,
        "sample_count": np.int64(sample_count),
        "next_key": np.asarray(key),
        "config_json": np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), np.uint8
        ),
    }
    for f in _SCENE_FIELDS:
        payload[f"scene_{f}"] = np.asarray(getattr(scene, f))
    if scene.plane is not None:
        payload["scene_plane"] = np.asarray(scene.plane)
    if camera is not None:
        for f in _CAMERA_FIELDS:
            payload[f"camera_{f}"] = np.asarray(getattr(camera, f))

    path = f"{prefix}.proc{jax.process_index()}of{jax.process_count()}.npz"
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_sharded(prefix: str, mesh):
    """Restore a sharded snapshot written by ``save_sharded``.

    Every process reads ITS OWN ``{prefix}.proc{i}of{n}.npz`` and
    reassembles the global tile-sharded accumulation via
    ``jax.make_array_from_process_local_data`` — no host ever materializes
    another host's rows.  Returns (acc, sample_count, key, scene, config,
    camera | None).  Resume = ``acc + render_accum_sharded(...,
    sample_offset=sample_count, n_samples=more)`` — bit-identical to an
    uninterrupted run (tests/test_checkpoint.py, tests/test_multiprocess.py).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from .parallel.distributed import local_tile_slice

    path = f"{prefix}.proc{jax.process_index()}of{jax.process_count()}.npz"
    with np.load(path) as z:
        version = int(z["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported sharded snapshot version {version} in {path!r} "
                f"(expected {_FORMAT_VERSION})"
            )
        if (int(z["mesh_tiles"]), int(z["mesh_samples"])) != (
            mesh.shape["tiles"], mesh.shape["samples"],
        ):
            raise ValueError(
                f"snapshot mesh {int(z['mesh_tiles'])}x{int(z['mesh_samples'])} "
                f"does not match the restore mesh "
                f"{mesh.shape['tiles']}x{mesh.shape['samples']} ({path!r})"
            )
        cfg = json.loads(bytes(z["config_json"].tobytes()).decode())
        known = {f.name for f in dataclasses.fields(RenderConfig)}
        config = RenderConfig(**{k: v for k, v in cfg.items() if k in known})
        start, size = local_tile_slice(mesh, config.num_pixels)
        if (int(z["row_start"]), int(z["row_size"])) != (start, size):
            raise ValueError(
                f"snapshot rows [{int(z['row_start'])}, +{int(z['row_size'])}) "
                f"do not match this process's tile slice [{start}, +{size}) — "
                f"was the snapshot written by a different process layout? ({path!r})"
            )
        local = np.asarray(z["accum_rows"], np.float32)
        sample_count = int(z["sample_count"])
        next_key = jnp.asarray(z["next_key"])
        scene = Scene(
            **{f: jnp.asarray(z[f"scene_{f}"]) for f in _SCENE_FIELDS},
            plane=jnp.asarray(z["scene_plane"]) if "scene_plane" in z else None,
        )
        camera = None
        if f"camera_{_CAMERA_FIELDS[0]}" in z:
            camera = Camera(
                **{f: jnp.asarray(z[f"camera_{f}"]) for f in _CAMERA_FIELDS}
            )
    sharding = NamedSharding(mesh, PartitionSpec("tiles"))
    acc = jax.make_array_from_process_local_data(
        sharding, local, (config.num_pixels, 3)
    )
    return acc, sample_count, next_key, scene, config, camera


def load(path: str):
    """Read a snapshot -> (RenderState, Scene, RenderConfig, Camera | None).

    The camera is None for snapshots written without one (format v1)."""
    with np.load(path) as z:
        version = int(z["version"])
        assert 1 <= version <= _FORMAT_VERSION, f"unknown snapshot version {version}"
        cfg = json.loads(bytes(z["config_json"].tobytes()).decode())
        # Forward/backward compatible: ignore fields RenderConfig no longer
        # has; fields a v1/v2 snapshot lacks take their defaults.
        known = {f.name for f in dataclasses.fields(RenderConfig)}
        config = RenderConfig(**{k: v for k, v in cfg.items() if k in known})
        state = RenderState(
            accum=jnp.asarray(z["accum"]),
            sample_count=jnp.asarray(z["sample_count"], jnp.int32),
            next_key=jnp.asarray(z["next_key"]),
        )
        scene = Scene(
            **{f: jnp.asarray(z[f"scene_{f}"]) for f in _SCENE_FIELDS},
            plane=jnp.asarray(z["scene_plane"]) if "scene_plane" in z else None,
        )
        camera = None
        if f"camera_{_CAMERA_FIELDS[0]}" in z:
            camera = Camera(
                **{f: jnp.asarray(z[f"camera_{f}"]) for f in _CAMERA_FIELDS}
            )
    return state, scene, config, camera
