"""Regression tests for the round-3 ADVICE.md fixes: accumulate's
largest-divisor spp-chunk fallback (live-preview auto chunks), fit-snapshot
version validation, and graceful re-init of an already-initialized
jax.distributed client.
"""

import numpy as np
import pytest

import jax

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse
from simplepathtracer_tpu.render import accumulate, init_state


def test_accumulate_nondivisible_spp_chunk():
    """ADVICE r2 #2: accumulate asserted n_samples % spp_chunk == 0, so the
    CLI's auto-picked live-preview chunk could crash mid-render.  It now
    falls back to the largest divisor, like render_pixel_block."""
    scene = spt.three_sphere_scene()
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    cfg = spt.RenderConfig(width=8, height=8, spp=7, max_depth=2, spp_chunk=3)
    state = init_state(cfg, jax.random.PRNGKey(0))
    state = accumulate(state, scene, cam, cfg, 7)  # 7 % 3 != 0
    assert int(state.sample_count) == 7
    # Bit-identical to the unchunked render (chunking cannot change values:
    # randomness is keyed by global (pixel, sample) ids).
    ref = accumulate(init_state(cfg, jax.random.PRNGKey(0)), scene, cam,
                     cfg.replace(spp_chunk=0), 7)
    np.testing.assert_array_equal(np.asarray(state.accum), np.asarray(ref.accum))


def test_fit_snapshot_version_check(tmp_path):
    """ADVICE r2 #5: a wrong-version fit snapshot must raise ValueError with
    the version and path (was a bare assert, stripped under -O)."""
    scene = spt.three_sphere_scene()
    params, _ = inverse.split_params(scene, ("albedo",))
    opt_state = inverse.make_optimizer().init(params)
    path = str(tmp_path / "fit.npz")
    inverse._save_fit_state(path, params, opt_state, 3, [1.0, 0.5])
    # Round-trip works.
    p2, o2, step, losses = inverse._load_fit_state(path, params, opt_state)
    assert step == 3 and losses == [1.0, 0.5]
    # Corrupt the version.
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["version"] = np.int64(99)
    np.savez(path, **data)
    with pytest.raises(ValueError, match=r"version 99.*fit\.npz"):
        inverse._load_fit_state(path, params, opt_state)


def test_initialize_cluster_tolerates_already_initialized(monkeypatch):
    """ADVICE r2 #3: if the private client probe misses an already-active
    client, initialize_cluster must swallow exactly the already-initialized
    RuntimeError and re-raise anything else."""
    from simplepathtracer_tpu.parallel import distributed

    monkeypatch.setattr(distributed, "_distributed_client_active", lambda: False)

    calls = {}

    def fake_init(**kw):
        calls["kw"] = kw
        raise RuntimeError("Distributed system is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    distributed.initialize_cluster("localhost:1234", 1, 0)  # must not raise
    assert calls["kw"]["coordinator_address"] == "localhost:1234"

    def fake_init_bad(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", fake_init_bad)
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.initialize_cluster("localhost:1234", 1, 0)
