"""Test environment: the CPU backend with 8 virtual devices by default.

This is the SURVEY.md S4 "distributed-without-a-cluster" pattern: sharding
tests run on a fake 8-device CPU mesh so multi-device code paths are
exercised on any machine.  The settings only apply when JAX has not been
imported yet; a process that already runs JAX on the GPU (chip_smoke.py
runs the ``gpu``-marked tests in-process) keeps its backend.

Tests that need the card carry ``@pytest.mark.gpu``; the fixture below
skips them when JAX's first device is not a GPU.
"""

import gc
import os
import sys

import pytest

if "jax" not in sys.modules:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Single-process full-suite stability.

    A full `pytest tests` run in ONE process used to segfault inside
    XLA:CPU's backend_compile_and_load around test ~100 of the suite
    (cumulative compiler/executable state — every shard passes in
    isolation).  Dropping compiled executables and live jaxprs between
    test MODULES keeps the compiler's working set bounded; per-module (not
    per-test) so intra-module jit caching still amortizes tracing.
    """
    yield
    import jax

    jax.clear_caches()
    gc.collect()
