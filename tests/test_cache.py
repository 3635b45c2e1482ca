"""Where the persistent compile cache lands: JAX_COMPILATION_CACHE_DIR when
it is set (and nothing else is configured in code), else <repo>/.jax_cache."""

import os

import jax

from simplepathtracer_tpu import _cache


def test_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _cache.cache_dir() == os.path.join(repo, ".jax_cache")
    old = jax.config.jax_compilation_cache_dir
    try:
        assert _cache.enable_compilation_cache() == _cache.REPO_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == _cache.REPO_CACHE_DIR
        assert os.path.isdir(_cache.REPO_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _cache.cache_dir() == str(tmp_path)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert _cache.enable_compilation_cache() == str(tmp_path)
        # No directory is set in code: JAX reads the variable itself.
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
