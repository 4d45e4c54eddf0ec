"""The one place that chooses the persistent compile-cache directory."""

import os

import jax

from noize_tpu.utils import compile_cache as CC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert CC.cache_dir() == str(tmp_path)


def test_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = CC.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert CC.cache_dir() == path  # no per-call or per-process component
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_enable_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert CC.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
