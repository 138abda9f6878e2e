"""The persistent compilation cache stays where ltjax.compile_cache
puts it: JAX_COMPILATION_CACHE_DIR when set, else a fixed directory in
the checkout."""

import os

import jax
import pytest

from ltjax import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_env_dir_is_honoured(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_dir_is_in_the_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure(min_compile_secs=2.0)
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0
    gitignore = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in gitignore
