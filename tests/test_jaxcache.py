"""Compile-cache location rule (runtime/jaxcache.py): JAX's own
``JAX_COMPILATION_CACHE_DIR`` wins and the code sets no other path;
without it the cache is a fixed directory inside the checkout."""

import pathlib

import pytest

from zstd_tpu.runtime import jaxcache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def fresh_cache_setup(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jaxcache, "_done", False)
    yield jax
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured(fresh_cache_setup, monkeypatch, tmp_path):
    jax = fresh_cache_setup
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    # JAX reads the variable itself when it starts; stand in for that.
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jaxcache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_fixed_path_in_checkout(fresh_cache_setup, monkeypatch):
    jax = fresh_cache_setup
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxcache.enable_compilation_cache()
    got = pathlib.Path(jax.config.jax_compilation_cache_dir)
    assert got == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
