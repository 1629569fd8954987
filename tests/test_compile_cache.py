"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set, and a fixed <checkout>/.jax_cache otherwise."""

import os

import jax
import pytest

from binary_image_compression_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_environment(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; nothing in code overrides it
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(compile_cache.CHECKOUT, ".jax_cache")
    assert os.path.exists(os.path.join(compile_cache.CHECKOUT, "chip_smoke.py"))
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable() == path       # the same on every call
