"""Where the persistent compilation cache goes."""

import jax
import pytest

from matten_tpu.utils.compile_cache import REPO_CACHE_DIR, enable_compile_cache


@pytest.fixture
def cache_config(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield monkeypatch
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_is_set(cache_config, tmp_path):
    cache_config.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_unset_env_uses_the_fixed_repo_directory(cache_config):
    assert enable_compile_cache() == str(REPO_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == str(REPO_CACHE_DIR)
    assert REPO_CACHE_DIR.name == ".jax_cache"
    assert (REPO_CACHE_DIR.parent / "chip_smoke.py").exists()
