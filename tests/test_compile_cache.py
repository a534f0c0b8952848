"""The entry points' persistent compilation cache (utils/cache.py)."""
import jax

from gridapsolvers_tpu.utils import cache


def test_cache_defaults_to_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == str(cache.CHECKOUT_CACHE_DIR)
        assert cache.CHECKOUT_CACHE_DIR.parent.joinpath(
            "gridapsolvers_tpu"
        ).is_dir()
        assert cache.CHECKOUT_CACHE_DIR.name == ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_env_var_is_left_alone(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        # nothing set in code: the config keeps whatever JAX read itself
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
