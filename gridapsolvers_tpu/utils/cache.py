"""Persistent XLA compilation cache shared by the entry points.

Every entry point (chip_smoke.py, bench.py, __graft_entry__, the
weak-scaling CLI) calls `enable_compile_cache()` before its first
compile, so a second run of the same program on the same machine loads
its executables instead of compiling them again.

- If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it: nothing is
  set here, and the cache lives where the variable says.
- Otherwise the cache goes to the fixed directory `.jax_cache` at the
  root of the checkout. The path is part of the cache key, so it is
  never derived from a temporary name, a pid or the time.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
