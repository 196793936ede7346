"""Persistent XLA compilation cache shared by the entry points.

A cold start compiles the production train step from scratch; with the
cache, a later process that builds the same programs loads them instead.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

# fixed, so that every process of this checkout finds what earlier ones wrote
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here. Otherwise the cache lives in `<repo>/.jax_cache`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
