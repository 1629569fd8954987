"""JAX's persistent compilation cache, at one fixed place per checkout.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, nothing here
overrides it.  Otherwise the cache lives in <checkout>/.jax_cache — a fixed
path, because the path is part of what a later run must find again."""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable(checkout: str = CHECKOUT) -> str:
    """Turn the cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(checkout, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
