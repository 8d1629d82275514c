"""Persistent JAX compilation cache location, shared by every entry point.

`$JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache lives
in `<checkout>/.jax_cache` (listed in .gitignore). A fixed path matters:
the path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir(default_name: str = ".jax_cache") -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, default_name
    )


def enable(default_name: str = ".jax_cache",
           min_compile_secs: float = 0.0) -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`; returns
    the directory."""
    import jax

    path = cache_dir(default_name)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path
