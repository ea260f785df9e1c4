"""Persistent XLA compilation cache.

Cold compiles of the encode/decode programs cost seconds; the persistent
cache makes each a one-time cost per machine.  The CLI, ``bench.py`` and
``chip_smoke.py`` enable it.  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX already reads it and this module sets no other path; otherwise the cache
lives at the fixed ``<repo>/.jax_cache`` (the path is part of what makes a
cache hit, so it must not move between runs).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; idempotent.  Returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
