"""Where the persistent XLA compilation cache lives — decided in one place.

Every entry point (the CLI, bench.py, chip_smoke.py, scripts/*) calls
`enable()` once before its first compile. If `JAX_COMPILATION_CACHE_DIR` is
set, JAX already reads it and this module sets no other directory. Otherwise
the cache is one fixed directory inside the checkout (`<repo>/.jax_cache`,
listed in .gitignore): the path is part of what a later process must find, so
it is never built from a temp name, a pid or the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache (and the prewarm journal) uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent cache for every compiled program; returns its
    directory."""
    import jax

    d = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return d
