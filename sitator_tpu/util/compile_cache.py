"""Persistent compilation cache placement for the entry points.

Called by ``chip_smoke.py``, ``bench.py`` and the CLI before their first
compile; the library itself never sets a cache on import.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache", "default_cache_dir"]


def default_cache_dir():
    """``<checkout>/.jax_cache`` — a fixed path (the path is part of the
    cache key, so a moving directory would never hit); gitignored."""
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache():
    """If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here; otherwise point JAX's persistent cache at
    :func:`default_cache_dir`.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
