"""Shared example bootstrap.

The walkthroughs are demonstrations, not benchmarks: they default to the
CPU backend so ``python examples/<name>.py`` works on any rig — including
ones whose environment pins an accelerator platform (e.g. a site
customization setting ``jax_platforms`` programmatically, where the
``JAX_PLATFORMS`` env var alone would be silently overridden).  Set
``SITATOR_EXAMPLES_PLATFORM=gpu`` (or any platform name) to run an
example on real hardware instead.
"""
import os
import sys


def _ensure_importable():
    """Running from a source checkout without installing: put the repo
    root (this file's parent's parent) on sys.path."""
    try:
        import sitator_tpu  # noqa: F401
    except ImportError:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))


def default_to_cpu():
    """Pin the JAX backend for this example (default: cpu).

    Call before any real JAX work.  Sets both the env var (covers a jax
    imported later) and, if jax is importable, the config value (covers
    environments that re-pin the platform at import time).
    """
    _ensure_importable()
    platform = os.environ.get("SITATOR_EXAMPLES_PLATFORM", "cpu")
    os.environ["JAX_PLATFORMS"] = platform
    try:
        import jax
        jax.config.update("jax_platforms", platform)
    except ImportError:  # pragma: no cover - jax is a hard dep anyway
        pass
    return platform
