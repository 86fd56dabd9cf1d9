"""JAX's persistent compilation cache, kept in one fixed place.

A 1080p encode step takes tens of seconds to compile; the cache lets a
later process of the same checkout load the compiled program instead.
Every entry point that compiles (the CLI, the `api` functions,
chip_smoke.py) calls `enable_compile_cache` first.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is changed.  Otherwise the cache goes to `.jax_cache/` at the checkout
    root: a fixed path, never one built from a temporary name, a PID or
    the time, so that every run of this checkout finds what earlier runs
    stored."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
