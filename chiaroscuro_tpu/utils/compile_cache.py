"""Persistent XLA compilation cache at a fixed path.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
else is set here.  Otherwise the cache goes to ``.jax_cache/`` at the root
of the checkout (git-ignored).  The path is part of what makes a cached
program found again, so it never depends on a temporary name, a pid or
the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
