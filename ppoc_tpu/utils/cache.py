"""Persistent XLA compilation cache.

The reference pays its compile cost once, at nvcc build time (Makefile:1-5);
our analogue of that ahead-of-time build is the XLA persistent compilation
cache: the first process compiles each (program, shapes, backend) once and
every later process — bench reruns, CLI restarts, supervisor respawns after a
crash (utils/supervisor.py) — deserializes the executable instead of paying
the trace+compile again.  Entry points opt in via
``enable_compilation_cache()``; the library never flips global config behind
an importer's back.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, so nothing is set in code), else the fixed directory
``.jax_cache`` at the root of the checkout.  The path is part of what makes
a later process find an entry, so it never moves with the user or the
working directory.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses (see the module docstring)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def _cpu_only() -> bool:
    import jax

    plat = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    return plat.split(",")[0] == "cpu"


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns its directory.

    CPU-only processes (the test suite, CPU rehearsals) run uncached:
    XLA:CPU entries bake compile-time machine features and flags into the
    executable but not into the cache key, and CPU compiles take seconds —
    the cache exists for the GPU's.  Safe to call more than once.
    """
    import jax

    if _cpu_only():
        return None
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # cache every real compile: the default 1 s floor would skip the small
    # eval/checkpoint programs whose compiles still add up
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir()
