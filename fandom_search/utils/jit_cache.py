"""Persistent XLA compilation cache setup.

The engine compiles one fused program per stream bucket
(search/engine.py _batches), and a cold compile of the full-size
program takes a while.  JAX's persistent cache amortizes that across
processes — the second `fandomsearch search` run pays no compile time.
Shared by the CLI and the bench harness.

The rule: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets nothing.  Otherwise the cache lives in
``<checkout>/.jax_cache`` — a fixed path, so runs from one checkout
find each other's entries (the path is part of the cache key).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

log = logging.getLogger(__name__)

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> Path:
    """``<checkout>/.jax_cache``: the directory holding the package."""
    return Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> Path | None:
    """Point jax at the on-disk compilation cache; returns its path.

    Returns the environment's directory untouched when
    ``JAX_COMPILATION_CACHE_DIR`` is set, and None (cache left off)
    when the default directory cannot be created.  Must run before the
    first jit compilation (jax may already be imported).
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    import jax

    cache = default_cache_dir()
    try:
        cache.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        log.warning("no compilation cache: cannot create %s (%s)", cache, e)
        return None
    jax.config.update("jax_compilation_cache_dir", str(cache))
    return cache
