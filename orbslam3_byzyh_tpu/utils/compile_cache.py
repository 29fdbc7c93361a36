"""Persistent XLA compilation cache shared by every entry point.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` by itself; when it is set, nothing
is configured here. Otherwise the cache lives at the fixed ``<repo>/.jax_cache``
(listed in .gitignore): the directory is part of the cache key, so it must
not move between runs.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
