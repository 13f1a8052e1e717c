"""Persistent compilation cache location.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is unset the entry
points (cli.main, bench.py, chip_smoke.py) keep the cache at a fixed
<repo>/.jax_cache (ignored by git), so repeated runs from one checkout
reuse compiled programs.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at JAX_COMPILATION_CACHE_DIR if set,
    else at CACHE_DIR; returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
