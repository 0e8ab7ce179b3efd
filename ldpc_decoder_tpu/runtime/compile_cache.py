"""One persistent XLA compile cache for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and no
other cache is configured here. Otherwise the cache lives at a fixed
``.jax_cache`` beside the package (git-ignored): a fixed path keeps cache
keys stable between runs, so a rerun finds its compiled programs.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
