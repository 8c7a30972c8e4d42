"""Where JAX keeps its persistent compilation cache for this checkout."""

from __future__ import annotations

import os

__all__ = ["use_checkout_cache"]

CACHE_DIRNAME = ".jax_cache"


def use_checkout_cache(root) -> str:
    """Point JAX's compilation cache at ``<root>/.jax_cache``, unless
    ``JAX_COMPILATION_CACHE_DIR`` is set, in which case JAX already uses
    that directory and nothing is changed.  Returns the directory in use.

    The path is fixed, so a later process in the same checkout finds what
    an earlier one compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(os.path.abspath(root), CACHE_DIRNAME)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
