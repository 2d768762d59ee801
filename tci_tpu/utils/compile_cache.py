"""Where JAX keeps its persistent compilation cache for this checkout's
scripts and tests."""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache(dirname: str = ".jax_cache") -> str:
    """Point JAX's persistent compilation cache at a stable directory and
    return it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to ``<checkout>/<dirname>`` (a
    path listed in ``.gitignore``): a fixed path, because the directory is
    part of what a later process must find again.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, dirname)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
