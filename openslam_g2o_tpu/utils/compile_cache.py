"""Persistent XLA compilation cache wiring.

The incremental engine compiles its solve program once per shape bucket
(core/online.py), and the batch paths compile once per problem shape. JAX's
persistent compilation cache serializes those executables to disk keyed on
the HLO, so a later process on the same machine loads them instead of
compiling again.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set, and
otherwise one fixed directory inside the checkout (`.cache/xla`, listed in
`.gitignore`). The path is part of what makes a later run hit, so it is
never derived from a temporary directory, a pid or the time.

Enabled by OnlineOptimizer, the CLI and chip_smoke.py; a cache directory
the caller already configured through jax.config is left alone.
"""
from __future__ import annotations

import os

__all__ = ["enable_persistent_cache", "default_cache_dir", "cache_dir"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir() -> str:
    """The fixed in-checkout cache directory."""
    return os.path.join(_CHECKOUT, ".cache", "xla")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the default."""
    return os.environ.get(_ENV) or default_cache_dir()


def enable_persistent_cache(backend: str | None = None) -> str | None:
    """Point the JAX persistent compilation cache at cache_dir().

    No-op on the CPU backend (its compiles are fast, and XLA:CPU warns on
    every reload of a cached executable about machine-feature mismatches)
    and when the directory cannot be created. Returns the active dir or
    None."""
    import jax

    if (backend or jax.default_backend()) == "cpu":
        return None
    current = jax.config.jax_compilation_cache_dir
    if current and not os.environ.get(_ENV):
        return current
    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    # cache every executable: the online path's programs are exactly the
    # small-but-slow-to-compile kind the default thresholds skip
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
