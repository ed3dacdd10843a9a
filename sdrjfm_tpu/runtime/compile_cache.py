"""Placement of JAX's persistent compile cache.

The receiver's step takes tens of seconds to compile at the default
geometry, so entry points (the CLI, bench.py, chip_smoke.py) keep compiled
programs on disk.  Importing this module changes nothing; call
`enable_compile_cache()` from an entry point.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# a fixed path: the cache directory is part of what a later process must
# find again, so it is never derived from a temporary name, pid or time
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Return the compile-cache directory in use, setting it if needed.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to `<checkout>/.jax_cache`.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
