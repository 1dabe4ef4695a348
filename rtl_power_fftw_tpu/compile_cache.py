"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, the benchmarks, the chip smoke run) calls
``configure_compile_cache`` before its first JAX call, so repeated runs
from one checkout reuse each other's compiled programs.
"""

from __future__ import annotations

import os

#: The fixed cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: ``.jax_cache`` at the root of the checkout that holds this
#: package (listed in ``.gitignore``). Never a temp dir, pid or time —
#: a directory that moves between runs never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Return the persistent compilation cache directory in use.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and this
    touches nothing; otherwise JAX is pointed at ``CACHE_DIR`` and keeps
    every compiled program there (a session's steps each compile in
    well under JAX's default one-second threshold for caching).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return CACHE_DIR
