"""Persistent XLA compilation cache, shared by every entry point
(chip_smoke.py, bench.py, the CLI, the study drivers and the test
harness).

Entries are keyed by the hash of the compiled program, so a stale entry is
a miss and never a wrong result."""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".xla_cache",
)


def enable_persistent_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets no directory. Otherwise the cache goes to the checkout's fixed
    ``.xla_cache`` (listed in .gitignore): a directory that moved from run
    to run would never hit.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
