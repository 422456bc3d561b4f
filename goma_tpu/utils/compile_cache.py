"""Persistent XLA compilation cache (the compile-time story).

The reference is an AOT-compiled C binary — its "warmup" is `make`. Here
every jitted Newton/assembly program compiles on first trace, so compiled
executables are persisted across processes: the second run of any
bench/deck config warms up from disk.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, and nothing here overrides it); otherwise
``<checkout>/.jax_cache``, a fixed path that ``.gitignore`` lists.

Call :func:`enable_compile_cache` once, before the first jit dispatch, from
every entry point (CLI ``__main__``, ``bench.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the repository root holding this package."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 2.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory
    (created if missing). Safe to call repeatedly."""
    import jax

    d = os.environ.get(ENV_VAR)
    if not d:
        d = default_cache_dir()
        jax.config.update("jax_compilation_cache_dir", d)
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
