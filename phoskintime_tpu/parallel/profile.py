"""Profiling and compilation-cache utilities.

Spec: reference auxiliary surface (SURVEY.md §5) — the reference has only
Numba disk caches (``cache=True`` + a CLI ``clean``); the accelerator
equivalents are ``jax.profiler`` traces and the XLA persistent compilation
cache.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

# the checkout root (the directory holding the package); caches and
# traces stay inside it, in directories .gitignore lists
CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def jnp_zero():
    import jax.numpy as jnp

    return jnp.zeros(())


def compilation_cache_dir() -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else :data:`DEFAULT_CACHE_DIR` — a fixed path, since
    the path is part of the cache's key and a moving directory never
    hits."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(DEFAULT_CACHE_DIR))


def enable_compilation_cache() -> str:
    """Persistent XLA compile cache (amortizes the first compile of each
    program shape). When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    reads it and this sets no other directory. Returns the directory, or
    "" when ``PHOSKINTIME_DISABLE_COMPILE_CACHE`` is set (the test suite:
    serialized CPU executables have crashed it)."""
    import jax

    if os.environ.get("PHOSKINTIME_DISABLE_COMPILE_CACHE"):
        return ""
    cache_dir = compilation_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``with trace(): ...`` captures a jax.profiler trace (default: the
    checkout's ``traces/`` directory)."""
    import jax

    log_dir = log_dir or str(CHECKOUT / "traces")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, logger=None):
    """Wall-clock timer that blocks on device completion."""
    import jax

    t0 = time.perf_counter()
    yield
    try:
        # effects_barrier only waits for EFFECTFUL computations; pure
        # async-dispatched jits are awaited by queueing a trivial op on
        # the default device (in-order execution) and blocking on it
        jax.effects_barrier()
        jax.block_until_ready(jnp_zero())
    except Exception:
        pass
    dt = time.perf_counter() - t0
    msg = f"[timing] {label}: {dt:.3f}s"
    (logger.info if logger else print)(msg)
