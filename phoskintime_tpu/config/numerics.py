"""Numeric policy for the framework.

The reference stack is float64 SciPy. An H100 computes f64 natively, at
67 TFLOP/s against 67 TFLOP/s of non-tensor-core f32 (NVIDIA data sheet,
SXM) — but f32 halves the bytes every lane moves, and the batched
integrators are bandwidth-bound. We therefore make the working dtype a
policy:

* On CPU (tests, parity checks) enable x64 and run float64 — this is how we
  match the reference to 1e-6 rtol.
* On the GPU default to float32 (the integrators use compensated summation
  and PI step-size control, so 1e-5/1e-7 optimization tolerances are
  attainable), with an opt-in to x64 when bit-accuracy matters more than
  speed. The GPU's native f64 is also the on-card reference that
  ``chip_smoke.py`` compares the f32 path against.

Use :func:`working_dtype` everywhere instead of hard-coding a dtype.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_FORCE: str | None = os.environ.get("PHOSKINTIME_DTYPE")  # "float32"|"float64"

# Honor the env override EAGERLY (this module is imported by the package
# __init__): flipping x64 lazily at first working_dtype() call left any
# arrays/programs traced earlier in the process at f32 semantics, silently
# mixing precisions (advisor r2 finding).
if _FORCE == "float64":
    jax.config.update("jax_enable_x64", True)


def enable_x64() -> None:
    """Turn on float64 globally (call before any tracing)."""
    jax.config.update("jax_enable_x64", True)


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def working_dtype() -> jnp.dtype:
    """The framework-wide float dtype.

    float64 when x64 is enabled (CPU parity mode), float32 otherwise
    (GPU production mode). Overridable via PHOSKINTIME_DTYPE.
    """
    if _FORCE == "float64":
        # without x64 enabled, jnp silently downcasts float64 arrays to
        # f32 — honor the override by enabling x64 (review finding)
        if not x64_enabled():
            jax.config.update("jax_enable_x64", True)
        return jnp.float64
    if _FORCE == "float32":
        return jnp.float32
    return jnp.float64 if x64_enabled() else jnp.float32


def asf(x):
    """Convert to the working float dtype."""
    return jnp.asarray(x, dtype=working_dtype())
