"""Exact solution of linear time-invariant ODE systems.

The per-gene kinetic models of the reference (``models/distmod.py``,
``models/succmod.py``, ``models/randmod.py``) are all *linear* ODEs
``dy/dt = M y + b`` with constant ``M``/``b``. The reference integrates them
with LSODA thousands of times inside ``curve_fit``; here we instead solve
them **exactly** with matrix exponentials:

    d/dt [y; 1] = [[M, b], [0, 0]] [y; 1]   =>   y(t) = (expm(A t) [y0; 1])[:d]

State dimensions are tiny (<= 2 + 2^n), so a whole batch of
(genes x starts x weights x lambdas x timepoints) exponentials is one big
batched Pade-expm — dense small matmuls that XLA tiles onto the matrix units.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import expm


def affine_augment(M: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Embed dy = M y + b into the homogeneous (d+1)-dim system."""
    d = M.shape[-1]
    A = jnp.zeros(M.shape[:-2] + (d + 1, d + 1), dtype=M.dtype)
    A = A.at[..., :d, :d].set(M)
    A = A.at[..., :d, d].set(b)
    return A


def solve_lti(M: jnp.ndarray, b: jnp.ndarray, y0: jnp.ndarray,
              t: jnp.ndarray) -> jnp.ndarray:
    """Solve dy/dt = M y + b, y(0) = y0 at times ``t`` (shape (T,)).

    Returns ys with shape (T, d). Exact (to expm accuracy), vmap-safe,
    differentiable in both forward and reverse mode.

    Times are propagated *sequentially* over the sorted grid
    (y_{k+1} = expm(M dt_k) applied to y_k) so each expm argument has a
    small norm — fewer Pade squarings and better conditioning than
    expm(M * 960) directly.
    """
    d = M.shape[-1]
    A = affine_augment(M, b)
    z0 = jnp.concatenate([y0, jnp.ones((1,), dtype=y0.dtype)])

    ts = jnp.concatenate([jnp.zeros((1,), dtype=t.dtype), t])
    dts = jnp.diff(ts)  # (T,)

    def step(z, dt):
        E = expm(A * dt)
        z_next = E @ z
        return z_next, z_next[:d]

    _, ys = jax.lax.scan(step, z0, dts)
    return ys


def solve_lti_batched(Ms: jnp.ndarray, bs: jnp.ndarray, y0s: jnp.ndarray,
                      t: jnp.ndarray) -> jnp.ndarray:
    """vmap of :func:`solve_lti` over a leading batch axis."""
    return jax.vmap(solve_lti, in_axes=(0, 0, 0, None))(Ms, bs, y0s, t)
