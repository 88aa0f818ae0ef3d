"""vmap-safe adaptive Dormand-Prince RK45 integrator with dense output.

Behavioral spec from the reference's custom Numba solver
(``global_model/solvers.py:29-758``): FSAL, PI step-size controller
(beta = 0.04), stepping clamped to the bucket boundaries of the
piecewise-constant kinase input K(t) (with k1 re-evaluated after a
discontinuity), cubic Hermite dense output at ``t_eval``, dt within
[dt_min, dt_max], bounded step count.

Accelerator-native design differences:

* The whole integration is one ``lax.while_loop`` — each *batch lane*
  (e.g. each candidate parameter vector of an optimizer population) carries
  its own (t, dt, error, bucket) state, so a ``vmap`` over candidates yields
  a single SPMD program where finished lanes idle until the batch completes.
* Discontinuities of the piecewise-constant input are handled *exactly*:
  the active bucket index is part of the loop carry and is passed to the
  RHS, so no stage evaluation ever samples the wrong side of a boundary and
  the error estimate stays clean. When a step lands on a boundary, time is
  snapped to it exactly and the FSAL derivative is re-evaluated in the new
  bucket (mirroring solvers.py:399-432 without floating-point hazards).
* Dense output is written by a masked vectorized fill: after every accepted
  step, all requested output times inside (t, t+dt] are interpolated at once
  (output grids here are <= ~30 points, so this beats cursor bookkeeping).
* No data-dependent Python control flow; all shapes static.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

# Dormand-Prince 5(4) tableau.
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
_E = tuple(b5 - b4 for b5, b4 in zip(_B5, _B4))

_ORDER = 5.0
_SAFETY = 0.9
_BETA = 0.04                      # PI controller integral gain (reference solvers.py:373)
_ALPHA = 1.0 / _ORDER - 0.75 * _BETA
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class ODEResult(NamedTuple):
    ys: jnp.ndarray          # (T, d) dense output at t_eval
    success: jnp.ndarray     # () bool
    n_steps: jnp.ndarray     # () int32 accepted + rejected steps
    n_accepted: jnp.ndarray  # () int32


def _hermite(t, t0, t1, y0, y1, f0, f1):
    """Cubic Hermite interpolant on [t0, t1] (reference solvers.py:541-544)."""
    h = t1 - t0
    s = jnp.where(h > 0, (t - t0) / jnp.where(h == 0, 1.0, h), 0.0)
    s = jnp.clip(s, 0.0, 1.0)
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s ** 2 * (3 - 2 * s)
    h11 = s ** 2 * (s - 1)
    s_ = lambda a: a[..., None] if jnp.ndim(t) == 1 else a
    return (s_(h00) * y0 + s_(h10) * (h * f0) + s_(h01) * y1 + s_(h11) * (h * f1))


def _initial_dt(rhs, t0, y0, f0, jb, rtol, atol, dt_min, dt_max):
    """Hairer-style starting step heuristic (two trial evaluations)."""
    scale = atol + jnp.abs(y0) * rtol
    d0 = jnp.sqrt(jnp.mean((y0 / scale) ** 2) + 1e-30)
    d1 = jnp.sqrt(jnp.mean((f0 / scale) ** 2) + 1e-30)
    h0 = jnp.where(d1 > 1e-12, 0.01 * d0 / d1, 1e-6)
    y1 = y0 + h0 * f0
    f1 = rhs(t0 + h0, y1, jb)
    d2 = jnp.sqrt(jnp.mean(((f1 - f0) / scale) ** 2) + 1e-30) / h0
    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(dmax > 1e-15, (0.01 / dmax) ** (1.0 / _ORDER),
                   jnp.maximum(1e-6, h0 * 1e-3))
    return jnp.clip(jnp.minimum(100.0 * h0, h1), dt_min, dt_max)


def odeint_rk45(
    rhs: Callable,
    y0: jnp.ndarray,
    t_eval: jnp.ndarray,
    boundaries: jnp.ndarray | None = None,
    max_steps: int = 100_000,
    rtol: float = 1e-5,
    atol: float = 1e-7,
    dt0: float | None = None,
    dt_min: float = 1e-6,
    dt_max: float = 1.0,
) -> ODEResult:
    """Integrate ``dy/dt = rhs(...)`` from t = 0 with dense output at ``t_eval``.

    Args:
      rhs: ``(t, y) -> dy`` when ``boundaries is None``, else
        ``(t, y, bucket_index) -> dy`` where ``bucket_index`` is the index of
        the active piecewise-constant-input interval
        ``[boundaries[j], boundaries[j+1])``.
      y0: (d,) initial state at t = 0 (the reference always starts at 0).
      t_eval: (T,) strictly increasing output times, all >= 0.
      boundaries: optional (B,) sorted discontinuity times of the input
        signal; steps never straddle one.
      max_steps / rtol / atol / dt_min / dt_max: solver controls
        (reference defaults: dt in [1e-6, 1.0], <= 2e6 steps).
    """
    dtype = y0.dtype
    t_eval = t_eval.astype(dtype)
    t0 = jnp.asarray(0.0, dtype)
    t_end = t_eval[-1]

    if boundaries is None:
        bnds = jnp.asarray([jnp.inf], dtype)
        rhs_b = lambda t, y, jb: rhs(t, y)
        jb0 = jnp.asarray(0, jnp.int32)
    else:
        bnds = jnp.concatenate([boundaries.astype(dtype),
                                jnp.full((1,), jnp.inf, dtype)])
        rhs_b = rhs
        jb0 = jnp.asarray(
            jnp.clip(jnp.searchsorted(bnds, t0, side="right") - 1, 0,
                     bnds.shape[0] - 1), jnp.int32)

    f0 = rhs_b(t0, y0, jb0)
    dt_init = (_initial_dt(rhs_b, t0, y0, f0, jb0, rtol, atol, dt_min, dt_max)
               if dt0 is None else jnp.asarray(dt0, dtype))

    T = t_eval.shape[0]
    ys = jnp.zeros((T, y0.shape[0]), dtype)
    ys = jnp.where((t_eval <= t0)[:, None], y0[None, :], ys)  # outputs at/before t0

    class Carry(NamedTuple):
        t: jnp.ndarray
        y: jnp.ndarray
        f: jnp.ndarray
        dt: jnp.ndarray
        jb: jnp.ndarray
        err_prev: jnp.ndarray
        ys: jnp.ndarray
        n_steps: jnp.ndarray
        n_acc: jnp.ndarray
        failed: jnp.ndarray

    def cond(c: Carry):
        return (c.t < t_end) & (c.n_steps < max_steps) & (~c.failed)

    def body(c: Carry):
        # clamp step to the next input discontinuity and to t_end. The
        # dt_min floor applies ONLY to the controller's free step: a
        # boundary gap smaller than dt_min must be integrated over the
        # ACTUAL gap (flooring dt while snapping t desynchronized state
        # and time by up to dt_min per boundary — caught in review)
        nb = bnds[jnp.minimum(c.jb + 1, bnds.shape[0] - 1)]
        limit = jnp.minimum(nb, t_end)
        dt_free = jnp.maximum(c.dt, dt_min)
        hit = dt_free >= (limit - c.t)
        dt = jnp.where(hit, limit - c.t, dt_free)
        # snap exactly onto the boundary/end when hit
        t_new = jnp.where(hit, limit, c.t + dt)

        k = [c.f]
        for i in range(1, 7):
            ti = c.t + _C[i] * dt
            yi = c.y + dt * sum(_A[i][j] * k[j] for j in range(i))
            k.append(rhs_b(ti, yi, c.jb))
        y_new = c.y + dt * sum(_B5[i] * k[i] for i in range(7))
        err_vec = dt * sum(_E[i] * k[i] for i in range(7))

        scale = atol + rtol * jnp.maximum(jnp.abs(c.y), jnp.abs(y_new))
        err = jnp.sqrt(jnp.mean((err_vec / scale) ** 2) + 1e-300)

        finite = jnp.all(jnp.isfinite(y_new)) & jnp.isfinite(err)
        accept = (err <= 1.0) & finite

        # PI step-size controller
        err_c = jnp.maximum(err, 1e-10)
        factor = _SAFETY * err_c ** (-_ALPHA) * c.err_prev ** _BETA
        factor = jnp.clip(factor, _MIN_FACTOR, _MAX_FACTOR)
        factor = jnp.where(accept, factor, jnp.minimum(factor, 1.0))
        factor = jnp.where(finite, factor, _MIN_FACTOR)
        dt_next = jnp.clip(dt * factor, dt_min, dt_max)

        # dense output for all t_eval inside (t, t_new]
        mask = (t_eval > c.t) & (t_eval <= t_new) & accept
        y_interp = _hermite(t_eval, c.t, t_new, c.y, y_new, c.f, k[6])
        ys_new = jnp.where(mask[:, None], y_interp, c.ys)

        # bucket advance + FSAL.  k7 = rhs(t_new, y_new) in the OLD bucket;
        # crossing a boundary requires a fresh derivative in the new bucket
        # (the reference re-evaluates k1 at discontinuities).
        crossed = accept & hit & (nb <= t_end)
        jb_next = jnp.where(crossed, c.jb + 1, c.jb)
        f_fresh = rhs_b(t_new, y_new, jb_next)
        t_next = jnp.where(accept, t_new, c.t)
        y_next = jnp.where(accept, y_new, c.y)
        f_next = jnp.where(accept, jnp.where(crossed, f_fresh, k[6]), c.f)
        err_prev = jnp.where(accept, err_c, c.err_prev)

        failed = (~finite) & (dt <= dt_min * 1.0000001)

        return Carry(t_next, y_next, f_next, dt_next, jb_next, err_prev, ys_new,
                     c.n_steps + 1, c.n_acc + accept.astype(jnp.int32), failed)

    init = Carry(t0, y0, f0, dt_init, jb0, jnp.asarray(1e-4, dtype), ys,
                 jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                 jnp.asarray(False))
    out = jax.lax.while_loop(cond, body, init)

    success = (out.t >= t_end) & (~out.failed) & jnp.all(jnp.isfinite(out.ys))
    return ODEResult(out.ys, success, out.n_steps, out.n_acc)
