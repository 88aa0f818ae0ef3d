"""Per-gene Morris sensitivity analysis.

Spec: reference ``sensitivity/analysis.py:197-331`` — Morris sample around
the fitted parameters (+/-50% default), one ODE solve per sample (the
reference fans out to a ProcessPoolExecutor over all cores), scalar Y
metric, Morris analyze at conf_level=0.99 (scaled), and the top-K
closest-RMSE trajectories kept for perturbation-cloud plots.

Accelerator-native: the full (r*(d+1)) design solves as ONE vmapped exact-LTI
batch; Y metrics and RMSE ranking are vectorized.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phoskintime_tpu.models.kinetics import solve_ode_batched
from phoskintime_tpu.ops.morris import (
    MorrisResult,
    compute_bound,
    morris_analyze,
    morris_sample,
)


class SensitivityOutput(NamedTuple):
    morris: MorrisResult
    param_names: list[str]
    samples: np.ndarray          # (n_samples, d) design
    Y: np.ndarray                # (n_samples,) scalar metric
    top_solutions: np.ndarray    # (K, T, d_state) closest-RMSE trajectories
    top_indices: np.ndarray


def sensitivity_analysis(popt: np.ndarray,
                         init_cond: np.ndarray,
                         num_psites: int,
                         time_points: np.ndarray,
                         target: np.ndarray,
                         model: str = "distmod",
                         perturbation: float = 0.5,
                         num_trajectories: int = 1000,
                         num_levels: int = 400,
                         y_metric: str = "total_signal",
                         conf_level: float = 0.99,
                         top_k: int | None = None,
                         param_names: list[str] | None = None,
                         seed: int = 42,
                         batch_size: int = 4096) -> SensitivityOutput:
    """Morris sweep over one gene's fitted parameters, fully batched."""
    popt = np.asarray(popt, float)
    d = len(popt)
    bounds = np.asarray([compute_bound(v, perturbation) for v in popt])
    rng = np.random.default_rng(seed)
    X = morris_sample(bounds, num_trajectories, num_levels, rng)

    t = jnp.asarray(time_points, float)
    y0 = jnp.asarray(init_cond, float)

    # fixed-size padded chunks: one compile for the whole sweep
    solve_chunk = jax.jit(lambda xb: solve_ode_batched(xb, y0, num_psites,
                                                       t, model))
    n_total = len(X)
    sols_list, fits_list = [], []
    for i in range(0, n_total, batch_size):
        chunk = X[i:i + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.vstack([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        sols, fits = solve_chunk(jnp.asarray(chunk))
        sols_list.append(np.asarray(sols)[: batch_size - pad or None])
        fits_list.append(np.asarray(fits)[: batch_size - pad or None])
    sols = np.concatenate(sols_list)[:n_total]
    fits = np.concatenate(fits_list)[:n_total]

    # scalar metric per sample (vectorized trajectory_metric)
    if y_metric == "total_signal":
        Y = sols.sum(axis=(1, 2))
    elif y_metric in ("mean_activity", "mean"):
        Y = sols.mean(axis=(1, 2))
    elif y_metric == "variance":
        Y = sols.var(axis=(1, 2))
    elif y_metric == "dynamics":
        Y = (np.diff(sols, axis=1) ** 2).sum(axis=(1, 2))
    elif y_metric == "l2_norm":
        Y = np.sqrt((sols ** 2).sum(axis=(1, 2)))
    else:
        raise ValueError(f"Unknown y_metric {y_metric}")

    res = morris_analyze(bounds, X, Y, num_levels, conf_level=conf_level,
                         seed=seed)

    # top-K approx N*10/levels closest-RMSE curves (reference :221-291)
    if top_k is None:
        top_k = max(1, num_trajectories * 10 // num_levels)
    rmse = np.sqrt(np.mean((fits - np.asarray(target)[None]) ** 2, axis=1))
    top_idx = np.argsort(rmse, kind="stable")[:top_k]

    if param_names is None:
        param_names = [f"p{i}" for i in range(d)]
    return SensitivityOutput(res, param_names, X, Y, sols[top_idx], top_idx)
