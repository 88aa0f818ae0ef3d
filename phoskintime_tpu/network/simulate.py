"""Simulation + measurement extraction for the global model.

Spec: reference ``global_model/simulate.py`` — integrate once on the union
time grid, extract fold-change observables per modality (protein total,
RNA, per-site phospho with bitmask aggregation for model 2), normalized by
baseline timepoints (t=0 for protein/phospho, t=4 for RNA), then slice to
the modality grids.

Accelerator-native: the solver is the vmap-safe RK45 with the kinase grid as
bucket boundaries; observables are three dense arrays (R, TOT, PHO) shared
by all mechanisms, which also feed the gather-based loss directly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phoskintime_tpu.ops.integrators import ODEResult, odeint_rk45

EPS = 1e-12


class Observables(NamedTuple):
    R: jnp.ndarray     # (T, N) mRNA
    TOT: jnp.ndarray   # (T, N) total protein
    PHO: jnp.ndarray   # (T, N, Smax) per-site phospho signal
    success: jnp.ndarray


def simulate(system, params, t_eval, rtol=1e-5, atol=1e-7,
             max_steps=5000, y0=None, dt_max=16.0,
             solver: str = "rk45") -> ODEResult:
    """Integrate the padded system; returns Y (T, N*width) dense output.

    solver: "rk45" (explicit Dormand-Prince, default — these networks have
    bounded rates) or "esdirk" (L-stable implicit Kvaerno 4/3 with Newton
    inner solves for stiff parameter regions).
    """
    if y0 is None:
        y0 = system.y0()
    if solver == "expo":
        from phoskintime_tpu.network.expo import exponential_simulate

        return exponential_simulate(system, params, t_eval, y0=y0)
    y0_flat = jnp.asarray(y0).reshape(-1)
    boundaries = jnp.asarray(system.kin_grid)
    rhs = system.rhs_flat(params)
    if solver == "esdirk":
        from phoskintime_tpu.ops.stiff import odeint_esdirk

        return odeint_esdirk(rhs, y0_flat, jnp.asarray(t_eval),
                             boundaries=boundaries, max_steps=max_steps,
                             rtol=rtol, atol=atol, dt_max=dt_max)
    return odeint_rk45(rhs, y0_flat, jnp.asarray(t_eval), boundaries=boundaries,
                       max_steps=max_steps, rtol=rtol, atol=atol, dt_max=dt_max)


def extract_observables(system, Y_flat, success=None) -> Observables:
    """Raw observable signals from the padded trajectory (T, N*width)."""
    topo = system.topo
    T = Y_flat.shape[0]
    Y = Y_flat.reshape(T, topo.N, topo.width)
    R = Y[:, :, 0]
    if topo.model == 2:
        smask = jnp.asarray(topo.state_mask(), Y.dtype)
        X = Y[:, :, 1:] * smask
        TOT = jnp.sum(X, axis=2)
        bits, = _bits(topo)
        PHO = jnp.einsum("tnm,jm->tnj", X, bits,
                         precision=jax.lax.Precision.HIGHEST)
    else:
        msk = jnp.asarray(topo.site_mask(), Y.dtype)
        sites = Y[:, :, 2:] * msk
        TOT = Y[:, :, 1] + jnp.sum(sites, axis=2)
        PHO = sites
    if success is None:
        success = jnp.asarray(True)
    return Observables(R, TOT, PHO, success)


def _bits(topo):
    from phoskintime_tpu.network.rhs import _hypercube_tables
    bits, _ = _hypercube_tables(topo.max_sites)
    return (jnp.asarray(bits),)


def fold_changes(obs: Observables, times: jnp.ndarray,
                 t0_prot=0.0, t0_rna=4.0, t0_pho=0.0):
    """FC-normalized observables (reference simulate.py:111-182)."""
    times = jnp.asarray(times)
    prot_b = jnp.argmin(jnp.abs(times - t0_prot))
    rna_b = jnp.argmin(jnp.abs(times - t0_rna))
    pho_b = jnp.argmin(jnp.abs(times - t0_pho))

    fc = lambda sig, b: (jnp.maximum(sig, EPS)
                         / jnp.maximum(sig[b][None], EPS))
    return fc(obs.R, rna_b), fc(obs.TOT, prot_b), fc(obs.PHO, pho_b)


def simulate_and_measure(system, params, t_points_p, t_points_r, t_points_pho,
                         rtol=1e-5, atol=1e-7, max_steps=5000, y0=None):
    """Full reference-parity measurement: returns three tidy DataFrames
    [protein, (psite,), time, pred_fc] sliced to the modality grids."""
    import pandas as pd

    times = np.unique(np.concatenate([np.asarray(t_points_p, float),
                                      np.asarray(t_points_r, float),
                                      np.asarray(t_points_pho, float)]))
    res = simulate(system, params, jnp.asarray(times), rtol=rtol, atol=atol,
                   max_steps=max_steps, y0=y0)
    obs = extract_observables(system, res.ys, res.success)
    fc_r, fc_p, fc_pho = fold_changes(obs, times)
    fc_r, fc_p, fc_pho = np.asarray(fc_r), np.asarray(fc_p), np.asarray(fc_pho)

    topo = system.topo
    rows_p, rows_r, rows_pho = [], [], []
    for i, gene in enumerate(topo.proteins):
        rows_r.append(pd.DataFrame({"protein": gene, "time": times,
                                    "pred_fc": fc_r[:, i]}))
        rows_p.append(pd.DataFrame({"protein": gene, "time": times,
                                    "pred_fc": fc_p[:, i]}))
        for s_idx, psite in enumerate(topo.sites[i]):
            rows_pho.append(pd.DataFrame({"protein": gene, "psite": psite,
                                          "time": times,
                                          "pred_fc": fc_pho[:, i, s_idx]}))

    df_p = pd.concat(rows_p, ignore_index=True)
    df_r = pd.concat(rows_r, ignore_index=True)
    df_pho = (pd.concat(rows_pho, ignore_index=True) if rows_pho
              else pd.DataFrame(columns=["protein", "psite", "time", "pred_fc"]))

    df_p = df_p[df_p["time"].isin(np.asarray(t_points_p, float))]
    df_r = df_r[df_r["time"].isin(np.asarray(t_points_r, float))]
    if len(df_pho):
        df_pho = df_pho[df_pho["time"].isin(np.asarray(t_points_pho, float))]
    return df_p, df_r, df_pho
