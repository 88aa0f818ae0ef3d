"""Thermal (temperature-dependent) model variant and comparison.

Behavioral spec: reference ``scripts/compare_model_simulations_thermal_
standard.py:21-120`` and ``thermal_distributive_model_protein.py`` — each
protein carries a melting temperature Tm; at ambient temperature T the
folded fraction

    f_i = 1 / (1 + exp(c_fold * (T - Tm_i)))

(1) multiplies every forward phosphorylation flux (only folded protein is
a substrate: ``S * P_active`` with ``P_active = P * f``), and
(2) inflates degradation: ``D -> D * (1 + k_unfold * (1 - f))`` and the
same for every site's Dp (unfolded protein is cleared faster).

Accelerator-native: the temperature enters only through STATE-INDEPENDENT scale
factors, so the variant is a pure (topology, params) transform — the
reference's three separate thermal Numba kernels collapse into
:func:`thermalize` + the existing integrators (including the exponential
fast path, which stays exact because the RHS remains affine-per-bucket).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd


def folded_fraction(T: float, Tm_i: np.ndarray,
                    c_fold: float = 0.8) -> np.ndarray:
    """Sigmoid folded fraction per protein (reference :21-22)."""
    return 1.0 / (1.0 + np.exp(c_fold * (np.asarray(T, float)
                                         - np.asarray(Tm_i, float))))


def thermalize(system, params: dict, T: float, Tm_i,
               c_fold: float = 0.8, k_unfold: float = 4.0):
    """Return (thermal_system, thermal_params) at ambient temperature T.

    W rows are scaled by f_i (forward flux uses the folded substrate) and
    D_i / Dp_i by the unfolding multiplier; everything else is shared.
    """
    from phoskintime_tpu.network.system import GlobalSystem

    topo = system.topo
    f = folded_fraction(T, Tm_i, c_fold)                      # (N,)
    mult = 1.0 + k_unfold * (1.0 - f)

    topo_T = dataclasses.replace(
        topo, W_pad=np.asarray(topo.W_pad) * f[:, None, None])
    system_T = GlobalSystem(topo_T, system.kin_grid,
                            np.asarray(system.Kmat),
                            custom_y0=system.custom_y0, dtype=system.dtype)

    params_T = dict(params)
    params_T["D_i"] = np.asarray(params["D_i"]) * mult
    params_T["Dp_i"] = np.asarray(params["Dp_i"]) * mult[:, None]
    return system_T, params_T


DEFAULT_TEMPERATURES = (
    ("standard_20C", 20.0),
    ("physiological_37C", 37.0),
    ("heat_shock_42C", 42.0),
)


def compare_thermal_standard(system, params, Tm_i,
                             temperatures=DEFAULT_TEMPERATURES,
                             t_eval=None, c_fold: float = 0.8,
                             k_unfold: float = 4.0,
                             out_dir: str | None = None) -> dict:
    """Simulate the model at several ambient temperatures and tabulate the
    trajectories (reference compare_model_simulations_thermal_standard.py:
    276-326: 20C 'standard', 37C, 42C heat shock over [0, 960] min).

    Returns {label: (df_prot, df_rna, df_pho)}; optionally writes a
    per-protein comparison figure.
    """
    from phoskintime_tpu.network.simulate import simulate_and_measure

    if t_eval is None:
        t_eval = np.linspace(0.0, 960.0, 97)
    t_eval = np.asarray(t_eval, float)

    out = {}
    for label, T in temperatures:
        sys_T, p_T = thermalize(system, params, T, Tm_i,
                                c_fold=c_fold, k_unfold=k_unfold)
        out[label] = simulate_and_measure(sys_T, p_T, t_eval, t_eval, t_eval)

    if out_dir is not None:
        _plot_thermal_grid(system.topo, out, Tm_i, out_dir)
    return out


def _plot_thermal_grid(topo, results: dict, Tm_i, out_dir: str) -> str:
    """Per-protein total-protein trajectories, one column per temperature."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = list(results)
    n_prot = min(len(topo.proteins), 6)
    fig, axes = plt.subplots(n_prot, len(labels),
                             figsize=(4 * len(labels), 2.2 * n_prot),
                             sharex=True, squeeze=False)
    for c, lab in enumerate(labels):
        df_prot = results[lab][0]
        for r in range(n_prot):
            prot = topo.proteins[r]
            sub = df_prot[df_prot["protein"] == prot]
            ax = axes[r][c]
            ax.plot(sub["time"], sub["pred_fc"], lw=1.2)
            if r == 0:
                ax.set_title(lab, fontsize=10)
            if c == 0:
                ax.set_ylabel(f"{prot}\nTm={np.asarray(Tm_i)[r]:.0f}C",
                              fontsize=8)
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "thermal_comparison.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
