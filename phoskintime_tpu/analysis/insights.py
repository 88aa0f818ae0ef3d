"""Mechanistic discovery: four biological insights from a fitted model.

Behavioral spec: reference ``scripts/mechanistic_insights.py:43-200``
(run_mechanistic_discovery) — refractory period (flash vs stable
signaling), kinetic lag (protein->RNA cross-correlation), transcriptional
saturation (digital switching), and feedback gain (TF -> kinase -> TF
revolving-door loops).

Accelerator-native: one high-resolution simulation feeds every insight; the
per-protein python loops of the reference collapse into vectorized numpy
(cross-correlations via one batched FFT instead of scipy.signal.correlate
per protein).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def refractory_period(topo, params) -> pd.DataFrame:
    """Flash index per protein: signal-reset speed over protein stability
    (reference mechanistic_insights.py:68-91).

    DEVIATION from the reference script (documented): in this model (and
    the reference's own RHS) B_i is mRNA decay and D_i is protein
    degradation — the reference script divides by B_i as "stability"
    (its own comment says "check model definition"). Here signal reset =
    avg site turn-off (Dp + back-exchange E) and stability = D_i."""
    msk = topo.site_mask().astype(float)
    ns = np.maximum(msk.sum(axis=1), 1.0)
    avg_dephos = np.asarray(params["Dp_i"] * msk).sum(axis=1) / ns
    avg_dephos = np.where(msk.sum(axis=1) > 0, avg_dephos, 0.0)
    back = np.asarray(params["E_i"], float)
    degr = np.asarray(params["D_i"], float)
    reset = avg_dephos + back
    return pd.DataFrame({
        "protein": topo.proteins,
        "signal_reset": reset,
        "protein_stability": degr,
        "flash_index": reset / (degr + 1e-9),
    }).sort_values("flash_index", ascending=False).reset_index(drop=True)


def kinetic_lag(df_prot: pd.DataFrame, df_rna: pd.DataFrame,
                time_grid: np.ndarray,
                responder_fc: float = 1.1) -> pd.DataFrame:
    """Peak cross-correlation lag between protein and RNA responses
    (reference mechanistic_insights.py:94-120).

    All responder proteins are correlated in ONE batched FFT — the
    reference loops ``scipy.signal.correlate`` per protein."""
    time_grid = np.asarray(time_grid, float)
    # the FFT lag index assumes UNIFORM spacing; the discovery driver
    # simulates on linspace(0, t_max) so this holds there — reject other
    # grids loudly instead of reporting lags off by orders of magnitude
    steps = np.diff(time_grid)
    if len(steps) and (steps.max() - steps.min()) > 1e-9 * max(
            steps.max(), 1e-12):
        raise ValueError(
            "kinetic_lag requires a uniform time grid (FFT lag indices "
            f"map to time via a single dt); got spacings "
            f"[{steps.min():g}, {steps.max():g}] — resample first")
    T = len(time_grid)
    dt = time_grid[1] - time_grid[0]
    piv_r = df_rna.pivot_table(index="protein", columns="time",
                               values="pred_fc").reindex(columns=time_grid)
    piv_p = df_prot.pivot_table(index="protein", columns="time",
                                values="pred_fc").reindex(
                                    index=piv_r.index, columns=time_grid)
    keep = piv_r.max(axis=1) > responder_fc
    if not keep.any():
        return pd.DataFrame(columns=["protein", "lag_minutes", "rna_peak",
                                     "prot_peak"])
    rna = piv_r.values[keep.values] - 1.0            # (G, T)
    prot = piv_p.values[keep.values] - 1.0

    # full cross-correlation corr[k] = sum_t prot[t] rna[t - k], batched
    L = 2 * T - 1
    F = np.fft.rfft(prot, L, axis=1) * np.conj(np.fft.rfft(rna, L, axis=1))
    corr = np.fft.irfft(F, L, axis=1)
    corr = np.concatenate([corr[:, -(T - 1):], corr[:, :T]], axis=1)
    lags = np.arange(-(T - 1), T) * dt
    lag_min = lags[np.argmax(corr, axis=1)]

    return pd.DataFrame({
        "protein": piv_r.index[keep.values],
        "lag_minutes": np.maximum(0.0, lag_min),
        "rna_peak": piv_r.values[keep.values].max(axis=1),
        "prot_peak": piv_p.values[keep.values].max(axis=1),
    }).sort_values("lag_minutes", ascending=False).reset_index(drop=True)


def transcriptional_saturation(topo, params,
                               df_rna: pd.DataFrame) -> pd.DataFrame:
    """Saturation index: TF efficacy over realized mRNA dynamic range
    (reference mechanistic_insights.py:123-142).

    DEVIATION (documented): the reference script reads ode_sys.E_i as
    "transcriptional efficacy", but E_i is the dephosphorylation
    back-exchange rate in BOTH models; the actual transcription-drive
    amplitude is A_i * tf_scale (synthesis_rate activation span)."""
    alpha = (np.asarray(params["A_i"], float)
             * float(np.asarray(params["tf_scale"])))
    max_rna = (df_rna.groupby("protein")["pred_fc"].max()
               .reindex(topo.proteins).fillna(0.0).values)
    return pd.DataFrame({
        "protein": topo.proteins,
        "tf_efficacy_alpha": alpha,
        "max_mrna_fc": max_rna,
        "saturation_index": alpha / (max_rna + 1e-9),
    }).sort_values("saturation_index", ascending=False).reset_index(drop=True)


def feedback_gain(topo, params, df_tf: pd.DataFrame) -> pd.DataFrame:
    """TF -> kinase -> TF revolving-door loops
    (reference mechanistic_insights.py:145-185): alpha = efficacy of the
    TF->kinase transcription, beta = summed W weight of the kinase back
    onto the TF's sites; loop gain = alpha * beta."""
    rows = []
    # transcription efficacy of the TF->kinase edge = the kinase's
    # synthesis activation span A_i * tf_scale (the reference script used
    # E_i — the dephospho rate — see transcriptional_saturation note)
    A = (np.asarray(params["A_i"], float)
         * float(np.asarray(params["tf_scale"])))
    W = np.asarray(topo.W_pad, float)                # (N, Smax, K)
    for _, r in df_tf.iterrows():
        tf, target = r["tf"], r["target"]
        if target not in topo.k2i or target not in topo.p2i \
                or tf not in topo.p2i:
            continue
        alpha = A[topo.p2i[target]]
        beta = float(W[topo.p2i[tf], :, topo.k2i[target]].sum())
        if beta > 0:
            rows.append({"tf": tf, "kinase": target,
                         "loop_gain": alpha * beta,
                         "efficacy_alpha": alpha, "signaling_beta": beta})
    cols = ["tf", "kinase", "loop_gain", "efficacy_alpha", "signaling_beta"]
    df = pd.DataFrame(rows, columns=cols)
    return df.sort_values("loop_gain", ascending=False).reset_index(drop=True)


def run_mechanistic_discovery(system, params, df_tf: pd.DataFrame,
                              out_dir: str | None = None,
                              t_max: float = 120.0,
                              n_points: int = 61) -> dict[str, pd.DataFrame]:
    """All four insights from one high-resolution simulation
    (reference mechanistic_insights.py:43-200). Returns the four tables;
    optionally writes the Excel/CSV report."""
    from phoskintime_tpu.network.simulate import simulate_and_measure

    topo = system.topo
    grid = np.linspace(0.0, t_max, n_points)
    df_prot, df_rna, _ = simulate_and_measure(system, params, grid, grid, [])

    tables = {
        "1_refractory_period": refractory_period(topo, params),
        "2_kinetic_lag": kinetic_lag(df_prot, df_rna, grid),
        "3_saturation": transcriptional_saturation(topo, params, df_rna),
        "4_feedback_gain": feedback_gain(topo, params, df_tf),
    }
    if out_dir is not None:
        from phoskintime_tpu.io.export import TableWriter

        w = TableWriter(f"{out_dir}/mechanistic_discovery_report.xlsx")
        for name, df in tables.items():
            w.add(name, df)
        w.save()
    return tables
