"""Per-gene fitting pipeline.

Spec: reference ``paramest/core.py:17-257`` (process_gene) and
``bin/main.py`` — per gene: steady-state init -> normest -> final solve ->
mechanism diagram -> PCA/t-SNE/parallel/fit plots -> wild-type vs all
knockout combinations -> parameter/CI exports -> optional Morris
sensitivity; then cohort-level result tables and the HTML report.

Accelerator-native notes: each stage is already device-batched internally
(normest over starts x weights x lambdas, knockouts and Morris as batch
axes); genes run in sequence host-side but all device work per gene is a
handful of jitted batched programs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np
import pandas as pd

from phoskintime_tpu.config.labels import generate_labels, get_param_names
from phoskintime_tpu.config.logconf import setup_logger
from phoskintime_tpu.fit.normest import NormestResult, normest
from phoskintime_tpu.fit.sensitivity import sensitivity_analysis
from phoskintime_tpu.models.kinetics import initial_condition, solve_ode, solve_ode_batched
from phoskintime_tpu.models.knockout import knockout_label, knockout_mask_matrix

logger = setup_logger()


@dataclass
class GeneOutput:
    gene: str
    result: NormestResult
    knockout_labels: list = field(default_factory=list)
    knockout_solutions: np.ndarray | None = None
    sensitivity: object | None = None
    figures: list = field(default_factory=list)


def process_gene(gene: str,
                 pr_data: np.ndarray,
                 p_data: np.ndarray,
                 r_data: np.ndarray,
                 num_psites: int,
                 time_points: np.ndarray,
                 bounds: dict,
                 model: str = "distmod",
                 out_dir: str | None = None,
                 bootstraps: int = 0,
                 run_knockouts: bool = True,
                 run_sensitivity: bool = False,
                 sensitivity_kw: dict | None = None,
                 normest_kw: dict | None = None,
                 make_plots: bool = True,
                 ms_gauss_weights: np.ndarray | None = None,
                 precomputed: NormestResult | None = None) -> GeneOutput:
    """Fit one gene end to end (or post-process a cohort-batched fit)."""
    init_cond = np.asarray(initial_condition(num_psites, model))

    if precomputed is not None:
        res = precomputed
    else:
        logger.info(f"[{gene}] steady-state init, fitting {model} with "
                    f"{num_psites} sites")
        res = normest(gene, pr_data, p_data, r_data, init_cond, num_psites,
                      time_points, bounds, bootstraps=bootstraps, model=model,
                      ms_gauss_weights=ms_gauss_weights, **(normest_kw or {}))
    out = GeneOutput(gene, res)
    target = np.concatenate([np.asarray(r_data).ravel(),
                             np.asarray(pr_data).ravel(),
                             np.asarray(p_data).ravel()])

    # ---- knockout scan (one batch axis) ----------------------------------
    if run_knockouts:
        masks, combos = knockout_mask_matrix(num_psites, len(res.params))
        ko_params = jnp.asarray(res.params[None] * masks)
        sols, _ = solve_ode_batched(ko_params, jnp.asarray(init_cond),
                                    num_psites, jnp.asarray(time_points), model)
        out.knockout_solutions = np.asarray(sols)
        out.knockout_labels = [knockout_label(c) for c in combos]

    # ---- Morris sensitivity ----------------------------------------------
    if run_sensitivity:
        kw = dict(num_trajectories=200, num_levels=40)
        kw.update(sensitivity_kw or {})
        out.sensitivity = sensitivity_analysis(
            res.params, init_cond, num_psites, time_points, target,
            model=model, param_names=get_param_names(model, num_psites), **kw)

    # ---- figures -----------------------------------------------------------
    if make_plots and out_dir is not None:
        from phoskintime_tpu.report.diagram import illustrate
        from phoskintime_tpu.report.plotter import Plotter

        gdir = os.path.join(str(out_dir), gene)
        pl = Plotter(gene, gdir)
        labels = generate_labels(model, num_psites)
        figs = [
            illustrate(gene, num_psites, model, gdir),
            pl.plot_model_fit(time_points, res.sol, target,
                              state_labels=labels),
            pl.plot_gof(target, res.fit),
            pl.plot_kld(target, res.fit),
            pl.plot_time_state_grid(time_points, res.sol, labels),
            pl.plot_phase_space(res.sol),
        ]
        if res.ci is not None:
            figs.append(pl.plot_params_bar(
                res.ci, get_param_names(model, num_psites)))
        if res.boot_params is not None and len(res.boot_params) >= 3:
            phys = (np.exp(res.boot_params) if model == "randmod"
                    else res.boot_params)
            figs.append(pl.plot_pca(phys))
            figs.append(pl.plot_parallel(phys, get_param_names(model, num_psites)))
        if out.knockout_solutions is not None:
            figs.append(pl.plot_knockouts(time_points, res.sol,
                                          out.knockout_solutions[:8],
                                          out.knockout_labels[:8]))
        if out.sensitivity is not None:
            figs.append(pl.plot_morris(out.sensitivity.morris,
                                       out.sensitivity.param_names))
            figs.append(pl.plot_perturbation_cloud(
                time_points, out.sensitivity.top_solutions, res.sol))
        out.figures = [f for f in figs if f]

    return out


def extract_gene_data(df_prot: pd.DataFrame, df_pho: pd.DataFrame,
                      df_rna: pd.DataFrame, gene: str,
                      time_points: np.ndarray, rna_time_points: np.ndarray):
    """Tidy frames -> (pr_data, p_data(n_sites, T), r_data, site_names)."""
    T = len(time_points)
    g = str(gene)

    pr = df_prot[df_prot["protein"] == g].sort_values("time")
    pr_map = dict(zip(pr["time"], pr["fc"]))
    pr_data = np.asarray([pr_map.get(t, 1.0) for t in time_points])

    rn = df_rna[df_rna["protein"] == g].sort_values("time")
    rn_map = dict(zip(rn["time"], rn["fc"]))
    r_data = np.asarray([rn_map.get(t, 1.0) for t in rna_time_points])

    sites = sorted(df_pho.loc[df_pho["protein"] == g, "psite"].unique())
    p_rows = []
    for s in sites:
        sub = df_pho[(df_pho["protein"] == g) & (df_pho["psite"] == s)]
        mp = dict(zip(sub["time"], sub["fc"]))
        p_rows.append([mp.get(t, 1.0) for t in time_points])
    p_data = np.asarray(p_rows) if p_rows else np.zeros((0, T))
    return pr_data, p_data, r_data, sites


def run_model_pipeline(df_prot, df_pho, df_rna, *, time_points,
                       rna_time_points, bounds, model="distmod",
                       out_dir="results", genes=None, dev_test=False,
                       max_sites: int = 5, batch_genes: bool = True,
                       **gene_kw) -> dict[str, GeneOutput]:
    """Cohort driver (reference bin/main.py): fit every common gene.

    With ``batch_genes`` (default), genes are grouped by site count and each
    group fits as ONE batched LM program (:func:`normest_batch`); knockouts,
    sensitivity and figures are then produced per gene. Bootstrapping forces
    the per-gene path (it adds a per-gene batch axis of its own).
    """
    from phoskintime_tpu.fit.normest import normest_batch

    common = sorted(set(df_prot["protein"]) & set(df_pho["protein"]))
    if genes is not None:
        common = [g for g in common if g in set(genes)]
    if dev_test:
        common = common[:1]

    gene_data = {}
    for gene in common:
        pr, p, r, sites = extract_gene_data(df_prot, df_pho, df_rna, gene,
                                            time_points, rna_time_points)
        n = len(sites)
        if n == 0 or n > max_sites:
            logger.info(f"[{gene}] skipped ({n} sites)")
            continue
        gene_data[gene] = (pr, p, r, n)

    precomputed: dict[str, NormestResult] = {}
    # the batched fitter cannot honor per-call extras it does not plumb
    # (bootstraps run per gene; ms_gauss_weights would be silently DROPPED
    # by the cohort path, making batch_genes=True/False fit differently) —
    # fall back to the per-gene path whenever they are requested
    use_batch = (batch_genes and not gene_kw.get("bootstraps")
                 and gene_kw.get("ms_gauss_weights") is None)
    if use_batch:
        groups: dict[int, list[str]] = {}
        for g, (_, _, _, n) in gene_data.items():
            groups.setdefault(n, []).append(g)
        nkw = dict(gene_kw.get("normest_kw") or {})
        for n, members in sorted(groups.items()):
            logger.info(f"[cohort] fitting {len(members)} genes with {n} "
                        f"sites as one batch")
            init_cond = np.asarray(initial_condition(n, model))
            precomputed.update(normest_batch(
                members,
                np.stack([gene_data[g][0] for g in members]),
                np.stack([gene_data[g][1] for g in members]),
                np.stack([gene_data[g][2] for g in members]),
                init_cond, n, time_points, bounds, model=model, **nkw))

    outputs: dict[str, GeneOutput] = {}
    for gene, (pr, p, r, n) in gene_data.items():
        outputs[gene] = process_gene(gene, pr, p, r, n, time_points, bounds,
                                     model=model, out_dir=out_dir,
                                     precomputed=precomputed.get(gene),
                                     **gene_kw)
        logger.info(f"[{gene}] done: error={outputs[gene].result.error:.4g} "
                    f"score={outputs[gene].result.score:.4g}")

    if out_dir is not None and outputs:
        from phoskintime_tpu.io.export import export_gene_results
        from phoskintime_tpu.report.html import create_report

        export_gene_results(os.path.join(str(out_dir), "model_results.xlsx"),
                            {g: o.result for g, o in outputs.items()})
        create_report(str(out_dir), title=f"phoskintime-tpu {model} results")
    return outputs
