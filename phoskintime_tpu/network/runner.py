"""End-to-end global-model runner.

Spec: reference ``global_model/runner.py:90-1088`` — load -> topology with
TF-orphan proxying -> observation filtering -> kinase input -> modality
weights -> system assembly -> data-driven y0 -> union solver grid + fast
loss data -> bio bounds + softplus raw params -> optional hyperparameter
scan -> UNSGA3 / MOTPE fit -> optional refinement -> Pareto exports ->
Frechet solution picking -> sensitivity -> kinase-activity / residual /
parameter exports -> 7-day steady-state check -> Pareto plots ->
report bundle.
"""

from __future__ import annotations

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pandas as pd

from phoskintime_tpu.config.loader import PhosKinConfig
from phoskintime_tpu.config.logconf import setup_logger
from phoskintime_tpu.io.export import (
    export_global_params,
    export_kinase_activities,
    export_pareto,
    export_param_distributions,
    export_residuals,
    export_trajectories,
)
from phoskintime_tpu.io.load import load_data
from phoskintime_tpu.network.analysis import kinase_dominance, simulate_until_steady
from phoskintime_tpu.network.bounds import calculate_bio_bounds
from phoskintime_tpu.network.kinase_input import build_kinase_matrix
from phoskintime_tpu.network.lossdata import prepare_loss_data
from phoskintime_tpu.network.optimize import run_global_fit
from phoskintime_tpu.network.params import init_raw_params, unpack_params
from phoskintime_tpu.network.scan import run_hyperparameter_scan
from phoskintime_tpu.network.sensitivity import run_sensitivity_analysis
from phoskintime_tpu.network.simulate import simulate_and_measure
from phoskintime_tpu.network.steadystate import build_y0_from_data
from phoskintime_tpu.network.system import GlobalSystem, default_params
from phoskintime_tpu.network.topology import build_topology
from phoskintime_tpu.network.weights import build_weight_functions

logger = setup_logger()

# the report layer's optional packages: without them figures are skipped
_FIGURE_PACKAGES = ("matplotlib", "sklearn")


def _figure(writer, *args, **kwargs):
    """Run one figure writer. matplotlib and scikit-learn are optional
    dependencies of the report layer: where one is missing the figure is
    skipped and logged, and the numeric exports are unaffected."""
    try:
        return writer(*args, **kwargs)
    except ModuleNotFoundError as e:
        if e.name not in _FIGURE_PACKAGES:
            raise
        logger.warning(f"[Report] {writer.__name__} skipped: {e.name} is "
                       f"not installed")


def main(cfg: PhosKinConfig, mesh=None, out_dir=None,
         weighting=None) -> dict:
    """Run the full global fit from a config; returns the result bundle."""
    # persistent XLA compile cache: repeat runs with the same shapes skip
    # the fit's first trace and compile
    from phoskintime_tpu.parallel.profile import enable_compilation_cache

    enable_compilation_cache()
    if weighting is None:
        weighting = (cfg.weighting_method_protein, cfg.weighting_method_rna,
                     cfg.weighting_method_phospho)
    root = cfg._root
    out_dir = str(out_dir or os.path.join(root, cfg.output_dir))
    os.makedirs(out_dir, exist_ok=True)
    tp_p = np.asarray(cfg.time_points_protein, float)
    tp_r = np.asarray(cfg.time_points_rna, float)

    # ---- 1. data ----------------------------------------------------------
    join = lambda p: p if os.path.isabs(str(p)) else os.path.join(root, str(p))
    (df_kin, df_tf, df_prot, df_pho, df_rna, kin_beta, tf_beta,
     kin_alpha, tf_edges) = load_data(
        join(cfg.kinase_net), join(cfg.tf_net), join(cfg.ms), join(cfg.rna),
        kinopt_path=join(cfg.kinopt), tfopt_path=join(cfg.tfopt),
        time_points_protein=tp_p, time_points_rna=tp_r,
        scaling_method=cfg.scaling_method)

    # ---- 2. topology (orphan proxying inside) -----------------------------
    topo = build_topology(df_kin, df_tf, kin_beta_map=kin_beta,
                          tf_beta_map=tf_beta, kin_alpha=kin_alpha,
                          tf_edge_weights=tf_edges, model=cfg.model)
    logger.info(f"[Model] {topo.N} proteins ({len(topo.proxy_map)} orphans "
                f"rewired), {topo.K} kinases, state width {topo.width}")

    # observation filtering: keep only rows mapping into the topology
    df_prot = df_prot[df_prot["protein"].isin(topo.p2i)]
    df_rna = df_rna[df_rna["protein"].isin(topo.p2i)]
    df_pho = df_pho[df_pho["protein"].isin(topo.p2i)]

    # ---- 3. kinase input + weights ---------------------------------------
    Kmat = build_kinase_matrix(topo.kinases, df_prot, tp_p)
    w_prot, w_rna = build_weight_functions(tp_p, tp_r, weighting[0], weighting[1])
    w_pho, _ = build_weight_functions(tp_p, tp_r, weighting[2], weighting[1])
    df_prot = df_prot.assign(w=w_prot(df_prot["time"].to_numpy()))
    df_pho = df_pho.assign(w=w_pho(df_pho["time"].to_numpy()))
    df_rna = df_rna.assign(w=w_rna(df_rna["time"].to_numpy()))

    # ---- 4. system + y0 ----------------------------------------------------
    system = GlobalSystem(topo, tp_p, Kmat, dtype=np.float32)
    y0 = None
    if cfg.use_initial_condition_from_data:
        y0 = build_y0_from_data(topo, df_prot, df_rna, df_pho)
        system.custom_y0 = y0

    # ---- 5. solver grid + loss data + bounds ------------------------------
    grid = np.unique(np.concatenate([tp_p, tp_r]))
    loss_data = prepare_loss_data(topo, df_prot, df_rna, df_pho, grid)
    defaults = default_params(topo, np.float32)
    bio_bounds = calculate_bio_bounds(topo, df_prot, df_rna, Kmat)
    theta0, slices, xl, xu = init_raw_params(defaults, topo, bio_bounds)
    logger.info(f"[Fit] {len(theta0)} decision variables; data points: "
                f"{len(loss_data.obs_prot)} protein, {len(loss_data.obs_rna)} "
                f"RNA, {len(loss_data.obs_pho)} phospho")

    lambdas = {"protein": cfg.lambda_protein, "rna": cfg.lambda_rna,
               "phospho": cfg.lambda_phospho, "prior": cfg.lambda_prior}

    # ---- 6. optional hyperparameter scan ----------------------------------
    if cfg.hyperparam_scan:
        scan_dir = os.path.join(out_dir, "hyperparam_scan")
        best_lams, trials = run_hyperparameter_scan(
            system, slices, loss_data, defaults, grid, xl, xu,
            n_outer=cfg.scan_trials, inner_gens=cfg.scan_inner_gens,
            inner_pop=cfg.scan_inner_pop,
            seed=cfg.seed, loss_mode=cfg.loss, mesh=mesh, logger=logger,
            out_dir=scan_dir,
            checkpoint_path=os.path.join(scan_dir, "scan_state.json"))
        lambdas = best_lams
        logger.info(f"[Scan] selected lambdas {lambdas}")

    # ---- 7. fit ------------------------------------------------------------
    res = run_global_fit(
        system, slices, loss_data, defaults, lambdas, grid, xl, xu,
        optimizer=cfg.optimizer, pop=cfg.pop, n_gen=cfg.n_gen,
        n_trials=cfg.n_trials, seed=cfg.seed, loss_mode=cfg.loss, mesh=mesh,
        rtol=1e-5, atol=1e-7, max_steps=5000, y0=y0,
        refine=cfg.refine, num_refinements=cfg.num_refinements,
        polish_steps=cfg.polish_steps, polish_lr=cfg.polish_lr,
        gens_per_dispatch=cfg.gens_per_dispatch, gn_iters=cfg.gn_iters,
        frechet_pick=True, df_prot=df_prot, df_rna=df_rna, df_pho=df_pho,
        t_points=(tp_p, tp_r, tp_p), logger=logger)
    logger.info(f"[Fit] done: {res.n_evals} evaluations, "
                f"{len(res.pareto_X)} Pareto solutions, picked {res.best_idx}")

    with open(os.path.join(out_dir, f"{cfg.optimizer}_optimization_result.pkl"),
              "wb") as fh:
        pickle.dump({"X": res.X, "F": res.F, "pareto_X": res.pareto_X,
                     "pareto_F": res.pareto_F, "best_idx": res.best_idx,
                     "history": res.history, "slices": slices}, fh)
    np.save(os.path.join(out_dir, "pareto_X.npy"), res.pareto_X)
    np.save(os.path.join(out_dir, "pareto_F.npy"), res.pareto_F)

    # ---- 8. best-solution exports ----------------------------------------
    theta_best = res.pareto_X[res.best_idx]
    params_best = unpack_params(jnp.asarray(theta_best, jnp.float32), slices, topo)
    dfp_fit, dfr_fit, dfph_fit = simulate_and_measure(
        system, params_best, tp_p, tp_r, tp_p, y0=y0)

    export_pareto(os.path.join(out_dir, "pareto.xlsx"), res.pareto_X, res.pareto_F)
    export_trajectories(os.path.join(out_dir, "trajectories.xlsx"),
                        dfp_fit, dfr_fit, dfph_fit, df_prot, df_rna, df_pho)
    export_global_params(os.path.join(out_dir, "parameters.xlsx"), topo,
                         {k: np.asarray(v) for k, v in params_best.items()})
    export_kinase_activities(os.path.join(out_dir, "kinase_activity.xlsx"),
                             topo, params_best, Kmat, tp_p)
    export_residuals(os.path.join(out_dir, "residuals.xlsx"), df_prot,
                     dfp_fit, ["protein"])
    export_param_distributions(os.path.join(out_dir, "param_distributions.xlsx"),
                               res.pareto_X, slices, topo)
    from phoskintime_tpu.io.export import export_param_correlations

    # the workbook is written before the heatmap is drawn
    _figure(export_param_correlations,
            os.path.join(out_dir, "param_correlations.xlsx"),
            res.pareto_X, slices, topo,
            heatmap_path=os.path.join(out_dir, "param_correlations.png"))

    # S-rate drive export + PDF report (reference export.py:1256-1570)
    from phoskintime_tpu.io.export import (
        create_convergence_video,
        export_S_rates,
        plot_s_rates_report,
        process_convergence_history,
        save_all_gene_timeseries,
    )

    export_S_rates(system, params_best, out_dir)
    # lambda-weight scan over the saved front + per-solution trajectories
    # and GOF panels for the best few members (reference export.py:220-822,
    # 1174-1253)
    from phoskintime_tpu.io.export import (
        export_pareto_trajectories,
        plot_gof_solutions,
        scan_prior_reg,
    )

    scan_prior_reg(out_dir)
    n_top = min(3, len(res.pareto_X))
    top_idx = np.argsort(res.pareto_F.sum(axis=1))[:n_top]
    if res.best_idx not in top_idx:
        top_idx = np.concatenate([[res.best_idx], top_idx[:-1]])
    export_pareto_trajectories(system, slices, res.pareto_X,
                               (tp_p, tp_r, tp_p),
                               os.path.join(out_dir, "pareto_trajectories.xlsx"),
                               top_idx=top_idx)
    from phoskintime_tpu.io.load import read_table

    tp = read_table(os.path.join(out_dir, "pareto_trajectories.xlsx"),
                    sheet_name="traj_protein")
    tr = read_table(os.path.join(out_dir, "pareto_trajectories.xlsx"),
                    sheet_name="traj_rna")
    tph = read_table(os.path.join(out_dir, "pareto_trajectories.xlsx"),
                     sheet_name="traj_phospho")
    if tp is not None and tr is not None and tph is not None:
        _figure(plot_gof_solutions, tp, tr, tph, df_prot, df_rna, df_pho,
                os.path.join(out_dir, "gof_solutions"))
        # interactive Pareto explorer: objective scatter with clickable
        # members -> per-solution fit curves (single HTML, no server)
        from phoskintime_tpu.report.interactive import (
            pareto_explorer_from_frames)

        pareto_explorer_from_frames(
            os.path.join(out_dir, "pareto_interactive.html"),
            res.pareto_F, res.best_idx, tp, tr, tph,
            df_prot, df_rna, df_pho)
    if topo.total_sites:
        _figure(plot_s_rates_report,
                os.path.join(out_dir, "S_rates_picked.csv"),
                os.path.join(out_dir, "S_rates_report.pdf"))
    # convergence history CSV/plot + population animation
    _figure(process_convergence_history, res.history, out_dir)
    if getattr(res, "pop_history", None):
        _figure(create_convergence_video, res.pop_history, res.pareto_F,
                out_dir)
    # per-gene observed-vs-predicted 3-panel time series
    _figure(save_all_gene_timeseries, df_prot, dfp_fit, df_rna, dfr_fit,
            df_pho, dfph_fit, os.path.join(out_dir, "gene_timeseries"))

    # ---- 9. sensitivity ----------------------------------------------------
    sens = None
    if cfg.sensitivity_analysis:
        sens = run_sensitivity_analysis(
            system, slices, theta_best, grid,
            perturbation=cfg.sensitivity_perturbation,
            n_trajectories=cfg.sensitivity_trajectories,
            num_levels=cfg.sensitivity_levels,
            metric=cfg.sensitivity_metric,
            top_curves=cfg.sensitivity_top_curves, y0=y0, seed=cfg.seed)
        np.savez(os.path.join(out_dir, "sensitivity.npz"),
                 mu=sens.morris.mu, mu_star=sens.morris.mu_star,
                 sigma=sens.morris.sigma)

    # ---- 10. steady-state check (7 days) ----------------------------------
    ss = simulate_until_steady(system, params_best, y0=y0)
    dom = kinase_dominance(system, params_best)

    # functional-influence networks at the fitted optimum: temporal edge
    # sweep, seed cascades, time-slider HTML (reference
    # scripts/compare_mechanisms.py network-exploration capability)
    from phoskintime_tpu.analysis.influence import (
        export_global_knockout_explorer,
        export_influence_sweep,
    )

    export_influence_sweep(system, params_best,
                           os.path.join(out_dir, "influence"),
                           seeds=list(topo.kinases[:2]))
    export_global_knockout_explorer(
        system, params_best,
        os.path.join(out_dir, "influence", "global_knockouts.html"))
    # live slider-driven re-simulation (reference compare_mechanisms.py's
    # Streamlit interactivity, serverless): perturbation scales, horizon
    # and per-protein parameter edits re-solve the network in-browser
    from phoskintime_tpu.report.live_model import write_live_model_explorer

    write_live_model_explorer(
        os.path.join(out_dir, "influence", "live_explorer.html"),
        system, params_best, title="live global-model explorer",
        df_prot=df_prot, df_rna=df_rna, df_pho=df_pho)
    pd.DataFrame({"protein": topo.proteins, "converged": ss.converged,
                  "final_rate": ss.final_rate, "ss_value": ss.ss_value}
                 ).to_csv(os.path.join(out_dir, "steady_state_check.csv"),
                          index=False)

    # mechanistic discovery report at the fitted optimum (reference
    # scripts/mechanistic_insights.py main(): its loader rebuilds the
    # System from saved artifacts — here the fitted system is in hand)
    from phoskintime_tpu.analysis.insights import run_mechanistic_discovery

    run_mechanistic_discovery(system, params_best, df_tf, out_dir=out_dir)

    # ---- 11. figures + report ---------------------------------------------
    from phoskintime_tpu.report.html import create_report

    def pareto_figures():
        from phoskintime_tpu.report.plotter import (
            plot_convergence,
            plot_parallel_coords_pareto,
            plot_pareto_3d,
        )

        plot_pareto_3d(res.pareto_F, os.path.join(out_dir, "pareto_3d.png"),
                       best_idx=res.best_idx)
        plot_convergence(res.history,
                         os.path.join(out_dir, "convergence.png"))
        plot_parallel_coords_pareto(
            res.pareto_F, os.path.join(out_dir, "pareto_parallel.png"))

    _figure(pareto_figures)

    # reloadable dashboard bundle (reference runner.py:1061-1077)
    from phoskintime_tpu.report.dashboard import save_dashboard_bundle

    save_dashboard_bundle(
        os.path.join(out_dir, "dashboard_bundle.pkl"),
        pareto_X=res.pareto_X, pareto_F=res.pareto_F, best_idx=res.best_idx,
        df_prot=df_prot, df_rna=df_rna, df_pho=df_pho,
        pred_prot=dfp_fit, pred_rna=dfr_fit, pred_pho=dfph_fit,
        params={k: np.asarray(v) for k, v in params_best.items()},
        topo_summary={"N": topo.N, "K": topo.K,
                      "total_sites": topo.total_sites,
                      "orphans_rewired": len(topo.proxy_map),
                      "model": topo.model},
        history=res.history)

    create_report(out_dir, title="phoskintime-tpu global model")

    return dict(result=res, system=system, topo=topo, slices=slices,
                params_best=params_best, loss_data=loss_data,
                sensitivity=sens, steady_state=ss, kinase_dominance=dom,
                out_dir=out_dir)
