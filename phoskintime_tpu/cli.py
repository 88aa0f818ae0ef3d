"""Command-line interface.

Spec: reference ``config/cli.py:73-224`` (Typer app with subcommands
``prep | tfopt | kinopt | model | global-model | all | clean``, each
spawning a module subprocess). Typer is not available here, so this is an
argparse CLI running each stage **in-process** — no process boundaries are
needed because all parallelism lives inside XLA programs.

Usage: ``python -m phoskintime_tpu <command> [options]``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

from phoskintime_tpu.config.loader import PhosKinConfig, load
from phoskintime_tpu.config.logconf import setup_logger

logger = setup_logger()


def _add_common(p):
    p.add_argument("--config", default=None, help="path to config.toml")
    p.add_argument("--out-dir", default=None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="phoskintime_tpu",
        description="GPU-accelerated ODE parameter estimation of cell-signalling "
                    "events in temporal space")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prep", help="preprocess raw files into input1..4.csv")
    p.add_argument("--base-dir", required=True)
    _add_common(p)

    for name in ("tfopt", "kinopt"):
        p = sub.add_parser(name, help=f"run {name} optimization")
        p.add_argument("--mode", choices=["local", "evol"], default="local")
        _add_common(p)

    p = sub.add_parser("model", help="per-gene ODE fitting")
    p.add_argument("--model", choices=["distmod", "succmod", "randmod"],
                   default=None)
    p.add_argument("--genes", nargs="*", default=None)
    p.add_argument("--bootstraps", type=int, default=None)
    p.add_argument("--A-bound", default=None)
    p.add_argument("--B-bound", default=None)
    p.add_argument("--C-bound", default=None)
    p.add_argument("--D-bound", default=None)
    p.add_argument("--Ssite-bound", default=None)
    p.add_argument("--Dsite-bound", default=None)
    p.add_argument("--sensitivity", action="store_true")
    _add_common(p)

    p = sub.add_parser("global-model", aliases=["global_model"],
                       help="joint network fit")
    p.add_argument("--optimizer", choices=["pymoo", "optuna", "gradient"],
                   default=None)
    p.add_argument("--pop", type=int, default=None)
    p.add_argument("--n-gen", type=int, default=None)
    p.add_argument("--refine", action="store_true")
    p.add_argument("--polish-steps", type=int, default=None,
                   help="exact-gradient Adam polish steps applied to the "
                        "Pareto set after the search (0 = off)")
    p.add_argument("--gn-iters", type=int, default=None,
                   help="Levenberg-Marquardt (Gauss-Newton) iterations on "
                        "the best solution after the search (exact "
                        "residual Jacobian, matrix-free CG)")
    p.add_argument("--gens-per-dispatch", type=int, default=None,
                   help="GA generations fused into one device program "
                        "(>1 = all-device loop: variation, evaluation and "
                        "NSGA-III survival on device; amortizes dispatch)")
    p.add_argument("--scan", action="store_true",
                   help="hyperparameter scan (TPE outer loop with median "
                        "pruning) to pick the loss lambdas before the fit "
                        "(reference runner.py:124-126 --scan)")
    _add_common(p)

    p = sub.add_parser("mechanisms",
                       help="fit ALL mechanistic hypotheses on the same "
                            "data; rank by AIC/BIC with overlay plots "
                            "(reference scripts/compare_mechanisms.py)")
    p.add_argument("--models", nargs="*", type=int, default=[0, 1, 2, 4])
    p.add_argument("--pop", type=int, default=48)
    p.add_argument("--n-gen", type=int, default=25)
    p.add_argument("--polish-steps", type=int, default=0)
    _add_common(p)

    p = sub.add_parser("fitanalysis",
                       help="re-run post-fit dashboards from a saved "
                            "kinopt/tfopt results workbook (no refit)")
    p.add_argument("--which", choices=["kinopt", "tfopt"], required=True)
    p.add_argument("--mode", choices=["local", "evol"], default="local",
                   help="resolve mode-scoped config overrides (out_file "
                        "may live under [<which>.modes.<mode>])")
    p.add_argument("--file", default=None,
                   help="results workbook (default: the configured "
                        "out_file in data_dir)")
    _add_common(p)

    p = sub.add_parser("diagram",
                       help="render the optimization-network schematics "
                            "(reference scripts/make_kinopt_diagram.py); "
                            "with --alpha-file also the fitted network")
    p.add_argument("--kin-psites", type=int, default=1)
    p.add_argument("--tf-psites", type=int, default=1)
    p.add_argument("--alpha-file", default=None,
                   help="kinopt results workbook — renders the data-driven "
                        "fitted-network diagram from its Alpha/Beta sheets")
    p.add_argument("--top-edges", type=int, default=60)
    _add_common(p)

    p = sub.add_parser("all", help="prep -> tfopt -> kinopt -> model")
    p.add_argument("--base-dir", default=None)
    _add_common(p)

    p = sub.add_parser("clean", help="purge caches and pyc files")
    _add_common(p)
    return ap


def parse_bound_pair(val: str):
    """'lo,hi' -> (float, float); 'inf' accepted (reference config.py:25-47)."""
    lo, hi = val.split(",")
    hi = hi.strip().lower()
    return float(lo), float("inf") if hi in ("inf", "infinity") else float(hi)


def _ode_bounds(cfg_ode: dict, args) -> dict:
    b = cfg_ode.get("bounds", {}) or {}
    def pair(cli_val, key, default=20.0):
        if cli_val:
            return parse_bound_pair(cli_val)
        return (0.0, float(b.get(key, default)))
    return {
        "A": pair(args.A_bound, "mRNA_prod"),
        "B": pair(args.B_bound, "mRNA_deg"),
        "C": pair(args.C_bound, "protein_prod"),
        "D": pair(args.D_bound, "protein_deg"),
        "S(i)": pair(args.Ssite_bound, "phospho_prod"),
        "D(i)": pair(args.Dsite_bound, "phospho_deg"),
    }


def cmd_prep(args):
    from phoskintime_tpu.io.preprocess import run_cleanup

    # default the output to the configured data_dir so the downstream
    # stages (tfopt/kinopt/model read from [paths].data_dir) see the
    # freshly prepped input1..4.csv without an explicit --out-dir
    out_dir = args.out_dir
    if out_dir is None:
        sec = load(None, "paths", args.config)
        # default must MATCH the downstream stages' default ("data"), or
        # prep output lands where tfopt/kinopt/model will not look
        out_dir = os.path.join(sec["_root"], sec.get("data_dir", "data"))
        os.makedirs(out_dir, exist_ok=True)
    run_cleanup(args.base_dir, out_dir)


def cmd_tfopt(args):
    from phoskintime_tpu.io.export import export_tfopt_results
    from phoskintime_tpu.tfopt.data import load_tfopt_problem
    from phoskintime_tpu.tfopt.optimize import run_evolutionary, run_local

    sec = load(args.mode, "tfopt", args.config)
    root = sec["_root"]
    data_dir = os.path.join(root, sec["_paths"].get("data_dir", "data"))
    prob, meta = load_tfopt_problem(
        os.path.join(data_dir, sec.get("input1", "input1.csv")),
        os.path.join(data_dir, sec.get("input3", "input3.csv")),
        os.path.join(data_dir, sec.get("input4", "input4.csv")),
        lb=float(sec.get("lower_bound", -4.0)),
        ub=float(sec.get("upper_bound", 4.0)))
    loss_type = int(sec.get("loss_type", 5))
    if args.mode == "evol":
        res = run_evolutionary(prob, optimizer=int(sec.get("optimizer", 0)),
                               loss_type=loss_type,
                               gens_per_dispatch=int(
                                   sec.get("gens_per_dispatch", 1)))
    else:
        res = run_local(prob, loss_type=loss_type)
    out = os.path.join(data_dir, sec.get("out_file", "tfopt_results.xlsx"))
    export_tfopt_results(out, prob, res)
    if bool(sec.get("fit_analysis", True)):
        from phoskintime_tpu.analysis.fitpanels import tfopt_fit_analysis

        adir = os.path.join(os.path.dirname(out), "tfopt_fitanalysis")
        tfopt_fit_analysis(prob, res, adir)
        logger.info(f"[tfopt:{args.mode}] fit-analysis panels -> {adir}")
    logger.info(f"[tfopt:{args.mode}] loss={res.loss:.6g} -> {out}")


def cmd_kinopt(args):
    from phoskintime_tpu.io.export import export_kinopt_results
    from phoskintime_tpu.kinopt.data import load_kinopt_problem
    from phoskintime_tpu.kinopt.optimize import run_evolutionary, run_local

    sec = load(args.mode, "kinopt", args.config)
    root = sec["_root"]
    data_dir = os.path.join(root, sec["_paths"].get("data_dir", "data"))
    prob, meta = load_kinopt_problem(
        os.path.join(data_dir, sec.get("input1", "input1.csv")),
        os.path.join(data_dir, sec.get("input2", "input2.csv")),
        scaling_method=str(sec.get("scaling_method", "none")),
        split_point=int(sec.get("split_point", 9)),
        segment_points=sec.get("segment_points"),
        estimate_missing_kinases=bool(sec.get("estimate_missing_kinases", True)),
        lb=float(sec.get("lower_bound", -4.0)),
        ub=float(sec.get("upper_bound", 4.0)))
    loss_type = str(sec.get("loss_type", "base"))
    if args.mode == "evol":
        res = run_evolutionary(prob, method=str(sec.get("method", "NSGA-II")),
                               loss_type=loss_type,
                               include_reg=bool(sec.get("regularization", False)),
                               gens_per_dispatch=int(
                                   sec.get("gens_per_dispatch", 1)))
    else:
        res = run_local(prob, loss_type=loss_type)
    out = os.path.join(data_dir, sec.get("out_file", "kinopt_results.xlsx"))
    export_kinopt_results(out, prob, res, meta)
    if bool(sec.get("fit_analysis", True)):
        from phoskintime_tpu.analysis.fitpanels import kinopt_fit_analysis

        adir = os.path.join(os.path.dirname(out), "kinopt_fitanalysis")
        kinopt_fit_analysis(prob, res, adir, meta)
        logger.info(f"[kinopt:{args.mode}] fit-analysis panels -> {adir}")
        from phoskintime_tpu.kinopt.kkt import kkt_suite

        kdir = os.path.join(os.path.dirname(out), "kinopt_kkt")
        kkt_suite(prob, res, kdir, loss_type=loss_type, logger=logger)
        logger.info(f"[kinopt:{args.mode}] KKT optimality report -> {kdir}")
    logger.info(f"[kinopt:{args.mode}] loss={res.loss:.6g} feasible="
                f"{res.feasible} -> {out}")


def cmd_model(args):
    from phoskintime_tpu.fit.pipeline import run_model_pipeline
    from phoskintime_tpu.io.load import load_data

    sec = load(None, "ode", args.config)
    root = sec["_root"]
    join = lambda p: p if os.path.isabs(str(p)) else os.path.join(root, str(p))
    model = args.model or str(sec.get("model", "distmod"))
    tp = np.asarray(sec.get("time", {}).get(
        "protein", [0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                    120.0, 240.0, 480.0, 960.0]), float)
    tr = np.asarray(sec.get("time", {}).get(
        "rna", [4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 240.0, 480.0, 960.0]), float)
    inputs = sec.get("inputs", {}) or {}
    gm = load(None, "global_model", args.config)
    _, _, df_prot, df_pho, df_rna, *_ = load_data(
        join(gm.get("kinase_net", "data/input2.csv")),
        join(gm.get("tf_net", "data/input4.csv")),
        join(inputs.get("protein_excel", "data/input1.csv")),
        join(gm.get("rna", "data/input3.csv")),
        time_points_protein=tp, time_points_rna=tr,
        scaling_method="raw")
    out_dir = args.out_dir or os.path.join(
        root, sec.get("_paths", {}).get("results_dir", "results"))
    outputs = run_model_pipeline(
        df_prot, df_pho, df_rna, time_points=tp, rna_time_points=tr,
        bounds=_ode_bounds(sec, args), model=model, out_dir=out_dir,
        genes=args.genes, dev_test=bool(sec.get("dev_test", False)),
        bootstraps=args.bootstraps or int((sec.get("bootstrap") or {}).get("n", 0)),
        run_sensitivity=args.sensitivity)
    logger.info(f"[model] fitted {len(outputs)} genes -> {out_dir}")


def cmd_global_model(args):
    from phoskintime_tpu.network.runner import main as run_global

    cfg = PhosKinConfig.from_toml(args.config)
    overrides = {}
    if args.optimizer:
        overrides["optimizer"] = args.optimizer
    if args.pop:
        overrides["pop"] = args.pop
    if args.n_gen:
        overrides["n_gen"] = args.n_gen
    if args.refine:
        overrides["refine"] = True
    if getattr(args, "polish_steps", None) is not None:
        overrides["polish_steps"] = args.polish_steps
    if getattr(args, "gens_per_dispatch", None) is not None:
        overrides["gens_per_dispatch"] = args.gens_per_dispatch
    if getattr(args, "gn_iters", None) is not None:
        overrides["gn_iters"] = args.gn_iters
    if getattr(args, "scan", False):
        overrides["hyperparam_scan"] = True
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    run_global(cfg, out_dir=args.out_dir)


def cmd_mechanisms(args):
    """Mechanism model selection: fit all hypotheses on the same data
    (reference scripts/compare_mechanisms.py core workflow)."""
    from phoskintime_tpu.analysis.mechanisms import fit_all_mechanisms
    from phoskintime_tpu.io.load import load_data

    sec = load(None, "ode", args.config)
    root = sec["_root"]
    join = lambda p: p if os.path.isabs(str(p)) else os.path.join(root, str(p))
    tp = np.asarray(sec.get("time", {}).get(
        "protein", [0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                    120.0, 240.0, 480.0, 960.0]), float)
    tr = np.asarray(sec.get("time", {}).get(
        "rna", [4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 240.0, 480.0, 960.0]), float)
    inputs = sec.get("inputs", {}) or {}
    gm = load(None, "global_model", args.config)
    df_kin, df_tf, df_prot, df_pho, df_rna, *_ = load_data(
        join(gm.get("kinase_net", "data/input2.csv")),
        join(gm.get("tf_net", "data/input4.csv")),
        join(inputs.get("protein_excel", "data/input1.csv")),
        join(gm.get("rna", "data/input3.csv")),
        time_points_protein=tp, time_points_rna=tr,
        scaling_method="raw")
    out_dir = args.out_dir or os.path.join(
        root, sec.get("_paths", {}).get("results_dir", "results"),
        "mechanism_selection")
    sel = fit_all_mechanisms(
        df_kin, df_tf, df_prot, df_rna, df_pho, (tp, tr, tp),
        models=tuple(args.models), pop=args.pop, n_gen=args.n_gen,
        polish_steps=args.polish_steps, out_dir=out_dir, logger=logger)
    from phoskintime_tpu.analysis.mechanisms import MECHANISMS

    logger.info(f"[mechanisms] best={MECHANISMS[sel.best_model]} "
                f"-> {out_dir}")


def cmd_fitanalysis(args):
    """Workbook-driven re-analysis (reference kinopt/fitanalysis
    ``__main__`` contract: read the saved sheets, render the panels)."""
    from phoskintime_tpu.analysis.fitpanels import fit_analysis_from_workbook

    # the same mode-merged view cmd_kinopt/cmd_tfopt write through, so a
    # mode-scoped out_file resolves to where the fit actually wrote it
    sec = load(args.mode, args.which, args.config)
    root = sec["_root"]
    data_dir = os.path.join(root, sec["_paths"].get("data_dir", "data"))
    default = os.path.join(data_dir,
                           sec.get("out_file", f"{args.which}_results.xlsx"))
    path = args.file or default
    out_dir = args.out_dir or os.path.join(os.path.dirname(path),
                                           f"{args.which}_fitanalysis")
    out = fit_analysis_from_workbook(path, out_dir, args.which)
    logger.info(f"[fitanalysis:{args.which}] {len(out)} panel groups -> "
                f"{out_dir}")


def cmd_diagram(args):
    """Optimization-network schematics (reference
    scripts/make_kinopt_diagram.py __main__: the six kinopt/tfopt/global
    plain+constraints figures), plus the data-driven fitted-network
    diagram when a kinopt workbook is given."""
    from phoskintime_tpu.report.schematic import (fitted_network_schematic,
                                                  render_all_schematics)

    sec = load("local", "kinopt", args.config)
    out_dir = args.out_dir or os.path.join(
        sec["_root"], sec["_paths"].get("out_dir", "results"), "diagrams")
    os.makedirs(out_dir, exist_ok=True)
    paths = render_all_schematics(out_dir, kin_psites=args.kin_psites,
                                  tf_psites=args.tf_psites)
    if args.alpha_file:
        from phoskintime_tpu.io.load import read_table

        alpha = read_table(args.alpha_file, sheet_name="Alpha Values")
        beta = read_table(args.alpha_file, sheet_name="Beta Values")
        if alpha is None or "Alpha" not in alpha.columns:
            raise FileNotFoundError(
                f"sheet 'Alpha Values' of {args.alpha_file} not found "
                "(pass the workbook path, not an individual sheet CSV)")
        if beta is not None and "Beta" in beta.columns:
            # per-kinase-only Beta sheets carry no Psite column
            # (io/load.py:169-171 supports both workbook layouts)
            if "Psite" in beta.columns:
                beta["Psite"] = beta["Psite"].fillna("")
            else:
                beta["Psite"] = ""
        else:
            beta = None
        paths["fitted_network"] = fitted_network_schematic(
            alpha, beta, os.path.join(out_dir, "fitted_network.png"),
            top_edges=args.top_edges, logger=logger)
    logger.info(f"[diagram] {len(paths)} figures -> {out_dir}")


def cmd_all(args):
    if args.base_dir:
        cmd_prep(argparse.Namespace(base_dir=args.base_dir, config=args.config,
                                    out_dir=args.out_dir))
    for mode_cmd in (cmd_tfopt, cmd_kinopt):
        mode_cmd(argparse.Namespace(mode="local", config=args.config,
                                    out_dir=args.out_dir))
    cmd_model(argparse.Namespace(
        model=None, genes=None, bootstraps=None, A_bound=None, B_bound=None,
        C_bound=None, D_bound=None, Ssite_bound=None, Dsite_bound=None,
        sensitivity=False, config=args.config, out_dir=args.out_dir))


def cmd_clean(args):
    """Purge compilation caches + pycache (reference cli.py:160-192 purges
    Numba .nbc caches; our equivalent is the XLA persistent cache)."""
    n = 0
    for root, dirs, _files in os.walk("."):
        for d in list(dirs):
            if d == "__pycache__":
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)
                dirs.remove(d)
                n += 1
    from phoskintime_tpu.parallel.profile import compilation_cache_dir

    cache = compilation_cache_dir()
    if os.path.isdir(cache):
        shutil.rmtree(cache, ignore_errors=True)
        logger.info(f"[clean] removed XLA cache {cache}")
    logger.info(f"[clean] removed {n} __pycache__ dirs")


def main(argv=None):
    args = build_parser().parse_args(argv)
    # persistent XLA compile cache for every stage: repeat runs with
    # unchanged shapes skip compilation entirely
    from phoskintime_tpu.parallel.profile import enable_compilation_cache

    enable_compilation_cache()
    cmd = args.command.replace("-", "_")
    {"prep": cmd_prep, "tfopt": cmd_tfopt, "kinopt": cmd_kinopt,
     "model": cmd_model, "global_model": cmd_global_model,
     "fitanalysis": cmd_fitanalysis, "mechanisms": cmd_mechanisms,
     "diagram": cmd_diagram,
     "all": cmd_all, "clean": cmd_clean}[cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])
