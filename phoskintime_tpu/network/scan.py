"""Hyperparameter scan: outer search over loss-weight lambdas.

Spec: reference ``global_model/scan.py:62-332`` — an Optuna outer loop
proposes (lambda_protein, lambda_rna, lambda_phospho, lambda_prior); each
trial runs a short pymoo UNSGA3 inner fit whose per-``gen_step`` best
WEIGHTED score is reported for pruning (``OptunaPruningCallback``,
scan.py:63-90), the trial score is the lambda-weighted aggregate of the
final front (scan.py:174-176) with the per-objective components recorded
as trial attributes, trials persist to storage for pause/resume
(scan.py:227-250), and the scan exports a per-trial results table plus
optimization-history / parameter-importance / parallel-coordinate plots
(scan.py:281-320).

Accelerator-native redesign: the outer loop is the on-device-friendly TPE sampler
(:mod:`phoskintime_tpu.ops.tpe`), the inner loop the batched-evaluation
UNSGA3 whose callback protocol supports early stop (truthy return), median
pruning compares the trial's intermediate weighted score at each reporting
step against the median of previous trials' reports at the SAME step
(Optuna's MedianPruner rule), resume state is a JSON checkpoint + the
sampler's observation arrays, and the plots are dependency-free
matplotlib (no optuna-dashboard; importances are |Spearman| correlations
of log-lambda vs score).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from phoskintime_tpu.network.objective import make_objective
from phoskintime_tpu.network.optimize import make_batched_evaluate
from phoskintime_tpu.ops.nsga import run_unsga3
from phoskintime_tpu.ops.tpe import MOTPESampler

KEYS = ("protein", "rna", "phospho", "prior")


@dataclass
class ScanTrial:
    """One outer-loop trial. Iterates as ``(lambdas, score)`` for
    backward compatibility with round-1/2 consumers."""

    lambdas: dict
    score: float
    state: str = "complete"            # complete | pruned
    components: tuple | None = None    # (mse_prot, mse_rna, mse_pho) @ best
    intermediate: list = field(default_factory=list)  # [(gen, score), ...]
    n_gen: int = 0

    def __iter__(self):
        return iter((self.lambdas, self.score))


def _weighted_score(F: np.ndarray) -> tuple[float, int]:
    """Reference scan.py:174-176: lambda-weighted aggregate over the front.

    Our inner objective already multiplies each component by its lambda
    (``make_objective``: ``lp*norm_p*lambdas['protein'] + ...``), so the
    aggregate is a plain sum — re-applying the lambdas here would square
    the weighting and bias trial comparison toward small lambdas.
    """
    s = F.sum(axis=1)
    i = int(np.argmin(s))
    return float(s[i]), i


def _save_state(path, trials, sampler):
    from phoskintime_tpu.parallel.checkpoint import save_sampler

    state = [{"lambdas": t.lambdas, "score": t.score, "state": t.state,
              "components": t.components, "intermediate": t.intermediate,
              "n_gen": t.n_gen} for t in trials]
    with open(path, "w") as f:
        json.dump(state, f)
    save_sampler(path + ".sampler", sampler)


def _load_state(path, sampler):
    from phoskintime_tpu.parallel.checkpoint import load_sampler

    if not os.path.exists(path):
        return []
    with open(path) as f:
        state = json.load(f)
    load_sampler(path + ".sampler", sampler)
    return [ScanTrial(t["lambdas"], t["score"], t["state"],
                      tuple(t["components"]) if t["components"] else None,
                      [tuple(x) for x in t["intermediate"]], t["n_gen"])
            for t in state]


def scan_report(trials: list[ScanTrial], out_dir: str) -> dict:
    """Write the scan artifact set (reference scan.py:281-320): per-trial
    results table, optimization history, parameter importances (|Spearman|
    of log10-lambda vs score over completed trials), parallel coordinates."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i, t in enumerate(trials):
        row = {"trial": i, "state": t.state, "score": t.score,
               "n_gen": t.n_gen}
        row.update({f"lambda_{k}": t.lambdas[k] for k in KEYS})
        if t.components is not None:
            row.update({"mse_prot": t.components[0],
                        "mse_rna": t.components[1],
                        "mse_phos": t.components[2]})
        rows.append(row)
    df = pd.DataFrame(rows)

    from phoskintime_tpu.io.export import TableWriter

    w = TableWriter(os.path.join(out_dir, "scan_results.xlsx"))
    w.add("Trials", df)
    table_path = w.save()

    done = df[df.state == "complete"]
    paths = {"table": table_path}

    # optimization history: score per trial + running best
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.scatter(df.trial, df.score, c=["tab:red" if s == "pruned"
                                      else "tab:blue" for s in df.state],
               s=28, label="trial")
    if len(done):
        ax.plot(done.trial, done.score.cummin(), color="tab:green",
                label="best so far")
    ax.set_xlabel("trial")
    ax.set_ylabel("weighted score")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    paths["history"] = os.path.join(out_dir, "optimization_history.png")
    fig.savefig(paths["history"], dpi=150)
    plt.close(fig)

    # parameter importance: |Spearman rank corr| of log-lambda vs score
    if len(done) >= 3:
        imp = {}
        ranks_s = done.score.rank()
        for k in KEYS:
            ranks_l = np.log10(done[f"lambda_{k}"]).rank()
            c = np.corrcoef(ranks_l, ranks_s)[0, 1]
            imp[k] = abs(float(c)) if np.isfinite(c) else 0.0
        fig, ax = plt.subplots(figsize=(6, 3.5))
        ks = sorted(imp, key=imp.get)
        ax.barh(ks, [imp[k] for k in ks], color="tab:blue")
        ax.set_xlabel("|Spearman corr| with score")
        ax.set_title("Hyperparameter importance")
        fig.tight_layout()
        paths["importance"] = os.path.join(out_dir, "param_importance.png")
        fig.savefig(paths["importance"], dpi=150)
        plt.close(fig)

    # parallel coordinates: normalized log-lambdas + score, best in green
    if len(done) >= 2:
        cols = [f"lambda_{k}" for k in KEYS]
        M = np.log10(done[cols].to_numpy(float))
        M = np.column_stack([M, np.log10(done.score.to_numpy(float))])
        lo, hi = M.min(axis=0), M.max(axis=0)
        Mn = (M - lo) / np.maximum(hi - lo, 1e-12)
        best_i = int(done.score.to_numpy().argmin())
        fig, ax = plt.subplots(figsize=(7, 4))
        for r in range(len(Mn)):
            ax.plot(range(M.shape[1]), Mn[r],
                    color="tab:green" if r == best_i else "tab:blue",
                    alpha=1.0 if r == best_i else 0.35,
                    lw=2.0 if r == best_i else 1.0)
        ax.set_xticks(range(M.shape[1]))
        ax.set_xticklabels([k for k in KEYS] + ["score"], rotation=20)
        ax.set_ylabel("normalized log10")
        fig.tight_layout()
        paths["parallel"] = os.path.join(out_dir, "parallel_coordinates.png")
        fig.savefig(paths["parallel"], dpi=150)
        plt.close(fig)
    return paths


def run_hyperparameter_scan(system, slices, loss_data, defaults, time_grid,
                            xl, xu, *, n_outer=20, inner_gens=15,
                            inner_pop=64, seed=42, loss_mode=0, mesh=None,
                            lambda_ranges=None, logger=None,
                            gen_step=5, n_startup_prune=3,
                            prune_factor=1.0, out_dir=None,
                            checkpoint_path=None, solver="expo"):
    """Nested hyperparameter scan with real pruning and reporting.

    Returns (best_lambdas, trials) — ``trials`` is a list of
    :class:`ScanTrial` (each also unpacks as ``(lambdas, score)``).

    Pruning (reference OptunaPruningCallback + MedianPruner): every
    ``gen_step`` inner generations the best weighted score is reported;
    after ``n_startup_prune`` completed trials, a trial whose report at
    step g exceeds ``prune_factor`` x the median of earlier trials'
    reports at step g is STOPPED (the inner GA terminates early — the
    evaluations are actually saved, not just flagged).

    ``checkpoint_path`` enables pause/resume (reference SQLite storage):
    completed trials and the TPE sampler state persist after every trial.
    ``out_dir`` writes the results table + plots via :func:`scan_report`.

    solver: "expo" (default) runs inner trials on the PRODUCTION
    population objective through the all-device GA loop with
    ``gen_step`` generations per dispatch — the lambdas are tuned with
    the same numerics the final fit will use, and the pruning report
    boundary coincides with the dispatch boundary. "rk45" keeps the
    adaptive-RK45 host-evaluated path.
    """
    if lambda_ranges is None:
        lambda_ranges = {"protein": (0.1, 10.0), "rna": (0.1, 10.0),
                         "phospho": (0.1, 10.0), "prior": (0.01, 1.0)}
    keys = list(lambda_ranges)
    lo = np.log10([lambda_ranges[k][0] for k in keys])
    hi = np.log10([lambda_ranges[k][1] for k in keys])
    sampler = MOTPESampler(lo, hi, seed=seed,
                           n_startup_trials=max(5, n_outer // 4))

    trials: list[ScanTrial] = []
    if checkpoint_path:
        os.makedirs(os.path.dirname(checkpoint_path) or ".", exist_ok=True)
        trials = _load_state(checkpoint_path, sampler)
        if trials and logger is not None:
            logger.info(f"[Scan] resumed {len(trials)} trials from "
                        f"{checkpoint_path}")

    def reports_at(step):
        return [s for t in trials if t.state == "complete"
                for g, s in t.intermediate if g == step]

    for it in range(len(trials), n_outer):
        x = sampler.ask()
        lambdas = {k: float(10 ** v) for k, v in zip(keys, x)}
        if solver == "expo":
            from phoskintime_tpu.network.objective import (
                make_population_objective)

            pop_objective = make_population_objective(
                system, slices, loss_data, defaults, lambdas, time_grid,
                loss_mode=loss_mode)
        else:
            objective = make_objective(system, slices, loss_data, defaults,
                                       lambdas, time_grid,
                                       loss_mode=loss_mode)
            evaluate = make_batched_evaluate(objective, mesh=mesh)

        trial = ScanTrial(lambdas, np.inf, "complete")

        def cb(gen, X, F, _t=trial):
            if gen % gen_step:
                return False
            s, _ = _weighted_score(F)
            _t.intermediate.append((gen, s))
            _t.n_gen = gen
            prev = reports_at(gen)
            n_done = sum(t.state == "complete" for t in trials)
            if n_done >= n_startup_prune and prev and \
                    s > prune_factor * float(np.median(prev)):
                _t.state = "pruned"
                return True  # stop the inner GA now
            return False

        if solver == "expo":
            from phoskintime_tpu.ops.nsga_device import run_unsga3_device

            res = run_unsga3_device(pop_objective, xl, xu,
                                    pop_size=inner_pop, n_gen=inner_gens,
                                    seed=seed + it, ftol=0.0,
                                    n_max_evals=None, callback=cb,
                                    gens_per_block=gen_step, mesh=mesh)
        else:
            res = run_unsga3(evaluate, xl, xu, pop_size=inner_pop,
                             n_gen=inner_gens, seed=seed + it, ftol=0.0,
                             n_max_evals=None, callback=cb)
        trial.n_gen = res.n_gen
        score, bi = _weighted_score(res.pareto_F)
        trial.score = score
        trial.components = tuple(float(v) for v in res.pareto_F[bi])
        # pruned trials feed the sampler their (poor) partial score, like
        # Optuna records pruned trials with the last reported value
        sampler.tell(x, np.asarray([score]))
        trials.append(trial)
        if checkpoint_path:
            _save_state(checkpoint_path, trials, sampler)
        if logger is not None:
            logger.info(f"[Scan] trial {it}: {lambdas} -> {score:.4g}"
                        + (" (pruned)" if trial.state == "pruned" else ""))

    done = [t for t in trials if t.state == "complete"] or trials
    best = min(done, key=lambda t: t.score)
    if out_dir:
        scan_report(trials, out_dir)
    return best.lambdas, trials
