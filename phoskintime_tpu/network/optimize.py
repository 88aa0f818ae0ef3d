"""Global network fit driver: population search + refinement + selection.

Spec: reference ``global_model/runner.py:615-860`` — UNSGA3 (pop 300,
das-dennis partitions=20, SBX 0.9/15, PM 1/n/10, LHS, sliding ftol) or
Optuna MOTPE (n_trials, pruning on crash), optional iterative bound-zoom
refinement (``refine.py:32-357``), and Frechet-distance solution picking
per modality (``runner.py:775-858``).

Accelerator-native: the evaluate callable wraps the vmapped objective (optionally
sharded over a device Mesh); GA bookkeeping is host-side.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from phoskintime_tpu.network.objective import evaluate_population, make_objective
from phoskintime_tpu.network.params import unpack_params
from phoskintime_tpu.ops.frechet import frechet_distance
from phoskintime_tpu.ops.nsga import MOOResult, lhs_sampling, run_unsga3


def make_batched_evaluate(objective, mesh=None, pad_to: int | None = None):
    """numpy (P, n) -> (P, 3) evaluator around the jitted vmapped objective.

    Pads the population to a fixed multiple so XLA compiles once (and the
    mesh divides the batch evenly)."""
    def evaluate(X):
        X = np.asarray(X, float)
        P = len(X)
        Ppad = P
        if pad_to is not None:
            Ppad = int(np.ceil(P / pad_to) * pad_to)
        if mesh is not None:
            n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
            Ppad = int(np.ceil(Ppad / n_dev) * n_dev)
        if Ppad != P:
            X = np.vstack([X, np.repeat(X[-1:], Ppad - P, axis=0)])
        F = np.asarray(evaluate_population(objective, jnp.asarray(X), mesh=mesh))
        return F[:P]
    return evaluate


@dataclass
class GlobalFitResult:
    X: np.ndarray
    F: np.ndarray
    pareto_X: np.ndarray
    pareto_F: np.ndarray
    best_idx: int                 # Frechet-picked solution index (into pareto)
    frechet_scores: np.ndarray
    history: list
    n_evals: int
    pop_history: list = None      # (gen, F) population snapshots for the video


def run_global_fit(system, slices, loss_data, defaults, lambdas, time_grid,
                   xl, xu, *, optimizer="pymoo", pop=300, n_gen=1000,
                   n_trials=1000, seed=42, loss_mode=0, mesh=None,
                   rtol=1e-5, atol=1e-7, max_steps=5000, y0=None,
                   refine=False, num_refinements=0, refine_padding=0.25,
                   frechet_pick=True, df_prot=None, df_rna=None, df_pho=None,
                   t_points=None, callback=None, logger=None,
                   ftol=0.0025, ftol_period=30,
                   n_max_evals=100_000, solver="auto",
                   checkpoint_path=None, checkpoint_every=10,
                   polish_steps=0, polish_lr=0.02,
                   device_variation=True,
                   gens_per_dispatch=1, gn_iters=0) -> GlobalFitResult:
    """End-to-end global fit (the runner.main optimization core).

    solver: "auto" uses the batched exponential fast path for every
    mechanism (ETD2RK with static phi tables for 0/1/2, ~4x the RK45
    throughput; per-segment exponential Rosenbrock for the saturating
    model 4, ~1.3x); "rk45"/"esdirk"/"expo" force a choice.

    optimizer: "pymoo" (UNSGA3), "optuna" (MOTPE), or "gradient" — a pure
    gradient-based multistart over Das-Dennis scalarization directions
    (no reference counterpart: the objective here is differentiable
    end-to-end, LSODA is not).

    device_variation (default True) fuses tournament/SBX/PM variation
    into the evaluation's XLA program when the objective is
    population-native (solver "expo"/"auto"), leaving only survival on the
    host — same operator distributions, jax RNG stream
    (:func:`phoskintime_tpu.ops.nsga.make_device_ga_step`). Set False for
    the host-numpy reference pipeline.

    gens_per_dispatch > 1 moves the ENTIRE generation loop on device
    (:func:`phoskintime_tpu.ops.nsga_device.run_unsga3_device`):
    variation, evaluation, non-dominated ranking and NSGA-III niching
    survival run as one XLA program per block of that many generations,
    so dispatch latency and host bookkeeping amortize by the block
    length. Checkpoint/pruning callbacks and the ftol stop then fire at
    block granularity (the ftol window itself still uses the exact
    per-generation ideal history). Requires the population-native
    objective (solver "expo"/"auto").

    polish_steps > 0 runs the exact-gradient Adam polish
    (:mod:`phoskintime_tpu.network.polish`) on the Pareto set after the
    search (and after refinement), merging polished members back through
    non-dominated sorting. The reference's only counterpart is bound-zoom
    re-sampling (``refine.py:32-357``).

    gn_iters > 0 (loss_mode 0 only) finishes with matrix-free
    Levenberg-Marquardt on the best-by-sum member — damped Gauss-Newton
    steps on the exact residual vector (:func:`polish.lm_refine`), the
    fastest local convergence the least-squares structure admits.
    """
    if solver == "auto":
        solver = "expo"  # ETD2RK for 0/1/2, exponential Rosenbrock for 4
    if solver == "expo":
        from phoskintime_tpu.network.objective import make_population_objective

        objective = make_population_objective(
            system, slices, loss_data, defaults, lambdas, time_grid,
            loss_mode=loss_mode, y0=y0)
    else:
        objective = make_objective(system, slices, loss_data, defaults,
                                   lambdas, time_grid, loss_mode=loss_mode,
                                   rtol=rtol, atol=atol, max_steps=max_steps,
                                   y0=y0, solver=solver)
    evaluate = make_batched_evaluate(objective, mesh=mesh)

    # pause/resume: checkpoint the GA population / TPE history
    x0 = None
    ck = None
    if checkpoint_path is not None:
        from phoskintime_tpu.parallel.checkpoint import GACheckpointer

        ck = GACheckpointer(checkpoint_path, every=checkpoint_every)
        x0 = ck.resume_x0()
        if x0 is not None and logger is not None:
            logger.info(f"[Fit] resuming from {checkpoint_path} "
                        f"(gen {ck.start_gen})")

    # population-objective snapshots feed the convergence animation
    # (reference export.py:146 pulls these from pymoo's save_history)
    pop_history: list = []

    def cb(gen, X, F):
        pop_history.append((gen, np.asarray(F, float).copy()))
        if ck is not None:
            ck(gen, X, F)
        if callback is not None:
            # propagate the early-stop protocol (truthy return stops the
            # GA, e.g. the hyperparameter scan's pruning callback)
            return callback(gen, X, F)
        return False

    device_step = None
    ga_prebuilt = None
    if optimizer == "gradient":
        from phoskintime_tpu.ops.nsga import fast_non_dominated_sort
        from phoskintime_tpu.network.polish import gradient_multistart

        Xg, Fg = gradient_multistart(
            system, slices, loss_data, defaults, lambdas, time_grid, xl, xu,
            pop=pop, steps=max(100, polish_steps or 300), lr=polish_lr,
            loss_mode=loss_mode, y0=y0, seed=seed, mesh=mesh)
        pf = fast_non_dominated_sort(Fg)[0]
        res = MOOResult(Xg, Fg, Xg[pf], Fg[pf], [],
                        0, pop * 3 * max(100, polish_steps or 300))
    elif optimizer == "optuna":
        from phoskintime_tpu.parallel.checkpoint import load_sampler, save_sampler
        from phoskintime_tpu.ops.tpe import MOTPESampler

        sampler = MOTPESampler(xl, xu, seed=seed)
        if checkpoint_path is not None:
            load_sampler(checkpoint_path + ".tpe", sampler)

        done = len(sampler.X)
        while done < n_trials:
            bsz = min(16, n_trials - done)
            Xb = sampler.ask_batch(bsz)
            Fb = evaluate(Xb)
            sampler.tell_batch(Xb, Fb)
            done += bsz
            if checkpoint_path is not None and done % (16 * checkpoint_every) < 16:
                save_sampler(checkpoint_path + ".tpe", sampler)
        pX, pF = sampler.pareto
        X_all = np.asarray(sampler.X)
        F_all = np.asarray(sampler.F)
        res = MOOResult(X_all, F_all, pX, pF, [], 0, len(X_all))
    else:
        # fused on-device variation+evaluation (one XLA call per
        # generation; host keeps survival only) whenever the objective is
        # population-native — on the earlier accelerator the host GA
        # pipeline cost more per generation than the device compute
        if getattr(objective, "_is_population", False) \
                and gens_per_dispatch > 1:
            from phoskintime_tpu.ops.nsga_device import (
                make_device_ga_blocks, run_unsga3_device)

            ga_prebuilt = make_device_ga_blocks(
                objective, len(np.asarray(xl)), pop,
                gens_per_block=gens_per_dispatch, mesh=mesh)
            res = run_unsga3_device(
                objective, xl, xu, pop_size=pop, n_gen=n_gen, seed=seed,
                ftol=ftol, ftol_period=ftol_period, n_max_evals=n_max_evals,
                x0=x0, gens_per_block=gens_per_dispatch, callback=cb,
                logger=logger, mesh=mesh, prebuilt=ga_prebuilt)
        else:
            if getattr(objective, "_is_population", False) \
                    and device_variation:
                from phoskintime_tpu.ops.nsga import make_device_ga_step

                device_step = make_device_ga_step(objective, xl, xu, pop,
                                                  mesh=mesh)
            res = run_unsga3(evaluate, xl, xu, pop_size=pop, n_gen=n_gen,
                             seed=seed, callback=cb, logger=logger,
                             verbose=logger is not None, x0=x0,
                             ftol=ftol, ftol_period=ftol_period,
                             n_max_evals=n_max_evals,
                             device_step=device_step)

    # ---- iterative refinement (bound zoom + warm start) -------------------
    if refine and num_refinements > 0:
        rng = np.random.default_rng(seed + 1)
        cur = res
        total_evals = res.n_evals
        cur_xl, cur_xu = np.asarray(xl, float), np.asarray(xu, float)
        for _ in range(num_refinements):
            new_xl, new_xu = get_refined_bounds(cur.pareto_X, cur_xl, cur_xu,
                                                padding=refine_padding)
            x0 = create_multistart_population(cur.pareto_X, pop, new_xl,
                                              new_xu, rng)
            if ga_prebuilt is not None:
                # bounds are traced in the device loop: the zoomed box
                # reuses the compiled block program
                from phoskintime_tpu.ops.nsga_device import run_unsga3_device

                nxt = run_unsga3_device(
                    objective, new_xl, new_xu, pop_size=pop,
                    n_gen=max(10, n_gen // 4), seed=seed + 2, x0=x0,
                    ftol=ftol, ftol_period=ftol_period,
                    gens_per_block=gens_per_dispatch, mesh=mesh,
                    prebuilt=ga_prebuilt)
            else:
                nxt = run_unsga3(evaluate, new_xl, new_xu, pop_size=pop,
                                 n_gen=max(10, n_gen // 4), seed=seed + 2,
                                 x0=x0, ftol=ftol, ftol_period=ftol_period,
                                 device_step=device_step)
            total_evals += nxt.n_evals
            if nxt.pareto_F.min(axis=0).sum() >= cur.pareto_F.min(axis=0).sum():
                break  # no improvement -> stop refining
            cur, cur_xl, cur_xu = nxt, new_xl, new_xu
        # n_evals must cover the WHOLE fit, not just the last round
        import dataclasses as _dc

        res = _dc.replace(cur, n_evals=total_evals)

    # ---- exact-gradient polish of the Pareto set ---------------------------
    if polish_steps > 0 and optimizer != "gradient" and len(res.pareto_X):
        from phoskintime_tpu.ops.nsga import fast_non_dominated_sort
        from phoskintime_tpu.network.polish import (polish_solutions,
                                                    simplex_weights)
        import dataclasses as _dc

        W = simplex_weights(res.pareto_F)
        pX, pF = polish_solutions(system, slices, loss_data, defaults,
                                  lambdas, time_grid, res.pareto_X, xl, xu,
                                  weights=W, steps=polish_steps,
                                  lr=polish_lr, loss_mode=loss_mode, y0=y0,
                                  mesh=mesh)
        if logger is not None:
            logger.info(f"[Polish] ideal {res.pareto_F.min(axis=0)} -> "
                        f"{pF.min(axis=0)} ({polish_steps} Adam steps)")
        X_all = np.vstack([res.X, pX])
        F_all = np.vstack([res.F, pF])
        pf = fast_non_dominated_sort(F_all)[0]
        res = _dc.replace(res, X=X_all, F=F_all, pareto_X=X_all[pf],
                          pareto_F=F_all[pf],
                          n_evals=res.n_evals
                          + 3 * polish_steps * len(pX))  # ~3 fwd-equiv/step

    # ---- final LM (Gauss-Newton) sharpening of the pick --------------------
    if gn_iters > 0 and len(res.pareto_X) and loss_mode == 0:
        from phoskintime_tpu.ops.nsga import fast_non_dominated_sort
        from phoskintime_tpu.network.polish import lm_refine
        import dataclasses as _dc

        bi = int(np.argmin(res.pareto_F.sum(axis=1)))
        th_gn, sse = lm_refine(system, slices, loss_data, defaults,
                               lambdas, time_grid, res.pareto_X[bi],
                               xl, xu, iters=gn_iters, y0=y0,
                               logger=logger)
        F_gn = np.asarray(evaluate(th_gn[None]), float)
        X_all = np.vstack([res.X, th_gn[None]])
        F_all = np.vstack([res.F, F_gn])
        pf = fast_non_dominated_sort(F_all)[0]
        res = _dc.replace(res, X=X_all, F=F_all, pareto_X=X_all[pf],
                          pareto_F=F_all[pf],
                          n_evals=res.n_evals + gn_iters * 30)
        if logger is not None:
            logger.info(f"[GN] best-by-sum sse -> {sse:.6g}")

    # ---- Frechet-distance solution picking --------------------------------
    best_idx, scores = 0, np.zeros(len(res.pareto_X))
    if frechet_pick and df_prot is not None and t_points is not None:
        best_idx, scores = pick_solution_frechet(
            system, slices, res.pareto_X, df_prot, df_rna, df_pho,
            t_points, lambdas)

    return GlobalFitResult(res.X, res.F, res.pareto_X, res.pareto_F,
                           best_idx, scores, res.history, res.n_evals,
                           pop_history)


# ---------------------------------------------------------------------------
# refinement helpers (reference refine.py:32-165)
# ---------------------------------------------------------------------------

def get_refined_bounds(X, current_xl, current_xu, padding=0.2):
    """Zoom bounds to the Pareto spread +/- padding, clamped to the originals."""
    X = np.asarray(X, float)
    p_min, p_max = X.min(axis=0), X.max(axis=0)
    span = np.maximum(p_max - p_min, 1e-2)
    new_xl = np.maximum(p_min - span * padding, current_xl)
    new_xu = np.minimum(p_max + span * padding, current_xu)
    return new_xl, new_xu


def create_multistart_population(X_best, pop_size, new_xl, new_xu, rng):
    """50% warm start (best individuals, noise-duplicated) + 50% fresh."""
    X_best = np.asarray(X_best, float)
    n_best = len(X_best)
    n_warm = pop_size // 2
    if n_best >= n_warm:
        X_warm = X_best[rng.choice(n_best, n_warm, replace=False)]
    else:
        extra = rng.integers(0, n_best, n_warm - n_best)
        noise = rng.normal(0, 0.05, (n_warm - n_best, X_best.shape[1])) * (new_xu - new_xl)
        X_warm = np.vstack([X_best, X_best[extra] + noise])
    X_warm = np.clip(X_warm, new_xl, new_xu)
    X_fresh = lhs_sampling(pop_size - n_warm, new_xl, new_xu, rng)
    return np.vstack([X_warm, X_fresh])


# ---------------------------------------------------------------------------
# Frechet-distance solution picking (reference runner.py:775-858)
# ---------------------------------------------------------------------------

def pick_solution_frechet(system, slices, pareto_X, df_prot, df_rna, df_pho,
                          t_points, lambdas):
    """Pick the Pareto member minimizing the weighted sum of per-curve
    discrete Frechet distances across modalities.

    Fully batched: ONE exponential (or RK45) simulation of all Pareto
    members, FC extraction as arrays, and a vmapped (solutions x curves)
    Frechet DP per modality — the reference loops pymoo solutions through
    pandas + per-curve Numba DP (runner.py:775-858)."""
    from phoskintime_tpu.network.simulate import extract_observables, fold_changes

    topo = system.topo
    tp_p, tp_r, tp_ph = (np.asarray(t, float) for t in t_points)
    P = len(pareto_X)
    times = np.unique(np.concatenate([tp_p, tp_r, tp_ph]))

    # --- batched simulation of every Pareto member (ONE jitted program:
    # run eagerly, the expo scan compiles op-by-op — ~100 s of XLA churn) --
    def _simulate_all(thetas):
        params_b = jax.vmap(
            lambda th: unpack_params(th, slices, topo)
        )(jnp.asarray(thetas, system.rhs.W_pad.dtype))
        from phoskintime_tpu.network.expo import exponential_simulate_batched

        # NOTE: pass host-side `times` — the segment planner needs
        # concrete values even under trace
        ys, _ = exponential_simulate_batched(system, params_b, times)

        def fc_all(Y_flat):
            obs = extract_observables(system, Y_flat)
            return fold_changes(obs, jnp.asarray(times))

        return jax.vmap(fc_all)(ys)

    fc_r, fc_p, fc_ph = jax.jit(_simulate_all)(np.asarray(pareto_X, float))
    fc_r, fc_p, fc_ph = np.asarray(fc_r), np.asarray(fc_p), np.asarray(fc_ph)

    t_idx = {float(t): i for i, t in enumerate(times)}

    def modality_score(df, grid, pred_cube, site_axis=False):
        return _modality_frechet_score(df, pred_cube, site_axis, topo, t_idx, P)

    scores = (lambdas["protein"] * modality_score(df_prot, tp_p, fc_p)
              + lambdas["rna"] * modality_score(df_rna, tp_r, fc_r)
              + lambdas["phospho"] * modality_score(df_pho, tp_ph, fc_ph,
                                                    site_axis=True))
    return int(np.argmin(scores)), scores


@jax.jit
def _frechet_pick_batch(obs_arr, pred_arr):
    """(C, Tc, 2) obs x (P, C, Tc, 2) preds -> (P, C) distances.

    Module-level jit: called eagerly this is ~400 separate tiny op
    dispatches per curve group (measured 90s of XLA compiles at reference
    scale); jitted it is one cached program per curve-group shape."""
    return jax.vmap(lambda pr: jax.vmap(frechet_distance)(obs_arr, pr))(pred_arr)


def _modality_frechet_score(df, pred_cube, site_axis, topo, t_idx, P):
    """Sum of per-curve Frechet over all P solutions: (P,) array."""
    if df is None or len(df) == 0:
        return np.zeros(P)
    total = np.zeros(P)
    keys = ["protein", "psite"] if site_axis else ["protein"]
    obs_list, pred_list = [], []
    for key, g in df.groupby(keys):
        key = key if isinstance(key, tuple) else (key,)
        g = g.sort_values("time")
        obs = g[["time", "fc"]].to_numpy(float)
        if len(obs) < 2:
            continue
        i = topo.p2i.get(key[0])
        if i is None:
            continue
        tsel = np.asarray([t_idx[float(tt)] for tt in g["time"]])
        if site_axis:
            if key[1] not in topo.sites[i]:
                continue
            s = topo.sites[i].index(key[1])
            pred_vals = pred_cube[:, tsel, i, s]          # (P, Tc)
        else:
            pred_vals = pred_cube[:, tsel, i]
        obs_list.append(obs)
        pred_list.append(np.stack(
            [np.broadcast_to(obs[:, 0][None], pred_vals.shape),
             pred_vals], axis=-1))                         # (P, Tc, 2)
    if not obs_list:
        return total
    # group curves by length so each group batches as one jitted call
    by_len: dict[int, list[int]] = {}
    for ci, o in enumerate(obs_list):
        by_len.setdefault(len(o), []).append(ci)
    for Tc, idxs in by_len.items():
        obs_arr = jnp.asarray(np.stack([obs_list[ci] for ci in idxs]))
        pred_arr = jnp.asarray(np.stack([pred_list[ci] for ci in idxs],
                                        axis=1))
        # pred_arr: (P, C, Tc, 2); obs_arr: (C, Tc, 2)
        d = np.asarray(_frechet_pick_batch(obs_arr, pred_arr))
        total += d.sum(axis=1)
    return total
