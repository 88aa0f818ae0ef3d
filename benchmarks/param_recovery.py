"""Parameter-recovery experiment at north-star scale (synthetic truth).

BASELINE.md's north star names "matching reference parameters to 1e-6
rtol". Parameters of a sloppy systems-biology network model are only
determined by the data along the IDENTIFIABLE directions of the
Gauss-Newton J^T J at the truth (cond ~1e8 at this scale: moving along
small-singular-value directions changes the residual below solver
tolerance, so NO optimizer — the reference's included — can pin them).
This experiment therefore reports, at every stage of the production fit
ladder (GA -> bounded-Adam polish -> exact-Jacobian LM finish):

  * observable median/p90 relative error (what the data constrains),
  * per-direction error in the identifiable subspace of J(theta*):
    proj_k = |v_k . (theta - theta*)| / (1 + |v_k . theta*|) over
    singular directions with sigma_k >= tau * sigma_max (tau 1e-4 ~
    eigenvalue 1e-8; the table also reports the tau=1e-2 "strongly
    identifiable" tier) — the same convention docs/PARITY.md pins
    per-gene at f64.

The recovery objective runs with prior-adherence weight 0 (--prior): the
production prior penalty (lambda 0.1 toward `defaults`) moves the optimum
away from theta* and floors the attainable observable error at ~1e-2 no
matter the optimizer; with it off, the exact-J LM converges quadratically
to the dtype floor. Device figures for this script: not measured on the
H100 yet.

Run on the GPU (production f32 path):   python benchmarks/param_recovery.py
Small-scale f64-CPU variant (the 1e-6 capability proof):
    JAX_PLATFORMS=cpu python benchmarks/param_recovery.py --small

Reference anchor: the reference's best refinement tool is bound-zoom
re-sampling (``global_model/refine.py:32-357``); it has no gradient or
Gauss-Newton stage at all (LSODA is not differentiable), so this ladder
has no reference counterpart beyond stage 0.
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def identifiable_basis(b, theta_star, jac_chunk=256):
    """SVD of the GN Jacobian at the truth -> (sigma, V) in raw space."""
    import jax
    import jax.numpy as jnp

    from phoskintime_tpu.network.objective import make_residual_fn

    residuals = make_residual_fn(b["system"], b["slices"], b["loss_data"],
                                 b["defaults"], b["lambdas"], b["grid"])
    wdt = b["system"].rhs.W_pad.dtype
    n = theta_star.size
    chunk = max(1, min(jac_chunk, n))

    @jax.jit
    def jac_chunk_fn(th, V):
        return jax.vmap(lambda v: jax.jvp(residuals, (th,), (v,))[1])(V)

    eye = np.eye(n, dtype=np.asarray(theta_star).dtype)
    th_j = jnp.asarray(theta_star, wdt)
    rows = []
    for c0 in range(0, n, chunk):
        V = eye[c0:c0 + chunk]
        if V.shape[0] < chunk:
            V = np.vstack([V, np.zeros((chunk - V.shape[0], n), V.dtype)])
        rows.append(np.asarray(jac_chunk_fn(th_j, jnp.asarray(V, wdt)),
                               np.float64)[: min(chunk, n - c0)])
    J = np.concatenate(rows, axis=0).T            # (M, n)
    _, sig, Vt = np.linalg.svd(J, full_matrices=False)
    return sig, Vt.T                               # V columns = directions


def _fps_starts(X, F_sum, K, scale):
    """Diversity-aware multistart selection: greedy farthest-point
    sampling over the polished set, seeded at the best scalarized F.

    Top-K-by-F (the round-4 rule) samples ONE basin K times whenever the
    front's best members cluster — measured on the 10k cold-start front
    the top-16 by F were pairwise closer than the basin-merge threshold.
    FPS instead maximizes the minimum pairwise start distance, i.e. it
    covers as many distinct basins as K allows. Candidates are gated to
    the better half by F so diversity never spends starts on unpolished
    stragglers."""
    order = np.argsort(F_sum)
    cand = order[: max(K, len(order) // 2)]
    chosen = [cand[0]]
    d_min = np.full(len(cand), np.inf)
    for _ in range(1, min(K, len(cand))):
        d = np.linalg.norm((X[cand] - X[chosen[-1]]) / scale, axis=1)
        d_min = np.minimum(d_min, d)
        d_min[np.isin(cand, chosen)] = -1.0
        chosen.append(cand[int(np.argmax(d_min))])
    return np.asarray(chosen)


def _cluster_basins(X, scale, rel_tol=0.05):
    """Greedy single-linkage clustering of optimizer endpoints into
    basins: two endpoints share a basin iff their scale-normalized rms
    coordinate distance is < rel_tol. Returns a label array."""
    n = len(X)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        for j in range(i + 1, n):
            d = np.sqrt(np.mean(((X[i] - X[j]) / scale) ** 2))
            if d < rel_tol:
                parent[find(i)] = find(j)
    roots = {}
    labels = np.empty(n, int)
    for i in range(n):
        labels[i] = roots.setdefault(find(i), len(roots))
    return labels


def stage_metrics(name, b, theta, sig, V, theta_star, extra=None):
    """One JSON line: observable + identifiable-subspace errors."""
    from benchmarks.bench_suite import _observable_recovery

    d = np.asarray(theta, np.float64) - theta_star
    proj = np.abs(V.T @ d) / (1.0 + np.abs(V.T @ theta_star))
    obs = _observable_recovery(b, theta)
    out = {"stage": name,
           "observable_median_rel_err": float(f"{np.median(obs):.4g}"),
           "observable_p90_rel_err":
               float(f"{np.percentile(obs, 90):.4g}")}
    for tau, tag in [(1e-2, "strong"), (1e-4, "ident")]:
        m = sig >= tau * sig[0]
        out[f"{tag}_n"] = int(m.sum())
        out[f"{tag}_median_rel_err"] = float(f"{np.median(proj[m]):.4g}")
        out[f"{tag}_max_rel_err"] = float(f"{np.max(proj[m]):.4g}")
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="N=40 f64-capable scale (run with JAX_PLATFORMS=cpu "
                         "and x64 for the 1e-6 capability proof)")
    ap.add_argument("--gens", type=int, default=400)
    ap.add_argument("--pop", type=int, default=384)
    ap.add_argument("--gens-per-dispatch", type=int, default=1,
                    help=">1 routes the GA through the all-device loop "
                         "(required for the 10k-ensemble north-star arm; "
                         "ranking is the column-shardable fixpoint)")
    ap.add_argument("--polish-steps", type=int, default=600)
    ap.add_argument("--polish-top", type=int, default=0,
                    help="polish only the best K Pareto members by "
                         "objective sum (0 = all; use with the 10k-member "
                         "device-loop GA, whose front can be thousands "
                         "of members)")
    ap.add_argument("--lm-iters", type=int, default=40)
    ap.add_argument("--lm-iters-hi", type=int, default=12,
                    help="(--mixed-finish) f64 finish iterations")
    ap.add_argument("--lm-starts", type=int, default=1,
                    help="LM multistart: finish from K polished members, "
                         "keep the best SSE")
    ap.add_argument("--diverse-starts", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="pick the K multistart points by farthest-point "
                         "sampling over the polished set (basin COVERAGE) "
                         "instead of top-K by scalarized F (which samples "
                         "one basin K times when the front's best members "
                         "cluster)")
    ap.add_argument("--near-truth", action="store_true",
                    help="skip GA/Adam; run the LM finish alone from "
                         "theta* + 5%% relative noise. Separates optimizer "
                         "capability (quadratic local convergence to the "
                         "dtype/integrator floor) from global basin "
                         "selection, which is what the full ladder's "
                         "residual error measures.")
    ap.add_argument("--perturb", type=float, default=0.05,
                    help="relative perturbation scale for --near-truth")
    ap.add_argument("--mixed-finish", action="store_true",
                    help="(--near-truth only) after the working-dtype LM "
                         "converges to its rounding floor, run a float64-"
                         "system finish ON THE SAME BACKEND "
                         "(polish.lm_refine_mixed). Enables x64 process-"
                         "wide; the identifiable basis and stage metrics "
                         "for the finish run through the f64 system.")
    ap.add_argument("--self-consistent", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="(--near-truth only) minimize ||r(theta)-r(theta*)||^2 "
                         "— the zero-residual formulation. Without it the "
                         "data's own integrator truncation error (generated "
                         "on the modality grids, fit on the merged grid) "
                         "displaces the residual's global min from theta* "
                         "by ~1e-4 relative, a spurious recovery floor "
                         "(measured: LM converges to |grad|~3e-13 at sse "
                         "4.3e-8 while sse(theta*)=2.4e-7). OPT-IN (default "
                         "off) so the default arm is honest recovery-from-"
                         "data; when on, the emitted stage is tagged "
                         "'lm_from_near_truth_selfconsistent' so result "
                         "JSON is self-describing.")
    ap.add_argument("--prior", type=float, default=0.0,
                    help="prior-adherence weight. MUST be 0 for a recovery "
                         "experiment: the production default 0.1 pulls the "
                         "optimum toward `defaults`, away from theta*, and "
                         "floors the attainable error at ~1e-2 regardless "
                         "of optimizer quality.")
    args = ap.parse_args()

    if args.small:
        # force the platform before first backend use, so the small f64
        # variant runs on the CPU even on a machine with a GPU
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    elif args.mixed_finish:
        # f64 finish stage runs on the GPU itself: x64 must be on before
        # any tracing (f32 programs keep f32 via their explicit dtypes)
        import jax
        jax.config.update("jax_enable_x64", True)

    from phoskintime_tpu.demo import build_demo_network
    from phoskintime_tpu.network.optimize import run_global_fit
    from phoskintime_tpu.network.polish import (lm_refine, polish_solutions,
                                                simplex_weights)
    from phoskintime_tpu.parallel.profile import enable_compilation_cache

    enable_compilation_cache()

    if args.small:
        # genuine f64 weights end-to-end (the default f32 system would
        # floor the parameter match at ~1e-5 even under x64)
        b = build_demo_network(n_proteins=40, n_kinases=12, seed=0,
                               dtype=np.float64)
        n_gen = min(args.gens, 200)
    else:
        b = build_demo_network(n_proteins=150, n_kinases=24, seed=1)
        n_gen = args.gens
    b["lambdas"] = dict(b["lambdas"], prior=args.prior)
    theta_star = np.asarray(b["theta_true"], np.float64)
    n_var = theta_star.size

    # mixed-finish metrics run through the f64 system — the exact model
    # whose f32 tensors the production system rounds from (lossless
    # upward cast; Kmat/grid/y0 are stored at full host precision)
    b_hi = (dict(b, system=b["system"].astype(np.float64))
            if args.mixed_finish else b)

    t0 = time.perf_counter()
    sig, V = identifiable_basis(b_hi, theta_star)
    print(json.dumps({"stage": "jacobian_at_truth", "n_var": n_var,
                      "n_residuals": "svd", "cond": float(f"{sig[0] / sig[-1]:.4g}"),
                      "sigma_max": float(f"{sig[0]:.4g}"),
                      "n_ident_1e-4": int((sig >= 1e-4 * sig[0]).sum()),
                      "n_strong_1e-2": int((sig >= 1e-2 * sig[0]).sum()),
                      "wall_s": round(time.perf_counter() - t0, 1)}),
          flush=True)

    if args.near_truth:
        # ---- capability arm: LM alone from a perturbed truth ----------
        # (the north-star clause is about what the OPTIMIZER can pin once
        # the basin is right; the full ladder below also measures how well
        # the global stage finds that basin)
        rng = np.random.default_rng(7)
        th0 = np.clip(theta_star + args.perturb
                      * rng.standard_normal(n_var) * (1 + np.abs(theta_star)),
                      np.asarray(b["xl"], float), np.asarray(b["xu"], float))
        stage_metrics("start_perturbed", b, th0, sig, V, theta_star,
                      {"perturb": args.perturb})
        r_off = None
        if args.self_consistent:
            import jax
            import jax.numpy as jnp

            from phoskintime_tpu.network.objective import make_residual_fn
            res_fn = jax.jit(make_residual_fn(
                b["system"], b["slices"], b["loss_data"], b["defaults"],
                b["lambdas"], b["grid"]))
            wdt = b["system"].rhs.W_pad.dtype
            r_off = np.asarray(res_fn(jnp.asarray(theta_star, wdt)))
            print(json.dumps({"stage": "self_consistent_offset",
                              "sse_at_truth_raw": float(f"{float(r_off @ r_off):.4g}")}),
                  flush=True)
        t0 = time.perf_counter()
        th_lm, sse = lm_refine(b["system"], b["slices"], b["loss_data"],
                               b["defaults"], b["lambdas"], b["grid"],
                               th0, b["xl"], b["xu"], iters=args.lm_iters,
                               r_offset=r_off)
        stage = ("lm_from_near_truth_selfconsistent" if args.self_consistent
                 else "lm_from_near_truth")
        stage_metrics(stage, b, th_lm, sig, V, theta_star,
                      {"wall_s": round(time.perf_counter() - t0, 1),
                       "sse": float(f"{sse:.6g}"), "iters": args.lm_iters})
        if args.mixed_finish:
            # ---- f64-system finish on the SAME backend ----------------
            from phoskintime_tpu.network.polish import lm_refine_mixed

            r_off_hi = None
            if args.self_consistent:
                import jax
                import jax.numpy as jnp

                from phoskintime_tpu.network.objective import \
                    make_residual_fn
                res_hi = jax.jit(make_residual_fn(
                    b_hi["system"], b["slices"], b["loss_data"],
                    b["defaults"], b["lambdas"], b["grid"]))
                r_off_hi = np.asarray(res_hi(
                    jnp.asarray(theta_star, jnp.float64)))
            t0 = time.perf_counter()
            th_mx, sse_mx = lm_refine_mixed(
                b["system"], b["slices"], b["loss_data"], b["defaults"],
                b["lambdas"], b["grid"], th_lm, b["xl"], b["xu"],
                iters_lo=0, iters_hi=args.lm_iters_hi,
                r_offset_hi=r_off_hi)
            stage_metrics(stage + "_mixed_f64_finish", b_hi, th_mx, sig, V,
                          theta_star,
                          {"wall_s": round(time.perf_counter() - t0, 1),
                           "sse_f64": float(f"{sse_mx:.6g}"),
                           "iters_hi": args.lm_iters_hi})
            stage_metrics("floor_truth_f64", b_hi, theta_star, sig, V,
                          theta_star,
                          {"note": "theta* through the f64 pipeline"})
        stage_metrics("floor_truth", b, theta_star, sig, V, theta_star,
                      {"note": "theta* through the same pipeline: the"
                               " dtype/integrator noise floor"})
        return

    # ---- stage 0: converged UNSGA3 ------------------------------------
    t0 = time.perf_counter()
    res = run_global_fit(b["system"], b["slices"], b["loss_data"],
                         b["defaults"], b["lambdas"], b["grid"],
                         b["xl"], b["xu"], pop=args.pop, n_gen=n_gen,
                         seed=0, ftol=0.001, ftol_period=25,
                         n_max_evals=max(200_000, args.pop * n_gen // 2),
                         frechet_pick=False,
                         gens_per_dispatch=args.gens_per_dispatch)
    ga_wall = time.perf_counter() - t0
    best = res.pareto_X[np.argmin(res.pareto_F.sum(axis=1))]
    stage_metrics("0_ga", b, best, sig, V, theta_star,
                  {"wall_s": round(ga_wall, 1), "n_evals": int(res.n_evals)})

    # ---- stage 1: bounded-Adam polish of the Pareto set ---------------
    t0 = time.perf_counter()
    par_X, par_F = res.pareto_X, res.pareto_F
    if args.polish_top and len(par_X) > args.polish_top:
        keep = np.argsort(np.asarray(par_F).sum(axis=1))[: args.polish_top]
        par_X, par_F = par_X[keep], par_F[keep]
    pX, pF = polish_solutions(b["system"], b["slices"], b["loss_data"],
                              b["defaults"], b["lambdas"], b["grid"],
                              par_X, b["xl"], b["xu"],
                              weights=simplex_weights(par_F),
                              steps=args.polish_steps, chunk=128)
    pbest = pX[np.argmin(np.asarray(pF).sum(axis=1))]
    stage_metrics("1_adam_polish", b, pbest, sig, V, theta_star,
                  {"wall_s": round(time.perf_counter() - t0, 1),
                   "steps": args.polish_steps})

    # ---- stage 2: exact-Jacobian LM finish (multistart over basins) ----
    t0 = time.perf_counter()
    pXa, pFs = np.asarray(pX), np.asarray(pF).sum(axis=1)
    K = max(1, args.lm_starts)
    scale = np.maximum(np.std(pXa, axis=0), 1e-3)
    if args.diverse_starts and len(pXa) > K:
        idx = _fps_starts(pXa, pFs, K, scale)
    else:
        idx = np.argsort(pFs)[:K]
    # how many basins does the polished front itself cover?
    lab_front = _cluster_basins(pXa[np.argsort(pFs)[: max(64, K)]], scale)
    print(json.dumps({"stage": "2_front_coverage",
                      "n_polished_considered": int(len(lab_front)),
                      "n_front_basins": int(lab_front.max() + 1),
                      "starts_mode": ("fps" if args.diverse_starts
                                      else "top_by_F")}), flush=True)
    ends, sses = [], []
    th_lm, sse = None, np.inf
    for k, th0 in enumerate(pXa[idx]):
        th_k, sse_k = lm_refine(b["system"], b["slices"], b["loss_data"],
                                b["defaults"], b["lambdas"], b["grid"],
                                th0, b["xl"], b["xu"], iters=args.lm_iters)
        ends.append(np.asarray(th_k, np.float64))
        sses.append(float(sse_k))
        d = ends[-1] - theta_star
        proj = np.abs(V.T @ d) / (1.0 + np.abs(V.T @ theta_star))
        m = sig >= 1e-2 * sig[0]
        print(json.dumps({"stage": "2_lm_start", "k": k,
                          "sse": float(f"{sse_k:.6g}"),
                          "strong_median_rel_err":
                              float(f"{np.median(proj[m]):.4g}")}),
              flush=True)
        if sse_k < sse:
            th_lm, sse = th_k, sse_k
    stage_metrics("2_lm_finish", b, th_lm, sig, V, theta_star,
                  {"wall_s": round(time.perf_counter() - t0, 1),
                   "sse": float(f"{sse:.6g}"), "iters": args.lm_iters,
                   "starts": int(len(idx))})

    # ---- basin analysis over the LM endpoints -------------------------
    # (the quantified fallback: if the landscape defeats the ladder, say
    # exactly how — basin count, per-basin quality, truth-basin reach)
    import jax as _jax
    import jax.numpy as _jnp

    from phoskintime_tpu.network.objective import make_residual_fn
    res_fn = _jax.jit(make_residual_fn(b["system"], b["slices"],
                                       b["loss_data"], b["defaults"],
                                       b["lambdas"], b["grid"]))
    wdt = b["system"].rhs.W_pad.dtype
    r_star = np.asarray(res_fn(_jnp.asarray(theta_star, wdt)))
    sse_star = float(r_star @ r_star)
    E, S = np.asarray(ends), np.asarray(sses)
    labels = _cluster_basins(E, scale)
    basins = []
    m = sig >= 1e-2 * sig[0]
    for bi in range(labels.max() + 1):
        sel = labels == bi
        kb = int(np.flatnonzero(sel)[np.argmin(S[sel])])
        d = E[kb] - theta_star
        proj = np.abs(V.T @ d) / (1.0 + np.abs(V.T @ theta_star))
        basins.append({"size": int(sel.sum()),
                       "best_sse": float(f"{S[sel].min():.6g}"),
                       "strong_median_rel_err":
                           float(f"{np.median(proj[m]):.4g}")})
    basins.sort(key=lambda r: r["best_sse"])
    print(json.dumps({"stage": "2_basin_analysis",
                      "n_starts": int(len(E)),
                      "n_endpoint_basins": int(labels.max() + 1),
                      "sse_at_truth": float(f"{sse_star:.6g}"),
                      "truth_basin_reached":
                          bool(S.min() <= max(100.0 * sse_star, 1e-6)),
                      "basins": basins}), flush=True)

    # floor reference: the truth itself through the same metrics (its
    # "error" is the dtype/integrator noise floor)
    stage_metrics("floor_truth", b, theta_star, sig, V, theta_star,
                  {"note": "theta* through the same pipeline: the"
                           " dtype/integrator noise floor"})


if __name__ == "__main__":
    main()
