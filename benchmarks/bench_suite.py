"""Extended benchmark suite — the five BASELINE.md benchmark configs.

Each section prints one JSON line. ``bench.py`` at the repo root remains
the driver's single headline metric; this suite is the full evidence set:

1. distributive single-protein fit (normest)
2. successive + random mechanisms with steady-state init (batched solves)
3. global_model joint network fit (population objective throughput + a
   short UNSGA3 fit wall-clock)
4. Morris sensitivity batched over the full parameter space
5. kinopt/tfopt evolutionary optimization + knockout perturbation scan
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def section(name, value, unit, extra=None):
    # 6 significant digits, not fixed decimals — tiny precision deltas
    # (1e-4..1e-6) must not round to 0.0
    out = {"bench": name, "value": float(f"{float(value):.6g}"), "unit": unit}
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)


def main():
    import jax
    import jax.numpy as jnp

    # persistent XLA compile cache — the parity equivalent of the
    # reference's Numba disk caches (cache=True on every njit kernel):
    # first-ever run pays the compiles, repeat runs measure steady state
    from phoskintime_tpu.parallel.profile import enable_compilation_cache

    enable_compilation_cache()

    from phoskintime_tpu.fit.normest import normest, normest_batch
    from phoskintime_tpu.models.kinetics import (initial_condition,
                                                 solve_ode, solve_ode_batched)

    T = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                  120.0, 240.0, 480.0, 960.0], np.float32)
    B = {k: (0.0, 20.0) for k in ["A", "B", "C", "D", "S(i)", "D(i)"]}
    rng = np.random.default_rng(0)

    # ---- 1. distributive single-protein fit ------------------------------
    n = 2
    y0 = initial_condition(n, "distmod", dtype=jnp.float32)
    true = rng.uniform(0.3, 2.5, 4 + 2 * n).astype(np.float32)
    _, fit = solve_ode(jnp.asarray(true), y0, n, jnp.asarray(T), "distmod")
    fit = np.asarray(fit)
    Tn = len(T)
    r, pr, p = fit[:Tn - 5], fit[Tn - 5:2 * Tn - 5], fit[2 * Tn - 5:].reshape(n, Tn)
    t0 = time.perf_counter()
    res = normest("BENCH", pr, p, r, np.asarray(y0), n, T, B,
                  model="distmod", use_regularization=True, n_starts=48,
                  lm_iters=100)
    section("1_distributive_single_gene_fit", time.perf_counter() - t0,
            "s (10 lambdas + 48-start multistart + CIs)",
            {"fit_error": float(res.error)})

    # ---- 2. succ/rand mechanisms: batched exact solves --------------------
    for model, n_s in [("succmod", 3), ("randmod", 3)]:
        npar = 4 + 2 * n_s if model == "succmod" else 4 + n_s + (1 << n_s) - 1
        y0m = initial_condition(n_s, model, dtype=jnp.float32)
        batch = jnp.asarray(rng.uniform(0.3, 2.5, (8192, npar)), jnp.float32)
        f = jax.jit(lambda b: solve_ode_batched(b, y0m, n_s,
                                                jnp.asarray(T), model)[0])
        sols = f(batch)
        jax.block_until_ready(sols)
        t0 = time.perf_counter()
        sols = f(batch)
        jax.block_until_ready(sols)
        dt = time.perf_counter() - t0
        section(f"2_{model}_exact_solves", 8192 / dt,
                "ODE solves/s (batched expm, steady-state init)")

    # ---- 3. global model ---------------------------------------------------
    from phoskintime_tpu.demo import build_demo_network
    from phoskintime_tpu.network.objective import make_population_objective
    from phoskintime_tpu.network.optimize import run_global_fit

    b = build_demo_network(n_proteins=40, n_kinases=12, seed=0,
                           dtype=np.float32)
    objp = make_population_objective(b["system"], b["slices"], b["loss_data"],
                                     b["defaults"], b["lambdas"], b["grid"])
    P = 256
    thetas = jnp.asarray(b["theta0"][None]
                         + 0.05 * rng.normal(size=(P, len(b["theta0"]))),
                         jnp.float32)
    f = jax.jit(objp)
    F = f(thetas)
    jax.block_until_ready(F)
    t0 = time.perf_counter()
    for _ in range(5):
        F = f(thetas)
    jax.block_until_ready(F)
    section("3_global_objective_throughput", 5 * P / (time.perf_counter() - t0),
            "full-network stiff solves/s (pop=256, N=40)")

    # 3b. the saturating Michaelis-Menten mechanism (model 4): per-chunk
    # exponential-Rosenbrock path (state-dependent Jacobian)
    b4 = build_demo_network(n_proteins=40, n_kinases=12, model=4, seed=0,
                            dtype=np.float32)
    objp4 = make_population_objective(b4["system"], b4["slices"],
                                      b4["loss_data"], b4["defaults"],
                                      b4["lambdas"], b4["grid"])
    thetas4 = jnp.asarray(b4["theta0"][None]
                          + 0.05 * rng.normal(size=(2048,
                                                    len(b4["theta0"]))),
                          jnp.float32)
    f4 = jax.jit(objp4)
    F4 = f4(thetas4)
    jax.block_until_ready(F4)
    t0 = time.perf_counter()
    for _ in range(5):
        F4 = f4(thetas4)
    jax.block_until_ready(F4)
    section("3_model4_rosenbrock_throughput",
            5 * 2048 / (time.perf_counter() - t0),
            "saturating-mechanism solves/s (pop=2048, N=40, "
            "per-chunk expRB)")

    # 3c. the combinatorial hypercube mechanism (model 2): 2^Smax bitmask
    # states, jvp-extracted block operators in the ETD2RK path
    b2 = build_demo_network(n_proteins=40, n_kinases=12, model=2, seed=0,
                            dtype=np.float32)
    objp2 = make_population_objective(b2["system"], b2["slices"],
                                      b2["loss_data"], b2["defaults"],
                                      b2["lambdas"], b2["grid"])
    thetas2 = jnp.asarray(b2["theta0"][None]
                          + 0.05 * rng.normal(size=(2048,
                                                    len(b2["theta0"]))),
                          jnp.float32)
    f2 = jax.jit(objp2)
    F2 = f2(thetas2)
    jax.block_until_ready(F2)
    t0 = time.perf_counter()
    for _ in range(5):
        F2 = f2(thetas2)
    jax.block_until_ready(F2)
    section("3_model2_hypercube_throughput",
            5 * 2048 / (time.perf_counter() - t0),
            "combinatorial-mechanism solves/s (pop=2048, N=40, "
            "2^Smax states, width-bucketed)")

    # 3c-ablation: same program with width bucketing forced OFF — the
    # round-2 baseline path (every protein padded to w = 1 + 2^Smax)
    objp2f = make_population_objective(b2["system"], b2["slices"],
                                       b2["loss_data"], b2["defaults"],
                                       b2["lambdas"], b2["grid"],
                                       width_bucketing=False)
    f2f = jax.jit(objp2f)
    F2f = f2f(thetas2)
    jax.block_until_ready(F2f)
    t0 = time.perf_counter()
    for _ in range(5):
        F2f = f2f(thetas2)
    jax.block_until_ready(F2f)
    section("3_model2_unbucketed_ablation",
            5 * 2048 / (time.perf_counter() - t0),
            "solves/s (identical problem, full-width padded tables)",
            {"max_abs_diff": float(jnp.max(jnp.abs(F2 - F2f)))})

    # 3d: oversized-population chunking (the pop>=16k HBM-spill fix):
    # 32k lanes through lax.map chunks of 8192 vs the single program
    thetas32 = jnp.asarray(b["theta0"][None]
                           + 0.05 * rng.normal(size=(32768,
                                                     len(b["theta0"]))),
                           jnp.float32)
    for name, chunk in [("3_pop32k_chunked", 8192),
                        ("3_pop32k_unchunked_ablation", None)]:
        objc = make_population_objective(b["system"], b["slices"],
                                         b["loss_data"], b["defaults"],
                                         b["lambdas"], b["grid"],
                                         pop_chunk=chunk)
        fc_ = jax.jit(objc)
        Fc = fc_(thetas32)
        jax.block_until_ready(Fc)
        t0 = time.perf_counter()
        Fc = fc_(thetas32)
        jax.block_until_ready(Fc)
        section(name, 32768 / (time.perf_counter() - t0),
                "full-network solves/s (pop=32768, N=40)")

    # 3e: fused on-device GA variation vs the host numpy pipeline at the
    # north-star population shape (the 38 ms/gen host-term fix) — same
    # seeds, same generation count; s/gen includes evaluation both ways
    for name, dev, gpd in [("3_ga_device_variation", True, 1),
                           ("3_ga_host_variation_ablation", False, 1),
                           ("3_ga_device_loop_10pd", True, 10)]:
        # two passes: the first pays XLA compiles (persisted to the
        # compile cache), the second measures steady-state ms/generation —
        # at a 20-gen budget a one-shot timing is compile-dominated for
        # the fused device programs but not for the host ablation (which
        # reuses earlier arms' compiled objective), so one-shot numbers
        # are not comparable across the three arms
        walls = []
        for _pass in range(2):
            t0 = time.perf_counter()
            resg = run_global_fit(b["system"], b["slices"], b["loss_data"],
                                  b["defaults"], b["lambdas"], b["grid"],
                                  b["xl"], b["xu"], pop=384, n_gen=20, seed=0,
                                  ftol=0.0, frechet_pick=False,
                                  device_variation=dev, gens_per_dispatch=gpd)
            walls.append(time.perf_counter() - t0)
        cold, dt = walls
        section(name, dt / 20 * 1e3,
                "ms/generation (pop=384, incl eval, warm)",
                {"wall_s": round(dt, 2), "cold_wall_s": round(cold, 2),
                 "ideal": [round(float(v), 5)
                           for v in resg.pareto_F.min(axis=0)]})

    t0 = time.perf_counter()
    res3 = run_global_fit(b["system"], b["slices"], b["loss_data"],
                          b["defaults"], b["lambdas"], b["grid"],
                          b["xl"], b["xu"], pop=128, n_gen=20, seed=0,
                          ftol=0.0, frechet_pick=False)
    section("3_global_fit_20gen_pop128", time.perf_counter() - t0,
            "s wall-clock", {"n_evals": int(res3.n_evals),
                             "ideal": [round(float(v), 5)
                                       for v in res3.pareto_F.min(axis=0)]})

    # ---- 4. Morris over the full fitted parameter space --------------------
    from phoskintime_tpu.fit.sensitivity import sensitivity_analysis

    t0 = time.perf_counter()
    out = sensitivity_analysis(res.params, np.asarray(y0), n, T,
                               np.concatenate([r, pr, p.ravel()]),
                               model="distmod", num_trajectories=1000,
                               num_levels=400)
    dt = time.perf_counter() - t0
    n_samples = len(out.Y)
    section("4_morris_per_gene_reference_budget", n_samples / dt,
            "ODE solves/s (1000 trajectories x 400 levels)",
            {"n_samples": n_samples, "wall_s": round(dt, 2)})

    # ---- 5. kinopt evolutionary + knockout scan ---------------------------
    from phoskintime_tpu.kinopt.model import build_problem
    from phoskintime_tpu.kinopt.optimize import run_evolutionary
    from phoskintime_tpu.models.kinetics import solve_ode_batched as sob
    from phoskintime_tpu.models.knockout import knockout_mask_matrix

    K_array = rng.uniform(0.5, 2.0, (20, 14))
    kinase_rows = [list(range(4 * j, 4 * j + 4)) for j in range(5)]
    site_kinases = [[j % 5, (j + 1) % 5] for j in range(30)]
    beta = rng.dirichlet(np.ones(4), 5)
    sig = np.stack([beta[j] @ K_array[kinase_rows[j]] for j in range(5)])
    P_obs = np.stack([0.5 * sig[s[0]] + 0.5 * sig[s[1]] for s in site_kinases])
    prob = build_problem(P_obs, site_kinases, kinase_rows, K_array)
    t0 = time.perf_counter()
    kres = run_evolutionary(prob, method="DE", pop_size=100, n_gen=200, seed=0)
    dt = time.perf_counter() - t0
    section("5_kinopt_DE_200gen", dt, "s wall-clock",
            {"loss": round(float(kres.loss), 6), "feasible": bool(kres.feasible)})

    masks, combos = knockout_mask_matrix(n, 4 + 2 * n)
    ko_params = jnp.asarray(res.params[None] * masks, jnp.float32)
    fko = jax.jit(lambda kp: sob(kp, y0, n, jnp.asarray(T), "distmod")[0])
    s = fko(ko_params)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    s = fko(ko_params)
    jax.block_until_ready(s)
    section("5_knockout_scan", (time.perf_counter() - t0) * 1e3,
            "ms for full combination scan", {"n_combos": len(combos)})

    # ---- 6. north star: converged fit at reference scale -------------------
    # Reference: ~1094 free params (refine.py:68), pop=300, 80 CPU cores.
    northstar_fit(rng)
    precision_delta(rng)


def _recovery_errors(b, theta_best):
    """Relative parameter-recovery error vs the synthetic truth, in
    PHYSICAL space (softplus-unpacked), masked to real (non-padded) sites."""
    import jax.numpy as jnp

    from phoskintime_tpu.network.params import unpack_params

    topo = b["topo"]
    fit = unpack_params(jnp.asarray(theta_best), b["slices"], topo)
    msk = np.asarray(topo.site_mask(), bool)
    rels = []
    for k, tv in b["true"].items():
        fv = np.asarray(fit[k], float)
        tv = np.asarray(tv, float)
        if k == "Dp_i":
            fv, tv = fv[msk], tv[msk]
        rels.append(np.abs(fv - tv).ravel() / np.maximum(np.abs(tv).ravel(),
                                                         1e-9))
    return np.concatenate(rels)


def northstar_fit(rng):
    """BASELINE.md north star: full-network fit wall-clock at reference
    parameter scale, with parameter recovery vs the synthetic truth."""
    import jax.numpy as jnp

    from phoskintime_tpu.demo import build_demo_network
    from phoskintime_tpu.network.optimize import run_global_fit
    from phoskintime_tpu.network.params import init_raw_params

    b = build_demo_network(n_proteins=150, n_kinases=24, seed=1,
                           dtype=np.float32)
    n_var = len(b["theta0"])

    t0 = time.perf_counter()
    res = run_global_fit(b["system"], b["slices"], b["loss_data"],
                         b["defaults"], b["lambdas"], b["grid"],
                         b["xl"], b["xu"], pop=384, n_gen=400, seed=0,
                         ftol=0.001, ftol_period=25, n_max_evals=200_000,
                         frechet_pick=False)
    wall = time.perf_counter() - t0

    best = res.pareto_X[np.argmin(res.pareto_F.sum(axis=1))]
    rel = _recovery_errors(b, best)
    obs_rel = _observable_recovery(b, best)
    section("6_northstar_fullscale_fit", wall,
            f"s wall-clock (pop=384, n_var={n_var}, converged UNSGA3)",
            {"n_evals": int(res.n_evals),
             "ideal": [round(float(v), 6) for v in res.pareto_F.min(axis=0)],
             "recovery_median_rel_err": round(float(np.median(rel)), 4),
             "recovery_p90_rel_err": round(float(np.percentile(rel, 90)), 4),
             # the identifiable quantity: fold-change trajectories of the
             # fitted model vs the synthetic truth (parameters are sloppy;
             # observables are what the data constrains)
             "observable_median_rel_err": round(float(np.median(obs_rel)), 4),
             "observable_p90_rel_err": round(
                 float(np.percentile(obs_rel, 90)), 4)})

    # 6b: the same fit with the ALL-device GA loop (10 generations per
    # dispatch, on-device NSGA-III survival): dispatch latency and host
    # bookkeeping amortize by the block length; ftol stop fires at block
    # granularity so n_evals may differ slightly from the per-gen arm
    t0 = time.perf_counter()
    res_dl = run_global_fit(b["system"], b["slices"], b["loss_data"],
                            b["defaults"], b["lambdas"], b["grid"],
                            b["xl"], b["xu"], pop=384, n_gen=400, seed=0,
                            ftol=0.001, ftol_period=25,
                            n_max_evals=200_000, frechet_pick=False,
                            gens_per_dispatch=10)
    wall_dl = time.perf_counter() - t0
    best_dl = res_dl.pareto_X[np.argmin(res_dl.pareto_F.sum(axis=1))]
    obs_dl = _observable_recovery(b, best_dl)
    section("6_northstar_device_loop", wall_dl,
            "s wall-clock (pop=384, all-device GA, 10 gens/dispatch)",
            {"n_evals": int(res_dl.n_evals),
             "ideal": [round(float(v), 6)
                       for v in res_dl.pareto_F.min(axis=0)],
             "observable_median_rel_err": round(float(np.median(obs_dl)), 4),
             "wall_per_gen_ms": round(
                 wall_dl / max(res_dl.n_evals / 384 - 1, 1) * 1e3, 1)})

    # 6-polish ablation (VERDICT r2 #1 done-bar): exact-gradient Adam
    # polish of the SAME Pareto set vs the reference-style bound-zoom
    # refinement (r2 path: 2 rounds, +~78k evals, obs median 0.540->0.486).
    # Each polish step = one forward+reverse sweep of the full network
    # integration; the set is chunked through one compiled program.
    from phoskintime_tpu.network.polish import (polish_solutions,
                                                simplex_weights)

    # step budget: the CPU-scale probe (N=40, pop 128) measured obs
    # median 0.476 post-GA -> 0.213 @150 steps -> 0.051 @600 steps
    t0 = time.perf_counter()
    pX, pF = polish_solutions(b["system"], b["slices"], b["loss_data"],
                              b["defaults"], b["lambdas"], b["grid"],
                              res.pareto_X, b["xl"], b["xu"],
                              weights=simplex_weights(res.pareto_F),
                              steps=600, chunk=128)
    polish_wall = time.perf_counter() - t0
    pbest = pX[np.argmin(np.asarray(pF).sum(axis=1))]
    p_obs = _observable_recovery(b, pbest)
    p_rel = _recovery_errors(b, pbest)
    section("6_northstar_gradient_polish", polish_wall,
            "s wall-clock (600 Adam steps, exact grads, whole Pareto set)",
            {"ideal": [round(float(v), 6)
                       for v in np.asarray(pF).min(axis=0)],
             "observable_median_rel_err": round(float(np.median(p_obs)), 4),
             "observable_p90_rel_err": round(
                 float(np.percentile(p_obs, 90)), 4),
             "recovery_median_rel_err": round(float(np.median(p_rel)), 4),
             "obs_median_before": round(float(np.median(obs_rel)), 4)})

    # 6-GN: matrix-free Levenberg-Marquardt finish on the polished best
    # member (damped Gauss-Newton on the exact residual vector; each CG
    # matvec = jvp+vjp sweep of the full network integration)
    from phoskintime_tpu.network.polish import lm_refine

    t0 = time.perf_counter()
    th_gn, sse = lm_refine(b["system"], b["slices"], b["loss_data"],
                           b["defaults"], b["lambdas"], b["grid"],
                           pbest, b["xl"], b["xu"], iters=15, cg_iters=25)
    gn_wall = time.perf_counter() - t0
    g_obs = _observable_recovery(b, th_gn)
    section("6_northstar_gn_finish", gn_wall,
            "s wall-clock (15 LM iters x 25 CG matvecs, best member)",
            {"sse": round(float(sse), 6),
             "observable_median_rel_err": round(float(np.median(g_obs)), 4),
             "observable_p90_rel_err": round(
                 float(np.percentile(g_obs, 90)), 4),
             "obs_median_after_adam": round(float(np.median(p_obs)), 4)})


def _observable_recovery(b, theta_best):
    """Relative fold-change deviation of the fitted model vs the truth
    model over every observable (mRNA, total protein, per-site phospho) —
    the quantity the 3-modality data actually constrains."""
    import jax
    import jax.numpy as jnp

    from phoskintime_tpu.network.expo import exponential_simulate_batched
    from phoskintime_tpu.network.params import unpack_params
    from phoskintime_tpu.network.simulate import (extract_observables,
                                                  fold_changes)

    system = b["system"]
    wdt = system.rhs.W_pad.dtype         # follow the system (f64 in parity mode)
    times = np.asarray(b["grid"], float)
    fit_p = unpack_params(jnp.asarray(theta_best, wdt), b["slices"],
                          b["topo"])
    both = {k: jnp.stack([jnp.asarray(b["true"][k], wdt),
                          jnp.asarray(v, wdt)])
            for k, v in fit_p.items()}
    ys, success = exponential_simulate_batched(system, both, times)
    assert bool(np.all(np.asarray(success))), \
        "integration failed for truth or fitted model"

    def fcs(Y):
        return fold_changes(extract_observables(system, Y),
                            jnp.asarray(times))

    fc_t = jax.vmap(fcs)(ys)            # 3 modalities, each (2, T, ...)
    msk = np.asarray(system.topo.site_mask(), bool)
    rels = []
    for i in range(3):
        t = np.asarray(fc_t[i][0], float)
        f = np.asarray(fc_t[i][1], float)
        if t.ndim == 3:
            t, f = t[:, msk], f[:, msk]
        rels.append((np.abs(f - t) / np.maximum(np.abs(t), 1e-6)).ravel())
    return np.concatenate(rels)


def precision_delta(rng):
    """f32-on-device vs f64-on-CPU: objective deltas at identical thetas and
    fitted-parameter deltas from identical-seed fits (VERDICT r1 weak #5)."""
    import json as _json
    import os
    import subprocess
    import sys as _sys
    import tempfile

    import jax
    import jax.numpy as jnp

    from phoskintime_tpu.demo import build_demo_network
    from phoskintime_tpu.network.objective import make_population_objective
    from phoskintime_tpu.network.optimize import run_global_fit

    b = build_demo_network(n_proteins=40, n_kinases=12, seed=0,
                           dtype=np.float32)
    P = 64
    thetas = np.asarray(b["theta0"][None]
                        + 0.05 * rng.normal(size=(P, len(b["theta0"]))),
                        np.float32)

    objp = make_population_objective(b["system"], b["slices"], b["loss_data"],
                                     b["defaults"], b["lambdas"], b["grid"])
    F32 = np.asarray(jax.jit(objp)(jnp.asarray(thetas)), float)
    res32 = run_global_fit(b["system"], b["slices"], b["loss_data"],
                           b["defaults"], b["lambdas"], b["grid"],
                           b["xl"], b["xu"], pop=64, n_gen=20, seed=0,
                           ftol=0.0, frechet_pick=False)
    best32 = res32.pareto_X[np.argmin(res32.pareto_F.sum(axis=1))]

    with tempfile.TemporaryDirectory() as td:
        npz = os.path.join(td, "thetas.npz")
        np.savez(npz, thetas=thetas)
        child = (
            "import os,sys,json\n"
            "import numpy as np\n"
            "import jax\n"
            "jax.config.update('jax_platforms','cpu')\n"
            "jax.config.update('jax_enable_x64',True)\n"
            "import jax.numpy as jnp\n"
            "sys.path.insert(0, %r)\n"
            "from phoskintime_tpu.demo import build_demo_network\n"
            "from phoskintime_tpu.network.objective import make_population_objective\n"
            "from phoskintime_tpu.network.optimize import run_global_fit\n"
            "b = build_demo_network(n_proteins=40, n_kinases=12, seed=0,"
            " dtype=np.float64)\n"
            "thetas = np.load(%r)['thetas'].astype(np.float64)\n"
            "objp = make_population_objective(b['system'], b['slices'],"
            " b['loss_data'], b['defaults'], b['lambdas'], b['grid'])\n"
            "F = np.asarray(jax.jit(objp)(jnp.asarray(thetas)), float)\n"
            "res = run_global_fit(b['system'], b['slices'], b['loss_data'],"
            " b['defaults'], b['lambdas'], b['grid'], b['xl'], b['xu'],"
            " pop=64, n_gen=20, seed=0, ftol=0.0, frechet_pick=False)\n"
            "best = res.pareto_X[np.argmin(res.pareto_F.sum(axis=1))]\n"
            "print('CHILD::' + json.dumps({'F': F.tolist(),"
            " 'best': best.tolist()}))\n"
        ) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))), npz)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run([_sys.executable, "-c", child], env=env,
                             capture_output=True, text=True, timeout=1800)
        if out.returncode != 0:
            raise RuntimeError(f"f64 CPU child failed:\n{out.stderr[-2000:]}")
        payload = _json.loads(
            [l for l in out.stdout.splitlines()
             if l.startswith("CHILD::")][0][len("CHILD::"):])

    F64 = np.asarray(payload["F"], float)
    best64 = np.asarray(payload["best"], float)
    obj_delta = float(np.max(np.abs(F32 - F64) / np.maximum(np.abs(F64),
                                                            1e-12)))
    # truth values are dtype-independent: reuse the f32 build
    rel32 = _recovery_errors(b, best32)
    rel64 = _recovery_errors(b, best64)
    param_delta = float(np.median(np.abs(best32 - best64)
                                  / np.maximum(np.abs(best64), 1e-9)))
    section("6_precision_f32dev_vs_f64cpu", obj_delta,
            "max rel objective delta at identical thetas (pop=64, N=40)",
            {"fitted_param_median_rel_delta": round(param_delta, 4),
             "recovery_median_f32": round(float(np.median(rel32)), 4),
             "recovery_median_f64": round(float(np.median(rel64)), 4)})


if __name__ == "__main__":
    main()
