"""Per-gene parameter estimation ("normest").

Spec: reference ``paramest/normest.py:22-563`` — for each gene:

1. a lambda-regularization line search over ``logspace(-2, 0, 10)``, each
   lambda tried against every weight scheme, scored by the composite
   :func:`score_fit` (reference runs this as a 10-process pool x 17
   sequential curve_fits);
2. a 48-start multistart TRF fit with jitter + stratified (LHS-like)
   sampling at the winning (lambda, weight);
3. L2 regularization as appended pseudo-residuals ``lam/n_p * theta^2``;
4. the random model is fitted in log-parameter space (exp() to physical);
5. optional bootstrap (multiplicative 5% Gaussian noise on the target);
6. Wald confidence intervals.

Accelerator-native architecture: steps 1+2 are each ONE vmapped Levenberg-Marquardt
batch — the (lambda x weight) grid and the multistart cloud are batch axes,
not processes. The per-gene reproducible seeding (seed + gene hash,
reference normest.py:226-228) is preserved.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phoskintime_tpu.fit.ci import confidence_intervals
from phoskintime_tpu.fit.score import score_fit
from phoskintime_tpu.models.kinetics import n_params, solve_ode
from phoskintime_tpu.models.weights import early_emphasis, get_weight_options
from phoskintime_tpu.ops.lm import levenberg_marquardt


def build_bounds(bounds: dict, num_psites: int, model: str):
    """Free-parameter bounds (reference normest.py:350-383).

    dist/succ: [A, B, C, D, S*n, D*n] in linear space.
    randmod:   [A, B, C, D, S*n, Ddeg*(2^n - 1)] in LOG space.
    """
    lo = [bounds["A"][0], bounds["B"][0], bounds["C"][0], bounds["D"][0]]
    hi = [bounds["A"][1], bounds["B"][1], bounds["C"][1], bounds["D"][1]]
    lo += [bounds["S(i)"][0]] * num_psites
    hi += [bounds["S(i)"][1]] * num_psites
    if model == "randmod":
        m = (1 << num_psites) - 1
        lo += [bounds["D(i)"][0]] * m
        hi += [bounds["D(i)"][1]] * m
        eps = 1e-8
        lo = [np.log(max(b, eps)) for b in lo]
        hi = [np.log(max(b, eps)) for b in hi]
    else:
        lo += [bounds["D(i)"][0]] * num_psites
        hi += [bounds["D(i)"][1]] * num_psites
    return np.asarray(lo, float), np.asarray(hi, float)


def _multistart_p0(base: np.ndarray, lb: np.ndarray, ub: np.ndarray,
                   n_starts: int, jitter_frac: float, rng: np.random.Generator):
    """Jitter + stratified-uniform start cloud (reference normest.py:229-264)."""
    p0s = [np.clip(base, lb, ub)]
    span = np.where(ub - lb > 0, ub - lb, 1.0)
    for _ in range(max(0, n_starts // 3)):
        cand = base + jitter_frac * span * rng.normal(size=base.shape)
        p0s.append(np.clip(cand, lb, ub))
    remaining = max(0, n_starts - len(p0s))
    if remaining > 0:
        d = base.shape[0]
        U = np.empty((remaining, d))
        for j in range(d):
            u = (np.arange(remaining) + rng.random(remaining)) / float(remaining)
            rng.shuffle(u)
            U[:, j] = u
        p0s.extend(lb + U * (ub - lb))
    return np.stack(p0s)


from functools import lru_cache


@lru_cache(maxsize=128)
def _lanes_program(model: str, num_psites: int, use_regularization: bool,
                   lm_iters: int, m_fit: int, m_tgt: int, n_t: int):
    """The jitted vmapped LM fit program, shared across calls.

    All data (targets, sigmas, time grid, y0, bounds) enter as ARGUMENTS,
    so every gene/λ/start/bootstrap lane with the same static shape
    configuration reuses ONE compiled XLA program. (Review finding:
    the previous per-call closures re-traced and re-compiled the
    identical program for every gene — compile-dominated wall-clock on
    per-gene cohort runs.)
    """
    npar = n_params(model, num_psites)
    is_log = model == "randmod"

    def fit_one(p0, lam, sigma, tgt_fit, tgt, t, y0, lb, ub):
        def model_fit_vec(p):
            pv = jnp.exp(p) if is_log else p
            _, fit = solve_ode(pv, y0, num_psites, t, model=model)
            return fit

        def residual(p):
            y_model = model_fit_vec(p)
            if use_regularization:
                y_model = jnp.concatenate(
                    [y_model, lam / npar * jnp.square(p)])
            return (y_model - tgt_fit) / sigma

        res = levenberg_marquardt(residual, p0, lb, ub, max_iters=lm_iters)
        pv = jnp.exp(res.p) if is_log else res.p
        return res.p, res.pcov, score_fit(pv, tgt, model_fit_vec(res.p))

    return jax.jit(jax.vmap(
        fit_one, in_axes=(0, 0, 0, 0, 0, None, None, None, None)))


def _phys_cov(pcov, popt, is_log: bool):
    """Physical-space covariance. For the log-space-fitted random model
    the LM covariance lives in log space; the delta method maps it to
    physical space: Cov_phys = J Cov_log J^T with J = diag(exp(popt)).
    (Deviation from the reference, which passes the log-space covariance
    with exp() parameters to the CI routine — normest.py:478-484.)"""
    if pcov is None or not is_log:
        return pcov
    j = np.exp(np.asarray(popt, float))
    return np.asarray(pcov, float) * np.outer(j, j)


class NormestResult(NamedTuple):
    params: np.ndarray           # physical-space best-fit parameters
    popt_raw: np.ndarray         # optimizer-space parameters (log for randmod)
    pcov: np.ndarray
    sol: np.ndarray              # (T, d) final trajectory
    fit: np.ndarray              # fit vector at best params
    error: float                 # mean squared error vs target
    score: float
    lambda_reg: float
    weight_name: str
    regularization_term: float
    ci: dict | None
    boot_params: np.ndarray | None


def normest(gene: str,
            pr_data: np.ndarray,
            p_data: np.ndarray,
            r_data: np.ndarray,
            init_cond: np.ndarray,
            num_psites: int,
            time_points: np.ndarray,
            bounds: dict,
            bootstraps: int = 0,
            model: str = "distmod",
            use_regularization: bool = True,
            ms_gauss_weights: np.ndarray | None = None,
            use_custom_weights: bool = False,
            n_starts: int = 48,
            jitter_frac: float = 0.10,
            lambdas: np.ndarray | None = None,
            seed: int = 42,
            lm_iters: int = 80,
            alpha_ci: float = 0.95) -> NormestResult:
    """Estimate one gene's kinetic parameters (fully batched on device)."""
    if lambdas is None:
        lambdas = np.logspace(-2, 0, 10)
    # the fit vector aligns the RNA block to R(time_points[OFFSET:]) —
    # a silently misaligned RNA grid would bias A/B with no error, so
    # fail loudly here instead of deep inside the LM residual
    from phoskintime_tpu.models.kinetics import OFFSET

    n_r = np.asarray(r_data, float).size
    if n_r != len(time_points) - OFFSET:
        raise ValueError(
            f"r_data has {n_r} points but the fit vector aligns RNA to "
            f"time_points[{OFFSET}:] = {len(time_points) - OFFSET} points "
            f"(reference normest.py fit-vector layout)")

    lb, ub = build_bounds(bounds, num_psites, model)
    npar = n_params(model, num_psites)
    assert lb.shape[0] == npar

    # reproducible seeds: global seed for the base p0 (reference uses
    # np.random.seed(42)), gene-hash-diversified stream for the multistart
    rng0 = np.random.default_rng(seed)
    base_p0 = rng0.uniform(lb, ub)
    gene_hash = sum(ord(c) for c in str(gene)) % 1000003
    rng = np.random.default_rng(int(seed + gene_hash))

    target = np.concatenate([np.asarray(r_data, float).ravel(),
                             np.asarray(pr_data, float).ravel(),
                             np.asarray(p_data, float).ravel()])
    reg_len = npar if use_regularization else 0
    target_fit = (np.concatenate([target, np.zeros(npar)])
                  if use_regularization else target)

    # weight library
    early_w = early_emphasis(pr_data, p_data, time_points, num_psites)
    weight_options = get_weight_options(
        target, time_points, num_psites, use_regularization, reg_len,
        early_w, ms_gauss_weights, use_custom_weights=use_custom_weights)
    weight_names = list(weight_options.keys())
    sigmas = np.stack([weight_options[k] for k in weight_names])  # (W, m)

    t = jnp.asarray(time_points, float)
    y0 = jnp.asarray(init_cond, float)
    tgt_fit_j = jnp.asarray(target_fit)
    tgt_j = jnp.asarray(target)
    lb_j, ub_j = jnp.asarray(lb), jnp.asarray(ub)
    is_log = model == "randmod"

    def model_fit_vec(p):
        pv = jnp.exp(p) if is_log else p
        _, fit = solve_ode(pv, y0, num_psites, t, model=model)
        return fit

    def residual(p, lam, sigma):
        y_model = model_fit_vec(p)
        if use_regularization:
            reg = lam / npar * jnp.square(p)
            y_model = jnp.concatenate([y_model, reg])
        return (y_model - tgt_fit_j) / sigma

    lanes = _lanes_program(model, num_psites, use_regularization, lm_iters,
                           target_fit.size, target.size, len(time_points))

    def run_lanes(p0_l, lam_l, sig_l, tgtf_l=None):
        n = len(p0_l)
        tf = (jnp.broadcast_to(tgt_fit_j, (n,) + tgt_fit_j.shape)
              if tgtf_l is None else tgtf_l)
        tg = jnp.broadcast_to(tgt_j, (n,) + tgt_j.shape)
        return lanes(p0_l, lam_l, sig_l, tf, tg, t, y0, lb_j, ub_j)

    # ---- stage 1: (lambda x weight) grid from the base start -------------
    L, W = len(lambdas), len(weight_names)
    lam_grid = jnp.asarray(np.repeat(lambdas, W))
    sig_grid = jnp.asarray(np.tile(sigmas, (L, 1)))
    p0_grid = jnp.broadcast_to(jnp.asarray(np.clip(base_p0, lb, ub)),
                               (L * W, npar))
    _, _, scores1 = run_lanes(p0_grid, lam_grid, sig_grid)
    scores1 = np.asarray(scores1)
    scores1 = np.where(np.isfinite(scores1), scores1, np.inf)
    k_best = int(np.argmin(scores1))
    lambda_reg = float(lambdas[k_best // W])
    weight_name = weight_names[k_best % W]
    sigma_best = jnp.asarray(sigmas[k_best % W])

    # ---- stage 2: multistart at the winning (lambda, weight) -------------
    p0s = jnp.asarray(_multistart_p0(base_p0, lb, ub, n_starts, jitter_frac, rng))
    S2 = len(p0s)
    popts, pcovs, scores2 = run_lanes(
        p0s, jnp.broadcast_to(jnp.asarray(lambda_reg), (S2,)),
        jnp.broadcast_to(sigma_best, (S2,) + sigma_best.shape))
    scores2 = np.asarray(scores2)
    scores2 = np.where(np.isfinite(scores2), scores2, np.inf)
    i_best = int(np.argmin(scores2))
    popt = np.asarray(popts[i_best])
    pcov = np.asarray(pcovs[i_best])
    best_score = float(scores2[i_best])

    # ---- bootstrap (optional): one more lane batch ------------------------
    boot_params = None
    if bootstraps > 0:
        B = bootstraps
        noise = rng.normal(0, 0.05, size=(B,) + target_fit.shape)
        noisy = jnp.asarray(target_fit[None] * (1 + noise))
        bp, bc, _ = run_lanes(
            jnp.broadcast_to(jnp.asarray(popt), (B, npar)),
            jnp.broadcast_to(jnp.asarray(lambda_reg), (B,)),
            jnp.broadcast_to(sigma_best, (B,) + sigma_best.shape),
            tgtf_l=noisy)
        boot_params = np.asarray(bp)
        popt = boot_params.mean(axis=0)
        pcov = np.asarray(bc).mean(axis=0)

    # ---- finalize ----------------------------------------------------------
    param_final = np.exp(popt) if is_log else popt
    sol, fit = solve_ode(jnp.asarray(param_final), y0, num_psites, t, model=model)
    sol, fit = np.asarray(sol), np.asarray(fit)
    error = float(np.sum(np.abs(fit - target) ** 2) / target.size)
    # reported in OPTIMIZER space — the space the penalty is actually
    # applied in (reference normest.py:561 likewise uses the optimizer
    # parameters; for randmod that is log space)
    regularization_term = lambda_reg / npar * float(np.sum(popt ** 2))

    model_at_popt = np.asarray(residual(jnp.asarray(popt),
                                        jnp.asarray(lambda_reg),
                                        jnp.ones_like(tgt_fit_j)) + tgt_fit_j)
    ci = confidence_intervals(param_final, _phys_cov(pcov, popt, is_log),
                              target_fit, model_at_popt,
                              alpha_val=1 - alpha_ci,
                              use_custom_weights=use_custom_weights)

    return NormestResult(param_final, popt, pcov, sol, fit, error, best_score,
                         lambda_reg, weight_name, regularization_term, ci,
                         boot_params)


def normest_batch(genes: list[str],
                  pr_batch: np.ndarray,
                  p_batch: np.ndarray,
                  r_batch: np.ndarray,
                  init_cond: np.ndarray,
                  num_psites: int,
                  time_points: np.ndarray,
                  bounds: dict,
                  model: str = "distmod",
                  use_regularization: bool = True,
                  ms_gauss_weights: list | None = None,
                  use_custom_weights: bool = False,
                  n_starts: int = 48,
                  jitter_frac: float = 0.10,
                  lambdas: np.ndarray | None = None,
                  seed: int = 42,
                  lm_iters: int = 80,
                  bootstraps: int = 0,
                  alpha_ci: float = 0.95) -> dict[str, NormestResult]:
    """Fit a whole cohort of same-shape genes as TWO LM batches.

    All genes sharing ``num_psites`` stack into one program:
    stage 1 runs (G x lambdas x weights) lanes, stage 2 (G x starts) lanes —
    the reference's per-gene serial loop over process pools
    (``bin/main.py:168-174`` + ``normest.py:140-148``) collapses into two
    device dispatches for the entire cohort.

    Args:
      pr_batch (G, T), p_batch (G, n, T), r_batch (G, Tr): stacked data.
      init_cond: shared steady-state y0 (depends only on num_psites/model).
    Returns {gene: NormestResult}.
    """
    if lambdas is None:
        lambdas = np.logspace(-2, 0, 10)
    G = len(genes)
    lb, ub = build_bounds(bounds, num_psites, model)
    npar = n_params(model, num_psites)

    rng0 = np.random.default_rng(seed)
    base_p0 = rng0.uniform(lb, ub)

    targets = np.concatenate([
        np.asarray(r_batch, float).reshape(G, -1),
        np.asarray(pr_batch, float).reshape(G, -1),
        np.asarray(p_batch, float).reshape(G, -1)], axis=1)       # (G, m)
    reg_len = npar if use_regularization else 0
    targets_fit = (np.concatenate([targets, np.zeros((G, npar))], axis=1)
                   if use_regularization else targets)

    # per-gene weight libraries (host-side)
    sigmas_all, weight_names = [], None
    for g in range(G):
        ew = early_emphasis(pr_batch[g], p_batch[g], time_points, num_psites)
        msw = ms_gauss_weights[g] if ms_gauss_weights is not None else None
        opts = get_weight_options(targets[g], time_points, num_psites,
                                  use_regularization, reg_len, ew, msw,
                                  use_custom_weights=use_custom_weights)
        if weight_names is None:
            weight_names = list(opts)
        sigmas_all.append(np.stack([opts[k] for k in weight_names]))
    sigmas_all = np.stack(sigmas_all)                             # (G, W, m)
    W = len(weight_names)
    L = len(lambdas)

    t = jnp.asarray(time_points, float)
    y0 = jnp.asarray(init_cond, float)
    lb_j, ub_j = jnp.asarray(lb), jnp.asarray(ub)
    is_log = model == "randmod"

    # same cached program the single-gene path uses — cohorts and
    # per-gene loops share one compile per static shape configuration
    lanes = _lanes_program(model, num_psites, use_regularization, lm_iters,
                           targets_fit.shape[1], targets.shape[1],
                           len(time_points))

    def fit_lanes(p0_l, lam_l, sig_l, tgtf_l, tgt_l):
        return lanes(p0_l, lam_l, sig_l, tgtf_l, tgt_l, t, y0, lb_j, ub_j)

    # ---- stage 1: (G x L x W) lanes from the shared base start ------------
    lam_l = jnp.asarray(np.tile(np.repeat(lambdas, W), G))
    sig_l = jnp.asarray(sigmas_all[:, None].repeat(L, 1).reshape(G * L * W, -1))
    tgtf_l = jnp.asarray(np.repeat(targets_fit, L * W, axis=0))
    tgt_l = jnp.asarray(np.repeat(targets, L * W, axis=0))
    p0_l = jnp.asarray(np.tile(np.clip(base_p0, lb, ub), (G * L * W, 1)))
    _, _, scores1 = fit_lanes(p0_l, lam_l, sig_l, tgtf_l, tgt_l)
    scores1 = np.asarray(scores1).reshape(G, L, W)
    scores1 = np.where(np.isfinite(scores1), scores1, np.inf)
    flat = scores1.reshape(G, L * W).argmin(axis=1)
    lam_best = lambdas[flat // W]                                  # (G,)
    w_best = flat % W

    # ---- stage 2: (G x n_starts) multistart at each gene's winner ---------
    p0_stack = []
    gene_rngs = []
    for g, gene in enumerate(genes):
        gene_hash = sum(ord(c) for c in str(gene)) % 1000003
        rng = np.random.default_rng(int(seed + gene_hash))
        p0_stack.append(_multistart_p0(base_p0, lb, ub, n_starts, jitter_frac,
                                       rng))
        gene_rngs.append(rng)
    S = p0_stack[0].shape[0]
    p0_s = jnp.asarray(np.concatenate(p0_stack))                   # (G*S, npar)
    lam_s = jnp.asarray(np.repeat(lam_best, S))
    sig_s = jnp.asarray(np.repeat(sigmas_all[np.arange(G), w_best], S, axis=0))
    tgtf_s = jnp.asarray(np.repeat(targets_fit, S, axis=0))
    tgt_s = jnp.asarray(np.repeat(targets, S, axis=0))
    popts, pcovs, scores2 = fit_lanes(p0_s, lam_s, sig_s, tgtf_s, tgt_s)
    scores2 = np.asarray(scores2).reshape(G, S)
    scores2 = np.where(np.isfinite(scores2), scores2, np.inf)
    best = scores2.argmin(axis=1)

    popts = np.asarray(popts).reshape(G, S, npar)
    pcovs = np.asarray(pcovs).reshape(G, S, npar, npar)
    popt_best = popts[np.arange(G), best]                          # (G, npar)
    pcov_best = pcovs[np.arange(G), best]

    # ---- stage 3 (optional): bootstrap as one more (G x B) lane batch -----
    # Mirrors the single-gene path above (reference normest.py:490-531):
    # multiplicative 5% Gaussian noise on each gene's target, restart LM at
    # that gene's winner; popt/pcov become the bootstrap means.
    boot_all = None
    if bootstraps > 0:
        B = bootstraps
        # per-gene noise streams continuing each gene's multistart rng —
        # EXACTLY the single-gene path's draw order (a shared stream
        # would make each gene's bootstrap depend on cohort composition)
        noise = np.stack([
            gene_rngs[g].normal(0, 0.05, size=(B,) + targets_fit.shape[1:])
            for g in range(G)])
        noisy = (targets_fit[:, None] * (1 + noise)).reshape(G * B, -1)
        p0_b = jnp.asarray(np.repeat(popt_best, B, axis=0))
        lam_b = jnp.asarray(np.repeat(lam_best, B))
        sig_b = jnp.asarray(np.repeat(sigmas_all[np.arange(G), w_best], B,
                                      axis=0))
        tgt_b = jnp.asarray(np.repeat(targets, B, axis=0))
        bp, bc, _ = fit_lanes(p0_b, lam_b, sig_b, jnp.asarray(noisy), tgt_b)
        boot_all = np.asarray(bp).reshape(G, B, npar)
        popt_best = boot_all.mean(axis=1)
        pcov_best = np.asarray(bc).reshape(G, B, npar, npar).mean(axis=1)

    # ---- assemble per-gene results -----------------------------------------
    out: dict[str, NormestResult] = {}
    for g, gene in enumerate(genes):
        popt = popt_best[g]
        pcov = pcov_best[g]
        param_final = np.exp(popt) if is_log else popt
        sol, fit = solve_ode(jnp.asarray(param_final), y0, num_psites, t,
                             model=model)
        sol, fit = np.asarray(sol), np.asarray(fit)
        error = float(np.sum(np.abs(fit - targets[g]) ** 2) / targets[g].size)
        # optimizer-space penalty, as applied (see the single-gene path)
        reg_term = float(lam_best[g]) / npar * float(np.sum(popt ** 2))

        mf = fit
        if use_regularization:
            mf = np.concatenate([fit, lam_best[g] / npar * popt ** 2])
        ci = confidence_intervals(param_final, _phys_cov(pcov, popt, is_log),
                                  targets_fit[g], mf,
                                  alpha_val=1 - alpha_ci,
                                  use_custom_weights=use_custom_weights)
        out[gene] = NormestResult(param_final, popt, pcov, sol, fit, error,
                                  float(scores2[g, best[g]]),
                                  float(lam_best[g]), weight_names[w_best[g]],
                                  reg_term, ci,
                                  boot_all[g] if boot_all is not None else None)
    return out
