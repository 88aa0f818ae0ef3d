"""kinopt optimizers: local (multistart projected Adam) and evolutionary
(DE single-objective / NSGA-II 3-objective).

Spec: reference ``kinopt/local/opt/optrun.py`` (SLSQP / trust-constr with
joblib multistart, jitter/uniform sampling, feasibility-first sort) and
``kinopt/evol/opt/optrun.py`` (DE 10k gens / NSGA-II 2k gens with +/-eps
constraint pairs).

Accelerator-native: the local path runs all starts as one vmapped projected-Adam
program with exact simplex-box projection (feasible by construction); the
evolutionary path reuses :mod:`phoskintime_tpu.ops.nsga` with batched
device evaluation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phoskintime_tpu.kinopt.model import (
    KinoptProblem,
    constraint_violations,
    kinopt_loss,
    violation_sq,
)
from phoskintime_tpu.ops.constrained import project_sum_box, projected_adam
from phoskintime_tpu.ops.nsga import run_nsga2


class KinoptResult(NamedTuple):
    alpha: np.ndarray       # (n_gp, Amax) padded
    beta: np.ndarray        # (n_k, Bmax) padded
    loss: float
    all_losses: np.ndarray  # per-start losses (local) or history (evol)
    feasible: bool


def _project(prob: KinoptProblem):
    gmask = jnp.asarray(prob.gp_mask)
    kmask = jnp.asarray(prob.k_mask)

    def proj(x):
        a, b = x
        return (project_sum_box(a, prob.lb, prob.ub, gmask),
                project_sum_box(b, prob.lb, prob.ub, kmask))
    return proj


def _random_start(prob: KinoptProblem, rng: np.random.Generator,
                  jitter_base=None, jitter=0.1):
    if jitter_base is not None:
        a0, b0 = jitter_base
        a = a0 + jitter * rng.normal(size=a0.shape)
        b = b0 + jitter * rng.normal(size=b0.shape)
    else:
        a = rng.uniform(0, 1, prob.gp_mask.shape) * prob.gp_mask
        a /= np.maximum(a.sum(axis=1, keepdims=True), 1e-12)
        b = rng.uniform(0, 1, prob.k_mask.shape) * prob.k_mask
        b /= np.maximum(b.sum(axis=1, keepdims=True), 1e-12)
    return a * prob.gp_mask, b * prob.k_mask


def run_local(prob: KinoptProblem, loss_type: str = "base",
              include_reg: bool = False, n_starts: int = 48,
              steps: int = 800, lr: float = 0.02, seed: int = 42) -> KinoptResult:
    """Multistart projected-Adam 'local' fit — one vmapped program."""
    rng = np.random.default_rng(seed)
    starts = [_random_start(prob, rng) for _ in range(n_starts)]
    A0 = jnp.asarray(np.stack([s[0] for s in starts]))
    B0 = jnp.asarray(np.stack([s[1] for s in starts]))

    proj = _project(prob)
    loss_fn = lambda x: kinopt_loss(prob, x[0], x[1], loss_type, include_reg)

    def fit_one(a0, b0):
        x, loss = projected_adam(loss_fn, (a0, b0), proj, steps=steps, lr=lr)
        return x[0], x[1], loss

    A, B, losses = jax.jit(jax.vmap(fit_one))(A0, B0)
    losses = np.asarray(losses)
    i = int(np.nanargmin(losses))
    a_best, b_best = np.asarray(A[i]), np.asarray(B[i])
    g = np.asarray(constraint_violations(prob, jnp.asarray(a_best),
                                         jnp.asarray(b_best)))
    return KinoptResult(a_best, b_best, float(losses[i]), losses,
                        bool(np.all(g <= 1e-5)))


def run_evolutionary(prob: KinoptProblem, method: str = "NSGA-II",
                     loss_type: str = "base", include_reg: bool = False,
                     pop_size: int = 100, n_gen: int = 200,
                     seed: int = 42,
                     gens_per_dispatch: int = 1) -> KinoptResult:
    """DE (single-objective) or NSGA-II (loss, alpha-viol^2, beta-viol^2).

    DE always runs entirely on device (reference budget: 10k gens).
    gens_per_dispatch > 1 moves the NSGA-II loop on device too
    (crowding survival + simplex-projection repair inside the program,
    ``ops/nsga_device.py::run_nsga2_device``)."""
    n = prob.n_alpha + prob.n_beta
    xl = np.full(n, prob.lb)
    xu = np.full(n, prob.ub)

    gmask = jnp.asarray(prob.gp_mask)
    kmask = jnp.asarray(prob.k_mask)
    amask_flat = np.where(prob.gp_mask)
    bmask_flat = np.where(prob.k_mask)

    def to_padded(X):
        X = jnp.asarray(X)
        A = jnp.zeros((X.shape[0],) + prob.gp_mask.shape, X.dtype)
        B = jnp.zeros((X.shape[0],) + prob.k_mask.shape, X.dtype)
        A = A.at[:, amask_flat[0], amask_flat[1]].set(X[:, :prob.n_alpha])
        B = B.at[:, bmask_flat[0], bmask_flat[1]].set(X[:, prob.n_alpha:])
        return A, B

    @jax.jit
    def eval_multi(X):
        A, B = to_padded(X)
        def one(a, b):
            l = kinopt_loss(prob, a, b, loss_type, include_reg)
            av, bv = violation_sq(prob, a, b)
            return jnp.stack([l, av, bv])
        return jax.vmap(one)(A, B)

    def repair_core(X):
        """Project each candidate onto the sum-to-one feasible set — a
        repair operator replacing pymoo's feasibility-first replacement.
        Shared by the host-side NSGA-II path and the on-device DE loop
        (review: a verbatim duplicate used to exist per path)."""
        A, B = to_padded(X)
        A = jax.vmap(lambda a: project_sum_box(a, prob.lb, prob.ub, gmask))(A)
        B = jax.vmap(lambda b: project_sum_box(b, prob.lb, prob.ub, kmask))(B)
        return jnp.concatenate([A[:, amask_flat[0], amask_flat[1]],
                                B[:, bmask_flat[0], bmask_flat[1]]], axis=1)

    repair_j = jax.jit(repair_core)
    repair = lambda X: np.asarray(repair_j(jnp.asarray(X)))

    if method.upper() == "DE":
        # entire DE run on device (reference budget is 10k generations)
        from phoskintime_tpu.ops.de_jit import run_de_device

        def eval_single_j(X):
            A, B = to_padded(X)
            return jax.vmap(lambda a, b: kinopt_loss(prob, a, b, loss_type,
                                                     include_reg))(A, B)

        run = jax.jit(lambda: run_de_device(
            eval_single_j, xl, xu, pop_size=pop_size, n_gen=n_gen, seed=seed,
            repair_fn=repair_core))
        dres = run()
        x_best = np.asarray(dres.x_best)
        hist = np.asarray(dres.history)
        from phoskintime_tpu.ops.nsga import MOOResult

        res = MOOResult(np.asarray(dres.X), np.asarray(dres.f)[:, None],
                        x_best[None], np.asarray(dres.f_best)[None, None],
                        [(g, float(h), float(h)) for g, h in
                         enumerate(hist[:: max(1, len(hist) // 100)])],
                        n_gen, pop_size * (n_gen + 1))
    else:
        if gens_per_dispatch > 1:
            from phoskintime_tpu.ops.nsga_device import run_nsga2_device

            res = run_nsga2_device(eval_multi, xl, xu, pop_size=pop_size,
                                   n_gen=n_gen, seed=seed,
                                   repair_fn=repair_core,
                                   gens_per_block=gens_per_dispatch)
        else:
            res = run_nsga2(lambda X: np.asarray(eval_multi(jnp.asarray(X))),
                            xl, xu, pop_size=pop_size, n_gen=n_gen, seed=seed,
                            repair_fn=repair)
        # pick min primary loss among near-feasible Pareto members
        pf = res.pareto_F
        feas = (pf[:, 1] + pf[:, 2]) <= np.quantile(pf[:, 1] + pf[:, 2], 0.25) + 1e-9
        cand = np.where(feas)[0]
        x_best = res.pareto_X[cand[np.argmin(pf[cand, 0])]]

    a, b = prob.unpack(x_best)
    g = np.asarray(constraint_violations(prob, jnp.asarray(a), jnp.asarray(b)))
    loss = float(kinopt_loss(prob, jnp.asarray(a), jnp.asarray(b),
                             loss_type, include_reg))
    return KinoptResult(a, b, loss, np.asarray([h[1] for h in res.history] or [loss]),
                        bool(np.all(g <= 1e-3)))
