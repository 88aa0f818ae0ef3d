"""Gradient polish of global-fit solutions (exact reverse-mode descent).

The single biggest accelerator-native advantage over the reference: the ENTIRE
objective — softplus unpack -> bucketed ETD2RK network integration ->
robust 3-modality loss + prior penalty — is differentiable end-to-end, so
candidate solutions can be sharpened with exact gradients. The reference's
only post-search sharpening tool is bound-zoom refinement
(``global_model/refine.py:32-357``), which re-SAMPLES inside shrunken
boxes; this DESCENDS.

Design:

* the scalarized loss per member is ``F(theta) . w`` with per-member
  weight vectors ``w`` on the 3-objective simplex — polishing a Pareto
  set keeps its spread by scalarizing each member along its own
  (normalized-objective) direction;
* bounded Adam in RAW (softplus) space, box projection by clipping to
  [xl, xu] after every step, with the best-so-far iterate tracked per
  member (Adam is not monotone);
* the whole multistep polish of one chunk is ONE jitted XLA program
  (``lax.scan`` over steps; each step = forward + reverse sweep of the
  full network integration), vmapped/batched over the member axis exactly
  like the GA's population evaluation;
* the propagator-table build runs the static-length masked XLA ladder
  (``differentiable=True``) — the Pallas table kernel has no VJP.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def simplex_weights(F: np.ndarray, floor: float = 0.05) -> np.ndarray:
    """Per-member scalarization weights from a population's objectives.

    Each member is weighted INVERSELY to its normalized objective values
    (a member strong on objective j keeps pushing j), floored so no
    objective is ever ignored. Rows sum to 1."""
    F = np.asarray(F, float)
    lo, hi = F.min(axis=0), F.max(axis=0)
    Fn = (F - lo) / np.maximum(hi - lo, 1e-12)
    w = 1.0 / (Fn + 0.25)
    w = np.maximum(w / w.sum(axis=1, keepdims=True), floor)
    return w / w.sum(axis=1, keepdims=True)


def polish_solutions(system, slices, loss_data, defaults, lambdas, time_grid,
                     thetas, xl, xu, *, weights=None, steps: int = 150,
                     lr: float = 0.02, loss_mode: int = 0, y0=None,
                     chunk: int = 128, seed: int = 0,
                     adam_b1: float = 0.9, adam_b2: float = 0.999,
                     mesh=None):
    """Polish a set of raw-space solutions with bounded Adam.

    Args:
      thetas: (P, n) raw decision vectors (e.g. a Pareto set).
      weights: (P, 3) scalarization weights; None -> uniform (the
        best-by-sum criterion the selection/exports use).
      steps: Adam steps; lr decays cosine to 10%.
      chunk: members per compiled program (bounds the reverse-sweep
        memory; chunks share one compilation). Must be a multiple of
        the mesh size when ``mesh`` is given.
      mesh: optional ``jax.sharding.Mesh`` with a "pop" axis — shards
        the member axis of each chunk across devices (the polish is
        embarrassingly parallel over members, like the GA population).

    Returns (thetas_polished (P, n), F_polished (P, 3)) — each member's
    best-scoring iterate (never worse than its input under its own
    scalarization, measured by the same objective).
    """
    from phoskintime_tpu.network.objective import make_population_objective

    thetas = np.asarray(thetas, float)
    P, n = thetas.shape
    if weights is None:
        weights = np.full((P, 3), 1.0 / 3.0)
    weights = np.asarray(weights, float)
    xl_j = jnp.asarray(xl, jnp.float32)
    xu_j = jnp.asarray(xu, jnp.float32)

    objective = make_population_objective(
        system, slices, loss_data, defaults, lambdas, time_grid,
        loss_mode=loss_mode, y0=y0, differentiable=True)

    def scalar_total(X, W):
        s = jnp.sum(objective(X) * W, axis=1)  # per-member scores (aux)
        return jnp.sum(s), s

    grad_fn = jax.value_and_grad(scalar_total, has_aux=True)

    def polish_chunk(X0, W):
        # each step costs ONE forward+reverse sweep: the gradient pass's
        # aux scores the INCOMING iterate (scoring the updated X with a
        # second forward would make every step forward+reverse+forward)
        def adam_step(carry, i):
            X, m, v, bestX, bestS = carry
            (_, score), g = grad_fn(X, W)
            score = score.astype(bestS.dtype)  # keep the scan carry stable
            better = score < bestS
            bestX = jnp.where(better[:, None], X, bestX)
            bestS = jnp.where(better, score, bestS)
            # cosine decay to 10% of lr
            lr_i = lr * (0.55 + 0.45 * jnp.cos(jnp.pi * i / steps))
            m = adam_b1 * m + (1 - adam_b1) * g
            v = adam_b2 * v + (1 - adam_b2) * g * g
            t = i.astype(X.dtype) + 1.0
            mh = m / (1 - adam_b1 ** t)
            vh = v / (1 - adam_b2 ** t)
            X = X - lr_i * mh / (jnp.sqrt(vh) + 1e-8)
            X = jnp.clip(X, xl_j, xu_j)
            return (X, m, v, bestX, bestS), None

        s_inf = jnp.full((X0.shape[0],), jnp.inf, X0.dtype)
        init = (X0, jnp.zeros_like(X0), jnp.zeros_like(X0), X0, s_inf)
        (Xf, _, _, bestX, bestS), _ = jax.lax.scan(
            adam_step, init, jnp.arange(steps))
        # the loop scores iterates one step behind — score the final one
        sF = jnp.sum(objective(Xf) * W, axis=1).astype(bestS.dtype)
        better = sF < bestS
        bestX = jnp.where(better[:, None], Xf, bestX)
        bestS = jnp.where(better, sF, bestS)
        return bestX, bestS

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as Pspec

        n_dev = int(np.prod(list(mesh.shape.values())))
        if chunk % n_dev:
            raise ValueError(
                f"polish: chunk ({chunk}) must be a multiple of the mesh "
                f"size ({n_dev})")
        if P < chunk:  # single padded chunk: only pad to mesh multiple
            chunk = -(-P // n_dev) * n_dev
        mat = NamedSharding(mesh, Pspec("pop", None))
        row = NamedSharding(mesh, Pspec("pop"))
        polish_jit = jax.jit(polish_chunk, in_shardings=(mat, mat),
                             out_shardings=(mat, row))
    else:
        polish_jit = jax.jit(polish_chunk)

    out_X = np.empty_like(thetas, dtype=np.float32)
    for c0 in range(0, P, chunk):
        c1 = min(P, c0 + chunk)
        Xc = thetas[c0:c1].astype(np.float32)
        Wc = weights[c0:c1].astype(np.float32)
        if c1 - c0 < chunk and (P > chunk or mesh is not None):
            # pad to the compiled chunk shape (repeat last row)
            padn = chunk - (c1 - c0)
            Xc = np.vstack([Xc, np.repeat(Xc[-1:], padn, axis=0)])
            Wc = np.vstack([Wc, np.repeat(Wc[-1:], padn, axis=0)])
        bX, _ = polish_jit(jnp.asarray(Xc), jnp.asarray(Wc))
        out_X[c0:c1] = np.asarray(bX)[: c1 - c0]

    # final objectives through the PRODUCTION objective (unsharded: the
    # table kernel's route is open to it)
    prod_obj = make_population_objective(
        system, slices, loss_data, defaults, lambdas, time_grid,
        loss_mode=loss_mode, y0=y0)
    F_out = np.asarray(jax.jit(prod_obj)(jnp.asarray(out_X, jnp.float32)),
                       float)
    return out_X.astype(float), F_out


def gradient_multistart(system, slices, loss_data, defaults, lambdas,
                        time_grid, xl, xu, *, pop: int = 256,
                        steps: int = 300, lr: float = 0.03,
                        loss_mode: int = 0, y0=None, seed: int = 42,
                        chunk: int = 128, mesh=None):
    """Pure gradient-based multistart global fit (no evolutionary search).

    LHS-samples ``pop`` raw starts, assigns each a Das-Dennis simplex
    direction as its scalarization, and runs the bounded-Adam polish.
    Returns (X (pop, n), F (pop, 3)) — feed to non-dominated sorting for a
    Pareto set. This mode has no reference counterpart (the reference
    cannot differentiate through LSODA); it exists because this rebuild
    can.
    """
    from phoskintime_tpu.ops.nsga import das_dennis, lhs_sampling

    rng = np.random.default_rng(seed)
    X0 = lhs_sampling(pop, np.asarray(xl, float), np.asarray(xu, float), rng)
    dirs = das_dennis(3, 12)
    W = dirs[rng.integers(0, len(dirs), pop)]
    W = np.maximum(W, 0.05)
    W = W / W.sum(axis=1, keepdims=True)
    return polish_solutions(system, slices, loss_data, defaults, lambdas,
                            time_grid, X0, xl, xu, weights=W, steps=steps,
                            lr=lr, loss_mode=loss_mode, y0=y0, chunk=chunk,
                            seed=seed, mesh=mesh)


def lm_refine_mixed(system, slices, loss_data, defaults, lambdas, time_grid,
                    theta, xl, xu, *, iters_lo: int = 25,
                    iters_hi: int = 10, r_offset_lo=None, r_offset_hi=None,
                    logger=None, **kw):
    """Mixed-precision LM finish: working-dtype LM to its rounding floor,
    then a float64-system finish from the converged point — ON THE SAME
    BACKEND (the GPU computes f64 natively).

    Why: the f32 forward pass floors the attainable parameter match at
    ~5e-5 relative (measured, N=150 — the residual and Jacobian entries
    carry f32 rounding, so no amount of f64 normal-equation algebra can
    descend further). The few extra iterations at f64 re-evaluate r and J
    at full precision exactly where the quadratic convergence regime has
    already been reached, recovering the f64 floor (~1e-6) for the cost
    of ``iters_hi`` f64 sweeps instead of a whole f64 fit.

    Requires x64 enabled (``jax.config.update("jax_enable_x64", True)``)
    before first use; raises otherwise rather than silently downcasting.

    ``r_offset_lo/hi``: optional self-consistent residual offsets, one
    per precision stage (the offset must live in each stage's own
    residual space — see :func:`lm_refine`'s ``r_offset``).

    Returns (theta_refined (f64), sse_f64). Reference anchor: the north
    star's "matching reference parameters to 1e-6 rtol" (BASELINE.md);
    the reference has no counterpart stage at all (LSODA is not
    differentiable)."""
    import jax

    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "lm_refine_mixed needs x64 enabled before any tracing: "
            'jax.config.update("jax_enable_x64", True)')
    th, sse = lm_refine(system, slices, loss_data, defaults, lambdas,
                        time_grid, theta, xl, xu, iters=iters_lo,
                        r_offset=r_offset_lo, logger=logger, **kw)
    if logger is not None:
        logger.info(f"[LM mixed] low-precision stage done: sse={sse:.6g}")
    sys_hi = system.astype(np.float64)
    th, sse = lm_refine(sys_hi, slices, loss_data, defaults, lambdas,
                        time_grid, th, xl, xu, iters=iters_hi,
                        r_offset=r_offset_hi, logger=logger, **kw)
    return th, sse


def lm_refine(system, slices, loss_data, defaults, lambdas, time_grid,
              theta, xl, xu, *, iters: int = 15, cg_iters: int = 25,
              mu0: float = 1e-3, y0=None, logger=None,
              jac_chunk: int = 256, gtol: float = 0.0, xtol: float = 0.0,
              r_offset=None):
    """Levenberg-Marquardt refinement of ONE solution on the exact
    residual vector, with an EXPLICIT Jacobian and f64 normal-equation
    solves.

    The squared-loss objective is a genuine least-squares problem
    (:func:`phoskintime_tpu.network.objective.make_residual_fn`). The
    Jacobian is built by batched forward-mode sweeps — ``n`` tangent
    directions through the full network integration is the same batched
    program shape as one pop-``n`` GA generation, i.e. cheap on this
    stack (~one generation per relinearization) — and each LM step then
    solves the damped normal equations EXACTLY on the host in float64
    with Marquardt diagonal scaling:

        (J^T J + mu * diag(J^T J)) d = -J^T r

    This replaces the round-3 matrix-free CG inner loop, which at 25
    f32 matvecs could not outperform the Adam endpoint (VERDICT r3
    item 2): truncated CG on an ill-conditioned JtJ (condition ~1e8 at
    the north-star scale) makes no progress along the small-singular-
    value directions that carry the remaining error, and f32 matvec
    rounding floors the attainable residual. Exact f64 solves restore
    the quadratic local convergence Gauss-Newton is for.

    Damping: Nielsen's rho-based trust-region update (accept shrinks mu
    by max(1/3, 1-(2 rho-1)^3), reject multiplies by a doubling nu).
    The iterate is box-projected onto [xl, xu] after every step.
    Returns (theta_refined, sse) — never worse than the input.

    ``cg_iters`` is accepted for call compatibility and ignored.

    ``r_offset`` (optional, shape (M,)): minimizes ||r(theta) -
    r_offset||^2 instead of ||r(theta)||^2. Passing ``r(theta*)`` makes
    a synthetic-truth experiment SELF-CONSISTENT (zero-residual at
    theta* by construction): without it, the data's integrator
    truncation error — generated on the per-modality grids, fit on the
    merged grid, two different segment plans, each exact only to
    O(h^2) — displaces the residual's global minimum from theta* by
    ~1e-4 relative, which then reads as a spurious parameter-recovery
    floor. The Jacobian is unaffected (the offset is constant).

    No reference counterpart at all (LSODA exposes no J^T J structure);
    anchor for intent: the reference's bound-zoom refinement
    ``global_model/refine.py:32-357``.
    """
    from phoskintime_tpu.network.objective import make_residual_fn

    del cg_iters
    residuals = make_residual_fn(system, slices, loss_data, defaults,
                                 lambdas, time_grid, y0=y0)
    wdt = system.rhs.W_pad.dtype
    xl_h = np.asarray(xl, float)
    xu_h = np.asarray(xu, float)

    if r_offset is not None:
        r_off = jnp.asarray(r_offset, system.rhs.W_pad.dtype)
        _res_raw = residuals
        residuals = lambda th: _res_raw(th) - r_off  # noqa: E731

    @jax.jit
    def res_j(th):
        return residuals(th)

    n = int(np.asarray(theta).size)
    chunk = max(1, min(jac_chunk, n))

    @jax.jit
    def jac_chunk_fn(th, V):
        return jax.vmap(
            lambda v: jax.jvp(residuals, (th,), (v,))[1])(V)   # (C, M)

    def jacobian(th):
        eye = np.eye(n, dtype=np.asarray(th).dtype)
        th_j = jnp.asarray(th, wdt)       # primal dtype must match tangents
        rows = []
        for c0 in range(0, n, chunk):
            V = eye[c0:c0 + chunk]
            if V.shape[0] < chunk:          # pad to the compiled shape
                V = np.vstack([V, np.zeros((chunk - V.shape[0], n),
                                           V.dtype)])
            rows.append(np.asarray(jac_chunk_fn(th_j, jnp.asarray(V, wdt)),
                                   np.float64)[: min(chunk, n - c0)])
        return np.concatenate(rows, axis=0).T                  # (M, n)

    th = np.asarray(theta, np.float64).copy()
    r = np.asarray(res_j(jnp.asarray(th, wdt)), np.float64)
    best = float(r @ r)
    mu, nu = float(mu0), 2.0
    J = None
    for it in range(iters):
        if J is None:
            J = jacobian(th)
            JtJ = J.T @ J
            g = J.T @ r
            D = np.diag(JtJ).copy()
            D = np.maximum(D, 1e-12 * max(float(D.max()), 1e-30))
        if gtol > 0.0 and float(np.max(np.abs(g))) < gtol:
            break
        A = JtJ + mu * np.diag(D)
        try:
            d = np.linalg.solve(A, -g)
        except np.linalg.LinAlgError:
            mu = min(mu * nu, 1e12)
            nu *= 2.0
            continue
        trial = np.clip(th + d, xl_h, xu_h)
        step = trial - th
        r_t = np.asarray(res_j(jnp.asarray(trial, wdt)), np.float64)
        cost_t = float(r_t @ r_t)
        # predicted reduction of the quadratic model along the TAKEN
        # (possibly clipped) step
        pred = -(g @ step) - 0.5 * step @ (JtJ @ step)
        rho = (best - cost_t) / max(pred, 1e-300)
        if np.isfinite(cost_t) and cost_t < best and pred > 0:
            th, best, r = trial, cost_t, r_t
            J = None                          # relinearize at the new point
            mu = mu * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            mu = max(mu, 1e-14)
            nu = 2.0
            if xtol > 0.0 and float(np.max(np.abs(step))) < xtol:
                if logger is not None:
                    logger.info(f"[LM] iter {it}: converged (step<{xtol})")
                break
        else:
            mu = min(mu * nu, 1e12)
            nu *= 2.0
        if logger is not None:
            logger.info(f"[LM] iter {it}: sse={best:.6g} mu={mu:.2e} "
                        f"rho={rho:.3g}")
    return th, best
