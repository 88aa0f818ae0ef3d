"""Three-objective loss + prior penalty; vmapped population evaluation.

Spec: reference ``global_model/lossfn.py:113-386`` (gather-based robust
3-modality loss) and ``global_model/optproblem.py:31-160`` (GlobalODE_MOO:
weight-sum normalization, relative prior-adherence penalty added to all
objectives, fail_value on solver failure).

Accelerator-native: one candidate evaluation = unpack softplus params -> RK45
simulate -> gathers + robust loss. A whole population is ``vmap`` over the
raw-theta axis — the reference's 300-process pool becomes one XLA program,
shardable over a device mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phoskintime_tpu.network.simulate import extract_observables, simulate
from phoskintime_tpu.ops.losses import robust_loss

EPS = 1e-9


def modality_losses(obs_tuple, loss_data, loss_mode: int):
    """(loss_protein, loss_rna, loss_phospho) raw weighted sums."""
    R, TOT, PHO = obs_tuple
    lf = robust_loss(loss_mode)
    ld = loss_data

    def one(sig, base_idx, p_idx, t_idx, extra_idx, obs, w):
        if extra_idx is None:
            cur = sig[t_idx, p_idx]
            base = sig[base_idx, p_idx]
        else:
            cur = sig[t_idx, p_idx, extra_idx]
            base = sig[base_idx, p_idx, extra_idx]
        pred_fc = jnp.maximum(cur, EPS) / jnp.maximum(base, EPS)
        diff = obs - pred_fc
        return jnp.sum(w * lf(diff, pred_fc, obs))

    loss_p = one(TOT, ld.prot_base_idx, jnp.asarray(ld.p_prot),
                 jnp.asarray(ld.t_prot), None,
                 jnp.asarray(ld.obs_prot), jnp.asarray(ld.w_prot))
    loss_r = one(R, ld.rna_base_idx, jnp.asarray(ld.p_rna),
                 jnp.asarray(ld.t_rna), None,
                 jnp.asarray(ld.obs_rna), jnp.asarray(ld.w_rna))
    loss_ph = one(PHO, ld.pho_base_idx, jnp.asarray(ld.p_pho),
                  jnp.asarray(ld.t_pho), jnp.asarray(ld.s_pho),
                  jnp.asarray(ld.obs_pho), jnp.asarray(ld.w_pho))
    return loss_p, loss_r, loss_ph


def make_objective(system, slices, loss_data, defaults, lambdas, time_grid,
                   loss_mode=0, fail_value=1e12, rtol=1e-5, atol=1e-7,
                   max_steps=5000, y0=None, solver="rk45", substep=16.0):
    """Build ``objective(theta) -> (3,) objectives`` (jit/vmap-ready).

    theta is the raw (softplus-space) decision vector; lambdas is a dict
    with 'protein'/'rna'/'phospho'/'prior' weights.
    """
    from phoskintime_tpu.network.params import unpack_params

    norm_p = 1.0 / max(1e-6, float(loss_data.w_prot.sum()))
    norm_r = 1.0 / max(1e-6, float(loss_data.w_rna.sum()))
    norm_ph = 1.0 / max(1e-6, float(loss_data.w_pho.sum()))
    t_eval = jnp.asarray(time_grid)
    defaults_j = {k: jnp.asarray(v) for k, v in defaults.items()}

    def objective(theta):
        p = unpack_params(theta, slices, system.topo)

        # prior adherence: mean squared relative deviation from defaults
        # over protein-level params (reference optproblem.py:102-114)
        acc, cnt = 0.0, 0
        for k in ["A_i", "B_i", "C_i", "D_i", "E_i"]:
            diff = (p[k] - defaults_j[k]) / (defaults_j[k] + 1e-6)
            acc = acc + jnp.sum(diff ** 2)
            cnt += diff.size
        prior_penalty = lambdas["prior"] * acc / max(1, cnt)

        if solver == "expo":
            from phoskintime_tpu.network.expo import exponential_simulate

            res = exponential_simulate(system, p, t_eval, substep=substep,
                                       y0=y0)
        else:
            res = simulate(system, p, t_eval, rtol=rtol, atol=atol,
                           max_steps=max_steps, y0=y0, solver=solver)
        obs = extract_observables(system, res.ys, res.success)
        lp, lr, lph = modality_losses((obs.R, obs.TOT, obs.PHO),
                                      loss_data, loss_mode)

        F = jnp.stack([
            lp * norm_p * lambdas["protein"] + prior_penalty,
            lr * norm_r * lambdas["rna"] + prior_penalty,
            lph * norm_ph * lambdas["phospho"] + prior_penalty,
        ])
        ok = res.success & jnp.all(jnp.isfinite(F))
        return jnp.where(ok, F, jnp.full((3,), fail_value, F.dtype))

    return objective


def _dense_loss_tensors(loss_data, T: int, N: int, Smax: int):
    """Scatter the pre-indexed observation table into DENSE (T, N[, S])
    obs/weight tensors (weight 0 at holes, obs 1 to keep every robust
    kernel finite there).

    The reference's gather-based "fast loss data" (``global_model/
    cache.py:19-155``) is the CPU-native design; batched over a
    population it becomes one gather per observation per member. Dense
    masked tensors make the whole loss elementwise. Returns None
    when any (t, p[, s]) key is duplicated (replicate observations) —
    callers then keep the gather path, whose sums handle duplicates.
    """
    import numpy as np

    ld = loss_data

    def dense(shape, t_idx, p_idx, s_idx, obs, w):
        O = np.ones(shape, np.float64)
        W = np.zeros(shape, np.float64)
        idx = ((np.asarray(t_idx), np.asarray(p_idx))
               if s_idx is None else
               (np.asarray(t_idx), np.asarray(p_idx), np.asarray(s_idx)))
        flat = np.ravel_multi_index(idx, shape)
        if len(np.unique(flat)) != len(flat):
            return None
        O[idx] = np.asarray(obs, np.float64)
        W[idx] = np.asarray(w, np.float64)
        return O, W

    d_p = dense((T, N), ld.t_prot, ld.p_prot, None, ld.obs_prot, ld.w_prot)
    d_r = dense((T, N), ld.t_rna, ld.p_rna, None, ld.obs_rna, ld.w_rna)
    d_ph = dense((T, N, Smax), ld.t_pho, ld.p_pho, ld.s_pho,
                 ld.obs_pho, ld.w_pho)
    if d_p is None or d_r is None or d_ph is None:
        return None
    return d_p, d_r, d_ph


def _auto_pop_chunk(n_proteins: int, lanes_target: int = 81920) -> int:
    """Population chunk size holding ~``lanes_target`` ODE lanes (P*N).

    The batched integrator's working set — propagator tables
    (U, w, w, P*N) plus the scanned state — scales with the LANE count,
    so the memory-resident sweet spot is a lane budget, not a member
    count. The ~80k-lane budget is untuned for the H100: it is kept from
    an earlier accelerator until a measured sweep replaces it."""
    import math

    return min(8192, max(256, 2 ** round(
        math.log2(max(1.0, lanes_target / max(1, n_proteins))))))


def make_population_objective(system, slices, loss_data, defaults, lambdas,
                              time_grid, loss_mode=0, fail_value=1e12,
                              y0=None, substep=16.0, use_pallas=None,
                              differentiable=False, pop_chunk="auto",
                              width_bucketing=None):
    """Natively-batched objective: thetas (P, n) -> F (P, 3), using the
    exponential (ETD2RK) integrator's flat-batch fast path.

    Fixed segment count, no while_loop lane divergence, propagators as one
    lane-parallel expm. ``use_pallas=False`` keeps the propagator build
    pure-XLA so the returned objective is differentiable (jax.grad) —
    the gradient polish stage requires it.

    ``pop_chunk``: populations larger than this run as a ``lax.map`` over
    equal chunks (tail padded with the last row, results sliced away).
    The propagator tables are (U, w, w, P*N), so the scan's working set
    scales with the LANE count P*N, not P. ``"auto"`` (default) sizes the
    chunk to hold ~80k lanes (:func:`_auto_pop_chunk`, untuned for the
    H100). None disables chunking.

    ``width_bucketing`` forwards to
    :func:`~phoskintime_tpu.network.expo.exponential_simulate_batched`
    (None = auto: per-width-class propagator tables for the combinatorial
    mechanism)."""
    from phoskintime_tpu.network.expo import exponential_simulate_batched
    from phoskintime_tpu.network.params import unpack_params

    norm_p = 1.0 / max(1e-6, float(loss_data.w_prot.sum()))
    norm_r = 1.0 / max(1e-6, float(loss_data.w_rna.sum()))
    norm_ph = 1.0 / max(1e-6, float(loss_data.w_pho.sum()))
    t_eval = jnp.asarray(time_grid)
    defaults_j = {k: jnp.asarray(v) for k, v in defaults.items()}

    topo = system.topo
    if isinstance(pop_chunk, str):               # "auto"
        pop_chunk = _auto_pop_chunk(topo.N)
    dense = _dense_loss_tensors(loss_data, int(t_eval.shape[0]), topo.N,
                                topo.max_sites)
    if dense is not None:
        dense = tuple((jnp.asarray(O), jnp.asarray(W)) for O, W in dense)

    def objective_chunk(thetas):
        params_b = jax.vmap(
            lambda th: unpack_params(th, slices, system.topo))(thetas)

        acc, cnt = 0.0, 0
        for k in ["A_i", "B_i", "C_i", "D_i", "E_i"]:
            diff = (params_b[k] - defaults_j[k][None]) / (defaults_j[k][None] + 1e-6)
            acc = acc + jnp.sum(diff ** 2, axis=tuple(range(1, diff.ndim)))
            cnt += defaults_j[k].size
        prior_penalty = lambdas["prior"] * acc / max(1, cnt)

        ys, success = exponential_simulate_batched(
            system, params_b, t_eval, substep=substep, y0=y0,
            use_pallas=use_pallas, differentiable=differentiable,
            width_bucketing=width_bucketing)

        ld = loss_data

        def losses_one(Y_flat):
            obs = extract_observables(system, Y_flat)
            if dense is not None:
                lf = robust_loss(loss_mode)

                def dl(sig, base_idx, OW):
                    O, W = OW
                    base = sig[base_idx][None]
                    fc = jnp.maximum(sig, EPS) / jnp.maximum(base, EPS)
                    diff = O - fc
                    return jnp.sum(W * lf(diff, fc, O))

                lp = dl(obs.TOT, ld.prot_base_idx, dense[0])
                lr = dl(obs.R, ld.rna_base_idx, dense[1])
                lph = dl(obs.PHO, ld.pho_base_idx, dense[2])
            else:
                lp, lr, lph = modality_losses((obs.R, obs.TOT, obs.PHO),
                                              loss_data, loss_mode)
            return jnp.stack([lp * norm_p * lambdas["protein"],
                              lr * norm_r * lambdas["rna"],
                              lph * norm_ph * lambdas["phospho"]])

        F = jax.vmap(losses_one)(ys) + prior_penalty[:, None]
        ok = success & jnp.all(jnp.isfinite(F), axis=1)
        return jnp.where(ok[:, None], F, jnp.full_like(F, fail_value))

    def objective_pop(thetas):
        P = thetas.shape[0]
        if pop_chunk is not None and P > pop_chunk:
            # pad (edge rows — valid thetas, results sliced away) so a
            # non-multiple population still chunks instead of spilling
            pad = (-P) % pop_chunk
            if pad:
                thetas = jnp.concatenate(
                    [thetas, jnp.repeat(thetas[-1:], pad, axis=0)], axis=0)
            out = jax.lax.map(objective_chunk,
                              thetas.reshape(-1, pop_chunk,
                                             thetas.shape[1]))
            return out.reshape(P + pad, -1)[:P]
        return objective_chunk(thetas)

    objective_pop._is_population = True
    return objective_pop


import weakref

_POP_EVAL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def evaluate_population(objective, thetas, mesh=None):
    """Evaluate a (P, n) population; optionally sharded over a mesh axis.

    With a mesh, the population axis is sharded across devices via
    NamedSharding — XLA partitions the vmapped program (this replaces the
    reference's multiprocessing starmap over 80 cores).

    The jitted wrapper is cached by (objective identity, mesh) so repeated
    calls (every GA generation) hit the compilation cache instead of
    re-tracing a fresh ``jax.vmap`` object each time.
    """
    per_obj = _POP_EVAL_CACHE.setdefault(objective, {})
    # the cache entry keeps a STRONG reference to the mesh alongside the
    # jitted wrapper: id() alone could be reused by a new mesh after the
    # old one is garbage-collected, silently serving a stale sharding
    hit = per_obj.get(id(mesh))
    f = hit[1] if hit is not None and hit[0] is mesh else None
    if f is None:
        vf = (objective if getattr(objective, "_is_population", False)
              else jax.vmap(objective))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from phoskintime_tpu.parallel.mesh import sharded_jit

            sh = NamedSharding(mesh, P("pop", None))
            f = sharded_jit(vf, mesh, in_shardings=sh, out_shardings=sh)
        else:
            f = jax.jit(vf)
        per_obj[id(mesh)] = (mesh, f)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        thetas = jax.device_put(thetas, NamedSharding(mesh, P("pop", None)))
    return f(thetas)


def make_residual_fn(system, slices, loss_data, defaults, lambdas,
                     time_grid, *, y0=None, substep=16.0):
    """Per-observation weighted residual vector for least-squares refinement.

    Returns ``residuals(theta) -> (M,)`` with
    ``sum(residuals(theta)**2) == objective(theta).sum()`` for the
    squared-loss production objective (loss_mode 0): each data row is
    ``sqrt(lambda_mod * norm_mod * w_i) * (obs_i - pred_fc_i)`` and each
    prior row ``sqrt(3 * lambda_prior / cnt) * rel_dev_k`` (the prior
    penalty is added to all three objectives, hence the factor 3 under
    the sum scalarization). Differentiable end-to-end (pure-XLA
    propagator build) — the Jacobian structure this exposes is what
    Gauss-Newton/LM refinement needs and the reference's LSODA stack
    cannot provide."""
    from phoskintime_tpu.network.expo import exponential_simulate_batched
    from phoskintime_tpu.network.params import unpack_params

    ld = loss_data
    norm_p = lambdas["protein"] / max(1e-6, float(ld.w_prot.sum()))
    norm_r = lambdas["rna"] / max(1e-6, float(ld.w_rna.sum()))
    norm_ph = lambdas["phospho"] / max(1e-6, float(ld.w_pho.sum()))
    t_eval = jnp.asarray(time_grid)
    defaults_j = {k: jnp.asarray(v) for k, v in defaults.items()}
    cnt = sum(defaults_j[k].size for k in ["A_i", "B_i", "C_i", "D_i",
                                           "E_i"])

    def res_one(sig, base_idx, p_idx, t_idx, extra_idx, obs, w, scale):
        if extra_idx is None:
            cur = sig[t_idx, p_idx]
            base = sig[base_idx, p_idx]
        else:
            cur = sig[t_idx, p_idx, extra_idx]
            base = sig[base_idx, p_idx, extra_idx]
        pred_fc = jnp.maximum(cur, EPS) / jnp.maximum(base, EPS)
        return jnp.sqrt(scale * w) * (obs - pred_fc)

    def residuals(theta):
        params = unpack_params(theta, slices, system.topo)
        params_b = {k: v[None] for k, v in params.items()}
        ys, _ = exponential_simulate_batched(
            system, params_b, t_eval, substep=substep, y0=y0,
            use_pallas=False, differentiable=True)
        obs = extract_observables(system, ys[0])
        rp = res_one(obs.TOT, ld.prot_base_idx, jnp.asarray(ld.p_prot),
                     jnp.asarray(ld.t_prot), None,
                     jnp.asarray(ld.obs_prot), jnp.asarray(ld.w_prot),
                     norm_p)
        rr = res_one(obs.R, ld.rna_base_idx, jnp.asarray(ld.p_rna),
                     jnp.asarray(ld.t_rna), None,
                     jnp.asarray(ld.obs_rna), jnp.asarray(ld.w_rna),
                     norm_r)
        rph = res_one(obs.PHO, ld.pho_base_idx, jnp.asarray(ld.p_pho),
                      jnp.asarray(ld.t_pho), jnp.asarray(ld.s_pho),
                      jnp.asarray(ld.obs_pho), jnp.asarray(ld.w_pho),
                      norm_ph)
        prior = []
        for k in ["A_i", "B_i", "C_i", "D_i", "E_i"]:
            dev = (params[k] - defaults_j[k]) / (defaults_j[k] + 1e-6)
            prior.append(jnp.sqrt(3.0 * lambdas["prior"] / max(1, cnt))
                         * dev.ravel())
        return jnp.concatenate([rp, rr, rph, *prior])

    return residuals
