"""Gradient-polish stage tests: differentiable objective path, Adam polish
improvement guarantees, gradient multistart, and the SMS-EMOA lazy-greedy
hypervolume truncation.

The polish stage has no reference counterpart (the reference's only
post-search sharpening is bound-zoom re-sampling,
``global_model/refine.py:32-357``); these tests pin the accelerator-native
capability it unlocks: exact reverse-mode descent through the full
softplus-unpack -> ETD2RK -> loss pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # integration tier: excluded from the <5-min smoke run

from tests.test_optimize import GRID, RNA_GRID, tiny_problem

from phoskintime_tpu.network import default_params, init_raw_params
from phoskintime_tpu.network.objective import make_population_objective
from phoskintime_tpu.network.polish import (
    gradient_multistart,
    polish_solutions,
    simplex_weights,
)

BOUNDS = {"c_k": (1e-3, 4.0), "A_i": (1e-3, 4.0), "B_i": (1e-3, 4.0),
          "C_i": (1e-3, 4.0), "D_i": (1e-3, 4.0), "Dp_i": (0.05, 5.0),
          "E_i": (1e-4, 4.0), "tf_scale": (0.5, 6.0)}
LAMBDAS = {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.0}


def _setup(seed=0):
    sys, topo, true, dfp, dfr, dfph, ld, grid = tiny_problem(seed)
    defaults = default_params(topo)
    theta0, slices, xl, xu = init_raw_params(defaults, topo, BOUNDS)
    return sys, topo, slices, ld, defaults, grid, theta0, xl, xu


class TestDifferentiablePath:
    def test_matches_production_values(self):
        """differentiable=True must compute the SAME objective values as
        the production path (static-length masked ladder == traced-trip
        ladder when the unroll bound covers the need)."""
        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        rng = np.random.default_rng(1)
        X = jnp.asarray(rng.uniform(xl, xu, (4, len(xl))), jnp.float32)
        f_prod = make_population_objective(sys, slices, ld, defaults,
                                           LAMBDAS, grid)
        f_diff = make_population_objective(sys, slices, ld, defaults,
                                           LAMBDAS, grid,
                                           differentiable=True)
        Fp = np.asarray(f_prod(X))
        Fd = np.asarray(f_diff(X))
        np.testing.assert_allclose(Fd, Fp, rtol=2e-4, atol=1e-6)

    def test_grad_finite_and_matches_fd(self):
        """Reverse-mode gradient through the full network integration is
        finite and agrees with central finite differences."""
        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        obj = make_population_objective(sys, slices, ld, defaults, LAMBDAS,
                                        grid, differentiable=True)

        def scalar(x):
            return jnp.sum(obj(x[None, :]))

        x = jnp.asarray(0.5 * (xl + xu), jnp.float64)
        g = jax.grad(scalar)(x)
        assert np.all(np.isfinite(np.asarray(g)))
        # spot-check 5 coordinates against central differences
        rng = np.random.default_rng(0)
        eps = 1e-5
        for k in rng.choice(len(xl), 5, replace=False):
            e = np.zeros(len(xl))
            e[k] = eps
            fd = (scalar(x + e) - scalar(x - e)) / (2 * eps)
            np.testing.assert_allclose(np.asarray(g)[k], float(fd),
                                       rtol=5e-3, atol=1e-5)


class TestPolish:
    def test_polish_never_worse_and_improves(self):
        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        rng = np.random.default_rng(2)
        P = 6
        X0 = rng.uniform(xl, xu, (P, len(xl)))
        obj = make_population_objective(sys, slices, ld, defaults, LAMBDAS,
                                        grid)
        F0 = np.asarray(obj(jnp.asarray(X0, jnp.float32)))
        W = np.full((P, 3), 1.0 / 3.0)
        Xp, Fp = polish_solutions(sys, slices, ld, defaults, LAMBDAS, grid,
                                  X0, xl, xu, weights=W, steps=40, lr=0.05)
        s0 = (F0 * W).sum(axis=1)
        s1 = (Fp * W).sum(axis=1)
        # best-so-far guarantee: no member ends worse under its own weight
        assert np.all(s1 <= s0 * (1 + 1e-4) + 1e-6)
        # and descent actually bites from random starts
        assert s1.mean() < 0.9 * s0.mean()
        # stays inside the box
        assert np.all(Xp >= np.asarray(xl) - 1e-6)
        assert np.all(Xp <= np.asarray(xu) + 1e-6)

    def test_simplex_weights_rows(self):
        F = np.array([[1.0, 5.0, 2.0], [4.0, 1.0, 3.0], [2.0, 2.0, 2.0]])
        W = simplex_weights(F)
        np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-12)
        assert np.all(W >= 0.049)
        # member 0 is best on objective 0 -> its weight 0 is its largest
        assert np.argmax(W[0]) == 0

    def test_gradient_multistart(self):
        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        X, F = gradient_multistart(sys, slices, ld, defaults, LAMBDAS, grid,
                                   xl, xu, pop=8, steps=40, lr=0.05, seed=3)
        assert X.shape == (8, len(xl)) and F.shape == (8, 3)
        # beats the pre-descent random starts it came from
        from phoskintime_tpu.ops.nsga import lhs_sampling
        rng = np.random.default_rng(3)
        X0 = lhs_sampling(8, np.asarray(xl, float), np.asarray(xu, float),
                          rng)
        obj = make_population_objective(sys, slices, ld, defaults, LAMBDAS,
                                        grid)
        F0 = np.asarray(obj(jnp.asarray(X0, jnp.float32)))
        assert F.sum(axis=1).min() < F0.sum(axis=1).min()


class TestGlobalFitPolish:
    def test_run_global_fit_with_polish(self):
        from phoskintime_tpu.network.optimize import run_global_fit

        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        res0 = run_global_fit(sys, slices, ld, defaults, LAMBDAS, grid,
                              xl, xu, pop=16, n_gen=5, seed=0, ftol=0.0)
        res1 = run_global_fit(sys, slices, ld, defaults, LAMBDAS, grid,
                              xl, xu, pop=16, n_gen=5, seed=0, ftol=0.0,
                              polish_steps=30, polish_lr=0.05)
        # polished sum-best is never worse than the unpolished search
        assert (res1.pareto_F.sum(axis=1).min()
                <= res0.pareto_F.sum(axis=1).min() + 1e-6)
        assert res1.n_evals > res0.n_evals

    def test_gradient_optimizer_mode(self):
        from phoskintime_tpu.network.optimize import run_global_fit

        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        res = run_global_fit(sys, slices, ld, defaults, LAMBDAS, grid,
                             xl, xu, pop=8, n_gen=1, seed=0,
                             optimizer="gradient", polish_steps=30)
        assert res.pareto_F.shape[1] == 3
        assert len(res.pareto_X) >= 1


class TestLazyHVTruncate:
    def test_matches_naive_removal(self):
        """Lazy-greedy == naive full-recompute on non-dominated fronts
        (the only sets run_smsemoa truncates: dominated members never
        reach the splitting front, so the all-tied-at-zero degeneracy
        where tie order is fp-noise-arbitrary cannot occur)."""
        from phoskintime_tpu.ops.nsga import (_least_hv_truncate,
                                              hv_contributions_3d)

        rng = np.random.default_rng(7)
        for n, keep in [(12, 5), (40, 25), (60, 10)]:
            # points on a concave surface -> mutually non-dominated,
            # positive distinct contributions
            xy = rng.random((n, 2))
            F = np.column_stack([xy, 2.0 - xy.sum(axis=1)])
            ref = F.max(axis=0) + 1.0
            members = np.arange(n)
            got = _least_hv_truncate(F, members, ref, keep)
            # naive: full recompute after every removal
            alive = list(range(n))
            while len(alive) > keep:
                contrib = hv_contributions_3d(F[alive], ref)
                alive.pop(int(np.argmin(contrib)))
            assert sorted(got) == sorted(alive)


class TestDeviceVariation:
    """Fused on-device tournament/SBX/PM/evaluate (round-3 host-GA fix)."""

    def test_device_step_semantics(self):
        import jax.numpy as jnp

        from phoskintime_tpu.ops.nsga import make_device_ga_step

        rng = np.random.default_rng(0)
        n_var, pop = 12, 32
        xl = np.zeros(n_var)
        xu = np.ones(n_var) * 2.0

        def pop_obj(X):
            return jnp.stack([jnp.sum(X ** 2, axis=1),
                              jnp.sum((X - 1) ** 2, axis=1),
                              jnp.sum(jnp.abs(X), axis=1)], axis=1)

        step = make_device_ga_step(pop_obj, xl, xu, pop)
        X = rng.uniform(xl, xu, (pop, n_var))
        rank = rng.integers(0, 3, pop)
        nd = rng.random(pop)
        off, F = step(X, rank, nd, seed=1)
        assert off.shape == (pop, n_var) and F.shape == (pop, 3)
        assert np.all(off >= xl - 1e-6) and np.all(off <= xu + 1e-6)
        assert np.all(np.isfinite(F))
        # F is the objective of the returned offspring
        F_chk = np.asarray(pop_obj(jnp.asarray(off, jnp.float32)))
        np.testing.assert_allclose(F, F_chk, rtol=1e-5)
        # different seeds -> different offspring; same seed -> identical
        off2, _ = step(X, rank, nd, seed=2)
        assert not np.allclose(off, off2)
        off1b, _ = step(X, rank, nd, seed=1)
        np.testing.assert_array_equal(off, off1b)
        # no offspring row duplicates a population row exactly
        pop_set = {X[i].astype(np.float32).tobytes() for i in range(pop)}
        assert not any(off[i].astype(np.float32).tobytes() in pop_set
                       for i in range(pop))
        # traced bounds: a zoomed box works without error and is respected
        off3, _ = step(X * 0.4 + 0.3, rank, nd, 3, xl + 0.25, xu - 0.25)
        assert np.all(off3 >= xl + 0.25 - 1e-6)
        assert np.all(off3 <= xu - 0.25 + 1e-6)

    def test_global_fit_device_variation(self):
        from phoskintime_tpu.network.optimize import run_global_fit

        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        res_d = run_global_fit(sys, slices, ld, defaults, LAMBDAS, grid,
                               xl, xu, pop=16, n_gen=6, seed=0, ftol=0.0,
                               device_variation=True)
        res_h = run_global_fit(sys, slices, ld, defaults, LAMBDAS, grid,
                               xl, xu, pop=16, n_gen=6, seed=0, ftol=0.0,
                               device_variation=False)
        # both search paths work and improve comparably (not bitwise: the
        # device path uses a jax RNG stream)
        assert np.all(np.isfinite(res_d.pareto_F))
        d_best = res_d.pareto_F.sum(axis=1).min()
        h_best = res_h.pareto_F.sum(axis=1).min()
        assert d_best < 10 * h_best + 1.0
        assert res_d.n_evals == res_h.n_evals


class TestShardedPolish:
    def test_polish_under_mesh_matches_unsharded(self):
        """Sharding the member axis must not change the polish math: the
        same inputs produce the same polished set (the per-member descent
        is independent; only array placement differs)."""
        import jax
        from jax.sharding import Mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device CPU mesh")
        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        rng = np.random.default_rng(3)
        X0 = rng.uniform(xl, xu, (5, len(xl)))  # uneven: pads to 8
        W = simplex_weights(rng.random((5, 3)) + 0.5)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("pop",))
        pX_m, pF_m = polish_solutions(sys, slices, ld, defaults, LAMBDAS,
                                      grid, X0, xl, xu, weights=W, steps=6,
                                      chunk=8, mesh=mesh)
        pX_u, pF_u = polish_solutions(sys, slices, ld, defaults, LAMBDAS,
                                      grid, X0, xl, xu, weights=W, steps=6,
                                      chunk=8)
        np.testing.assert_allclose(pX_m, pX_u, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(pF_m, pF_u, rtol=1e-4, atol=1e-6)

    def test_polish_chunk_not_mesh_multiple_rejected(self):
        import jax
        from jax.sharding import Mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device CPU mesh")
        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("pop",))
        with pytest.raises(ValueError, match="multiple of the mesh"):
            polish_solutions(sys, slices, ld, defaults, LAMBDAS, grid,
                             np.tile(theta0, (12, 1)), xl, xu, steps=2,
                             chunk=6, mesh=mesh)


class TestLMRefine:
    """Matrix-free Gauss-Newton/LM on the exact residual vector."""

    def test_residual_sse_matches_objective(self):
        from phoskintime_tpu.network.objective import make_residual_fn

        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        for lams in (LAMBDAS, {**LAMBDAS, "prior": 0.3}):
            res_fn = make_residual_fn(sys, slices, ld, defaults, lams, grid)
            obj = make_population_objective(sys, slices, ld, defaults,
                                            lams, grid, differentiable=True)
            rng = np.random.default_rng(0)
            th = jnp.asarray(rng.uniform(xl, xu), jnp.float32)
            sse = float(jnp.sum(res_fn(th) ** 2))
            tot = float(np.asarray(obj(th[None])).sum())
            assert sse == pytest.approx(tot, rel=2e-4), lams

    def test_lm_improves_ga_best(self):
        from phoskintime_tpu.network.objective import make_residual_fn
        from phoskintime_tpu.network.optimize import run_global_fit
        from phoskintime_tpu.network.polish import lm_refine

        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        res = run_global_fit(sys, slices, ld, defaults, LAMBDAS, grid,
                             xl, xu, pop=16, n_gen=8, seed=0, ftol=0.0,
                             frechet_pick=False, gens_per_dispatch=4)
        best = res.pareto_X[np.argmin(res.pareto_F.sum(axis=1))]
        res_fn = make_residual_fn(sys, slices, ld, defaults, LAMBDAS, grid)
        sse_in = float(jnp.sum(res_fn(jnp.asarray(best, jnp.float32)) ** 2))
        th_out, sse_out = lm_refine(sys, slices, ld, defaults, LAMBDAS,
                                    grid, best, xl, xu, iters=8,
                                    cg_iters=12)
        assert sse_out <= sse_in + 1e-9
        assert sse_out < 0.7 * sse_in  # GN actually bites, not a no-op
        assert np.all(th_out >= np.asarray(xl) - 1e-6)
        assert np.all(th_out <= np.asarray(xu) + 1e-6)

    def test_lm_r_offset_zero_residual_formulation(self):
        """r_offset=r(theta*) makes theta* the exact global min (sse 0):
        starting AT theta* the refiner must stay put, and starting from a
        perturbation it must land far below the raw-residual floor (the
        data's own integrator truncation error, ~1e-4 rel)."""
        from phoskintime_tpu.network.objective import make_residual_fn
        from phoskintime_tpu.network.polish import lm_refine

        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        true = tiny_problem(0)[2]
        th_star, _, _, _ = init_raw_params(true, topo, BOUNDS)
        th_star = np.clip(np.asarray(th_star, float), xl, xu)
        res_fn = make_residual_fn(sys, slices, ld, defaults, LAMBDAS, grid)
        wdt = sys.rhs.W_pad.dtype
        r_off = np.asarray(res_fn(jnp.asarray(th_star, wdt)))

        # starting at theta*: zero residual by construction, no movement
        th_out, sse_out = lm_refine(sys, slices, ld, defaults, LAMBDAS,
                                    grid, th_star, xl, xu, iters=3,
                                    r_offset=r_off)
        assert sse_out < 1e-12
        np.testing.assert_allclose(th_out, th_star, atol=1e-8)

        # from a small perturbation: recovers theta* below the raw floor
        rng = np.random.default_rng(3)
        th0 = np.clip(th_star + 0.02 * rng.standard_normal(th_star.size)
                      * (1 + np.abs(th_star)), xl, xu)
        sse_raw_floor = float(r_off @ r_off)
        th_rec, sse_rec = lm_refine(sys, slices, ld, defaults, LAMBDAS,
                                    grid, th0, xl, xu, iters=12,
                                    r_offset=r_off)
        assert sse_rec < max(1e-10, 0.01 * max(sse_raw_floor, 1e-30))


class TestLMRefineMixed:
    """Mixed-precision finish: f32-system LM to its rounding floor, then
    a float64-system finish from the converged point (the north-star
    1e-6 parameter-match route on the device f32 path)."""

    def test_f64_finish_descends_past_f32_floor(self):
        from phoskintime_tpu.network.objective import make_residual_fn
        from phoskintime_tpu.network.polish import lm_refine, lm_refine_mixed

        sys, topo, slices, ld, defaults, grid, theta0, xl, xu = _setup()
        sys32 = sys.astype(np.float32)
        assert sys32.rhs.W_pad.dtype == jnp.float32
        assert sys32.astype(sys32.dtype) is sys32  # no-op cast

        true = tiny_problem(0)[2]
        th_star, _, _, _ = init_raw_params(true, topo, BOUNDS)
        th_star = np.clip(np.asarray(th_star, float), xl, xu)
        # self-consistent offsets, one per precision's own residual space
        res32 = make_residual_fn(sys32, slices, ld, defaults, LAMBDAS, grid)
        res64 = make_residual_fn(sys, slices, ld, defaults, LAMBDAS, grid)
        r32 = np.asarray(res32(jnp.asarray(th_star, jnp.float32)))
        r64 = np.asarray(res64(jnp.asarray(th_star, jnp.float64)))

        rng = np.random.default_rng(5)
        th0 = np.clip(th_star + 0.02 * rng.standard_normal(th_star.size)
                      * (1 + np.abs(th_star)), xl, xu)
        # f32-only: converges to the f32 rounding floor, not below
        _, sse32 = lm_refine(sys32, slices, ld, defaults, LAMBDAS, grid,
                             th0, xl, xu, iters=12, r_offset=r32)
        th_mx, sse_mx = lm_refine_mixed(
            sys32, slices, ld, defaults, LAMBDAS, grid, th0, xl, xu,
            iters_lo=12, iters_hi=8, r_offset_lo=r32, r_offset_hi=r64)
        # the f64 finish must descend orders of magnitude past the f32
        # floor (zero-residual formulation: theta* is the exact min)
        assert sse_mx < 1e-13
        assert sse_mx < 1e-3 * max(sse32, 1e-30)
        assert np.all(th_mx >= np.asarray(xl) - 1e-6)
        assert np.all(th_mx <= np.asarray(xu) + 1e-6)
