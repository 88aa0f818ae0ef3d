"""Exponential (ETD2RK) integrator tests: phi-matrix identities and
accuracy vs tight-tolerance RK45 on real network systems."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

pytestmark = pytest.mark.slow  # integration tier: excluded from the <5-min smoke run

from phoskintime_tpu.network import GlobalSystem, build_kinase_matrix, build_topology, default_params
from phoskintime_tpu.network.expo import _phi_matrices, exponential_simulate
from phoskintime_tpu.network.simulate import simulate

GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])


class TestPhiMatrices:
    def test_scalar_identities(self):
        for lam, h in [(-2.0, 0.5), (-0.01, 10.0), (0.0, 1.0), (1.5, 0.3)]:
            L = jnp.asarray([[[lam]]])
            E, P1, P2 = _phi_matrices(L, jnp.asarray([h]))
            z = lam * h
            e = np.exp(z)
            phi1 = (e - 1) / z if z != 0 else 1.0
            phi2 = (e - 1 - z) / z ** 2 if z != 0 else 0.5
            assert float(E[0, 0, 0]) == pytest.approx(e, rel=1e-9)
            assert float(P1[0, 0, 0]) == pytest.approx(h * phi1, rel=1e-9)
            assert float(P2[0, 0, 0]) == pytest.approx(h * h * phi2, rel=1e-9)

    def test_matrix_identity_vs_quadrature(self):
        rng = np.random.default_rng(0)
        L = jnp.asarray(rng.normal(0, 1, (1, 3, 3)))
        h = jnp.asarray([0.7])
        E, P1, P2 = _phi_matrices(L, h)
        # quadrature check of Phi1 = int_0^h e^{L s} ds
        s = np.linspace(0, 0.7, 2001)
        from scipy.linalg import expm as scipy_expm
        vals = np.stack([scipy_expm(np.asarray(L[0]) * si) for si in s])
        quad = np.trapezoid(vals, s, axis=0)
        np.testing.assert_allclose(np.asarray(P1[0]), quad, rtol=1e-5)


def make_system(model=0, seed=0):
    inter = pd.DataFrame({
        "protein": ["GA", "GA", "GB", "GC"],
        "psite": ["S1", "S2", "S1", "S1"],
        "kinase": ["K1", "K1", "K2", "K1"],
    })
    tf = pd.DataFrame({"tf": ["GA", "GC"], "target": ["GB", "GA"]})
    topo = build_topology(inter, tf, model=model)
    Kmat = build_kinase_matrix(topo.kinases, None, GRID)
    Kmat *= 1.0 + 0.25 * np.sin(np.arange(len(GRID)))[None, :]
    sys_ = GlobalSystem(topo, GRID, Kmat)
    rng = np.random.default_rng(seed)
    p = default_params(topo)
    for k in ["c_k", "A_i", "B_i", "C_i", "D_i", "E_i"]:
        p[k] = rng.uniform(0.1, 1.5, p[k].shape)
    p["Dp_i"] = rng.uniform(0.2, 2.5, p["Dp_i"].shape) * topo.site_mask()
    p["tf_scale"] = 2.2
    return sys_, {k: jnp.asarray(v) for k, v in p.items()}


class TestExponentialSimulate:
    @pytest.mark.parametrize("model", [0, 1, 2])
    def test_matches_rk45(self, model):
        sys_, pj = make_system(model)
        ref = simulate(sys_, pj, jnp.asarray(GRID), rtol=1e-10, atol=1e-12,
                       max_steps=500_000)
        assert bool(ref.success)
        got = exponential_simulate(sys_, pj, GRID, substep=8.0)
        assert bool(got.success)
        np.testing.assert_allclose(np.asarray(got.ys), np.asarray(ref.ys),
                                   rtol=1e-3, atol=1e-6)

    def test_substep_convergence(self):
        sys_, pj = make_system(0)
        ref = simulate(sys_, pj, jnp.asarray(GRID), rtol=1e-11, atol=1e-13,
                       max_steps=500_000)
        errs = []
        for sub in [8.0, 2.0, 0.5]:
            got = exponential_simulate(sys_, pj, GRID, substep=sub)
            errs.append(float(jnp.max(jnp.abs(got.ys - ref.ys))))
        # second-order in the refined region: monotone, strong decay overall
        assert errs[1] < errs[0] / 2
        assert errs[2] < errs[1] / 2
        assert errs[2] < 2e-5

    def test_vmappable_population(self):
        import jax

        sys_, pj = make_system(0)

        def run(scale):
            p2 = dict(pj)
            p2["A_i"] = pj["A_i"] * scale
            return exponential_simulate(sys_, p2, GRID).ys

        out = jax.vmap(run)(jnp.asarray([0.5, 1.0, 2.0]))
        assert out.shape[0] == 3
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_model4_rosenbrock_matches_rk45(self):
        """The saturating mechanism integrates via per-segment exponential
        Rosenbrock (state-dependent Jacobian, in-scan phi build)."""
        sys_, pj = make_system(4)
        ref = simulate(sys_, pj, jnp.asarray(GRID), rtol=1e-10, atol=1e-12,
                       max_steps=300000)
        assert bool(ref.success)
        res = exponential_simulate(sys_, pj, GRID)
        assert bool(res.success)
        err = np.max(np.abs(np.asarray(res.ys) - np.asarray(ref.ys)) /
                     (np.abs(np.asarray(ref.ys)) + 1e-8))
        assert err < 5e-3

    def test_model4_analytic_jacobian_matches_jvp(self):
        from phoskintime_tpu.network.expo import _jac_blocks_batched
        import jax

        sys_, pj = make_system(4, seed=3)
        N, w = sys_.topo.N, sys_.topo.width
        rng = np.random.default_rng(1)
        Y = jnp.asarray(np.abs(rng.normal(1.0, 0.5, (1, N, w))))
        pj_b = {k: jnp.asarray(v)[None] for k, v in pj.items()}
        J_ref = _jac_blocks_batched(sys_, pj_b, Y, 3, 0.0, Y.dtype)

        def jac_one(Yy, pp):
            Kt = sys_.rhs.kinase_activity(pp, 3)
            S = sys_.rhs.site_rates(Kt)
            return sys_.rhs.jac_blocks_saturating(Yy, S, pp)

        J_an = jax.vmap(jac_one)(Y, pj_b)
        np.testing.assert_allclose(np.asarray(J_an), np.asarray(J_ref),
                                   atol=1e-12)


def make_hetero_system(seed=0):
    """Model-2 network with site counts 1/1/2/3 -> block widths 3/3/5/9:
    the width-bucketed propagator path activates automatically (w = 9)."""
    inter = pd.DataFrame({
        "protein": ["GA", "GA", "GB", "GC", "GD", "GD", "GD"],
        "psite": ["S1", "S2", "S1", "S1", "S1", "S2", "S3"],
        "kinase": ["K1", "K1", "K2", "K1", "K2", "K1", "K2"],
    })
    tf = pd.DataFrame({"tf": ["GA", "GC", "GD"],
                       "target": ["GB", "GA", "GC"]})
    topo = build_topology(inter, tf, model=2)
    Kmat = build_kinase_matrix(topo.kinases, None, GRID)
    Kmat *= 1.0 + 0.25 * np.sin(np.arange(len(GRID)))[None, :]
    sys_ = GlobalSystem(topo, GRID, Kmat)
    rng = np.random.default_rng(seed)
    p = default_params(topo)
    for k in ["c_k", "A_i", "B_i", "C_i", "D_i", "E_i"]:
        p[k] = rng.uniform(0.1, 1.5, p[k].shape)
    p["Dp_i"] = rng.uniform(0.2, 2.5, p["Dp_i"].shape) * topo.site_mask()
    p["tf_scale"] = 2.2
    return sys_, {k: jnp.asarray(v) for k, v in p.items()}


class TestWidthBucketing:
    """Per-width-class propagator tables for the combinatorial mechanism
    (round-3 model-2 throughput fix) must be exact: the padded rows/cols
    of every affine block are zero, so the narrow top-left corner
    propagates identically to the padded full-width table."""

    def _batched(self, sys_, pj, pop=3, seed=1, **kw):
        from phoskintime_tpu.network.expo import exponential_simulate_batched

        rng = np.random.default_rng(seed)
        pb = {k: jnp.asarray(np.asarray(v)[None]
                             * rng.uniform(0.7, 1.3, (pop,) + (1,) * np.ndim(v)))
              for k, v in pj.items()}
        return exponential_simulate_batched(sys_, pb, GRID, substep=8.0, **kw)

    def test_bucketed_matches_unbucketed_auto(self):
        sys_, pj = make_hetero_system()
        assert sys_.topo.width == 9
        ys_b, ok_b = self._batched(sys_, pj, width_bucketing=True)
        ys_f, ok_f = self._batched(sys_, pj, width_bucketing=False)
        assert bool(jnp.all(ok_b)) and bool(jnp.all(ok_f))
        np.testing.assert_allclose(np.asarray(ys_b), np.asarray(ys_f),
                                   rtol=2e-4, atol=1e-6)

    def test_bucketed_matches_rk45(self):
        sys_, pj = make_hetero_system(seed=2)
        ref = simulate(sys_, pj, jnp.asarray(GRID), rtol=1e-10, atol=1e-12,
                       max_steps=500_000)
        assert bool(ref.success)
        from phoskintime_tpu.network.expo import exponential_simulate_batched

        pb = {k: jnp.asarray(v)[None] for k, v in pj.items()}
        ys, ok = exponential_simulate_batched(sys_, pb, GRID, substep=2.0,
                                              width_bucketing=True)
        assert bool(jnp.all(ok))
        np.testing.assert_allclose(
            np.asarray(ys[0]), np.asarray(ref.ys), rtol=5e-3, atol=1e-5)

    def test_forced_on_small_width(self):
        """width_bucketing=True buckets even below the auto threshold
        (w = 5 here) and still matches the full-width path."""
        sys_, pj = make_system(2)
        ys_b, ok_b = self._batched(sys_, pj, width_bucketing=True)
        ys_f, ok_f = self._batched(sys_, pj, width_bucketing=False)
        assert bool(jnp.all(ok_b)) and bool(jnp.all(ok_f))
        np.testing.assert_allclose(np.asarray(ys_b), np.asarray(ys_f),
                                   rtol=2e-4, atol=1e-6)


class TestReturnObservables:
    """return_observables=True must return ((R, TOT, PHO), success) with
    values equal to extract_observables on the trajectory, on EVERY path:
    model 4 (Rosenbrock), megakernel (interpret mode on CPU),
    width-bucketed model 2, and the default unbucketed XLA scan
    (round-3 advisor finding: the last two silently ignored the flag)."""

    def _check(self, sys_, pj, pop=2, **kw):
        import jax

        from phoskintime_tpu.network.expo import exponential_simulate_batched
        from phoskintime_tpu.network.simulate import extract_observables

        rng = np.random.default_rng(7)
        pb = {k: jnp.asarray(np.asarray(v)[None]
                             * rng.uniform(0.8, 1.2, (pop,) + (1,) * np.ndim(v)))
              for k, v in pj.items()}
        ys, ok = exponential_simulate_batched(sys_, pb, GRID, substep=8.0, **kw)
        (R, TOT, PHO), ok2 = exponential_simulate_batched(
            sys_, pb, GRID, substep=8.0, return_observables=True, **kw)
        np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok2))

        def one(Y):
            o = extract_observables(sys_, Y)
            return o.R, o.TOT, o.PHO

        R_ref, TOT_ref, PHO_ref = jax.vmap(one)(ys)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R_ref), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(TOT), np.asarray(TOT_ref), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(PHO), np.asarray(PHO_ref), rtol=1e-6)

    def test_unbucketed_scan(self):
        sys_, pj = make_system(0)
        self._check(sys_, pj)

    def test_model4_rosenbrock(self):
        sys_, pj = make_system(4)
        self._check(sys_, pj)

    def test_width_bucketed(self):
        sys_, pj = make_hetero_system()
        self._check(sys_, pj, width_bucketing=True)


class TestLinearBlocksLanes:
    """The lane-native block assembly (models 0/1) must reproduce the
    jvp/analytic builder exactly, for any subset of kinase buckets."""

    @pytest.mark.parametrize("model", [0, 1])
    @pytest.mark.parametrize("buckets", [(0, 3, 7), (5,)])
    def test_matches_transpose_path(self, model, buckets):
        import jax

        from phoskintime_tpu.network.expo import (_block_linear_operators,
                                                  _linear_blocks_lanes)

        sys_, p = make_system(model=model)
        topo = sys_.topo
        N, w = topo.N, topo.width
        buckets = np.array(buckets, np.int32)
        P = 4
        rng = np.random.default_rng(5)
        params_b = {k: jnp.asarray(
            np.asarray(v)[None] * rng.uniform(0.5, 1.5, (P,) + (1,) * np.ndim(v)))
            for k, v in p.items()}
        dtype = sys_.rhs.W_pad.dtype

        L_pb = jax.vmap(lambda pp: _block_linear_operators(
            sys_, pp, buckets, dtype))(params_b)          # (P, Bu, N, w, w)
        ref = jnp.transpose(L_pb, (1, 3, 4, 0, 2)).reshape(
            len(buckets), w, w, P * N)

        out = _linear_blocks_lanes(sys_, params_b, buckets, dtype)
        assert out.shape == ref.shape
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=2e-6, atol=1e-7)
