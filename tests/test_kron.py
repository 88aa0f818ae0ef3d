"""Kronecker-factorized model-2 path: factor algebra, φ-vector parity
with the dense ladder, and end-to-end accuracy vs the dense ETD2RK path
and a tight-tolerance RK45 oracle.

Spec anchor: reference global_model/models.py:322-432 (hypercube RHS).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from phoskintime_tpu.network.kron import (_expm2x2, _factor_square,
                                          _kron_mv, _ksum_mv,
                                          _phi_vectors_kron, _r_scalars)


def _rand_entries(rng, s, B):
    """Generator-shaped random entries: a=-S, c=S, b=E, d=-(E+Dp+D)."""
    S = rng.uniform(0.05, 3.0, (s, B))
    E = rng.uniform(0.05, 2.0, (s, B))
    DpD = rng.uniform(0.1, 2.5, (s, B))
    return -S, E, S, -(E + DpD)


def _dense_K(a, b, c, d):
    """Dense 2^s x 2^s Kronecker-sum operator from per-site entries
    (single lane), built by independent per-edge accumulation."""
    s = a.shape[0]
    M = 1 << s
    K = np.zeros((M, M))
    for m in range(M):
        for j in range(s):
            if (m >> j) & 1:
                K[m, m] += d[j]
                K[m ^ (1 << j), m] += b[j]
            else:
                K[m, m] += a[j]
                K[m ^ (1 << j), m] += c[j]
    return K


class TestFactorAlgebra:
    def test_expm2x2_vs_scipy(self):
        from scipy.linalg import expm
        rng = np.random.default_rng(0)
        a, b, c, d = _rand_entries(rng, 5, 7)
        g00, g01, g10, g11 = _expm2x2(*map(jnp.asarray, (a, b, c, d)))
        for j in range(5):
            for l in range(7):
                ref = expm(np.array([[a[j, l], b[j, l]],
                                     [c[j, l], d[j, l]]]))
                got = np.array([[g00[j, l], g01[j, l]],
                                [g10[j, l], g11[j, l]]])
                np.testing.assert_allclose(got, ref, rtol=5e-6, atol=1e-8)

    def test_expm2x2_zero_is_identity(self):
        z = jnp.zeros((2, 3))
        g00, g01, g10, g11 = _expm2x2(z, z, z, z)
        np.testing.assert_allclose(np.asarray(g00), 1.0)
        np.testing.assert_allclose(np.asarray(g11), 1.0)
        np.testing.assert_allclose(np.asarray(g01), 0.0)
        np.testing.assert_allclose(np.asarray(g10), 0.0)

    def test_factor_square(self):
        rng = np.random.default_rng(1)
        G = jnp.asarray(rng.normal(0, 1, (3, 2, 2, 4)))
        G2 = _factor_square(G)
        for j in range(3):
            for l in range(4):
                np.testing.assert_allclose(
                    np.asarray(G2[j, :, :, l]),
                    np.asarray(G[j, :, :, l]) @ np.asarray(G[j, :, :, l]),
                    rtol=1e-12)

    @pytest.mark.parametrize("s", [1, 2, 4])
    def test_kron_mv_vs_dense(self, s):
        """⊗G apply == dense Kronecker-product matmul (bit-j stride 2^j)."""
        rng = np.random.default_rng(2)
        M = 1 << s
        G = rng.normal(0, 1, (s, 2, 2, 1))
        X = rng.normal(0, 1, (M, 1))
        got = _kron_mv(jnp.asarray(G), jnp.asarray(X), s)
        # Dref[m', m] = prod_j G_j[bit_j(m'), bit_j(m)]
        Dref = np.zeros((M, M))
        for mp in range(M):
            for m in range(M):
                v = 1.0
                for j in range(s):
                    v *= G[j, (mp >> j) & 1, (m >> j) & 1, 0]
                Dref[mp, m] = v
        np.testing.assert_allclose(np.asarray(got)[:, 0], Dref @ X[:, 0],
                                   rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("s", [1, 3])
    def test_ksum_mv_vs_dense(self, s):
        rng = np.random.default_rng(3)
        M = 1 << s
        a, b, c, d = _rand_entries(rng, s, 1)
        K = _dense_K(a[:, 0], b[:, 0], c[:, 0], d[:, 0])
        X = rng.normal(0, 1, (M, 1))
        got = _ksum_mv(*map(jnp.asarray, (a, b, c, d)), jnp.asarray(X), s)
        np.testing.assert_allclose(np.asarray(got)[:, 0], K @ X[:, 0],
                                   rtol=1e-10, atol=1e-12)


class TestPhiVectorsKron:
    @pytest.mark.parametrize("h", [0.25, 2.0, 16.0])
    def test_matches_dense_ladder(self, h):
        """q1/q2 from the factorized ladder == the dense lane ladder run
        on the assembled Kronecker-sum operator (shared radius/terms)."""
        from phoskintime_tpu.network.expo import _phi_vectors_lanes
        rng = np.random.default_rng(4)
        s, B = 3, 5
        M = 1 << s
        a, b, c, d = _rand_entries(rng, s, B)
        G, q1, q2 = _phi_vectors_kron(*map(jnp.asarray, (a, b, c, d)),
                                      h, 24, jnp.float64)
        Ks = np.stack([_dense_K(a[:, l], b[:, l], c[:, l], d[:, l])
                       for l in range(B)], axis=-1)          # (M, M, B)
        E_d, p1_d, p2_d = _phi_vectors_lanes(
            jnp.asarray(Ks), jnp.full((B,), h), unroll=24)
        np.testing.assert_allclose(np.asarray(q1), np.asarray(p1_d),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(q2), np.asarray(p2_d),
                                   rtol=1e-9, atol=1e-12)
        # factors reassemble to expm(hK)
        for l in range(B):
            got = np.zeros((M, M))
            for mp in range(M):
                for m in range(M):
                    v = 1.0
                    for j in range(s):
                        v *= float(G[j, (mp >> j) & 1, (m >> j) & 1, l])
                    got[mp, m] = v
            np.testing.assert_allclose(got, np.asarray(E_d[:, :, l]),
                                       rtol=1e-8, atol=1e-11)

    def test_r_scalars(self):
        for Bv, h in [(0.7, 2.0), (1e-8, 16.0), (3.0, 0.25)]:
            eR, p1, p2 = _r_scalars(jnp.asarray([Bv]), h, jnp.float64)
            z = -Bv * h
            phi1 = (np.expm1(z)) / z if abs(z) > 1e-12 else 1.0
            phi2 = (np.expm1(z) - z) / z ** 2 if abs(z) > 1e-12 else 0.5
            assert float(eR[0]) == pytest.approx(np.exp(z), rel=1e-7)
            assert float(p1[0]) == pytest.approx(h * phi1, rel=1e-6)
            assert float(p2[0]) == pytest.approx(h * h * phi2, rel=1e-6)


GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])


def _model2_system(hetero=False, seed=0):
    from phoskintime_tpu.network import (GlobalSystem, build_kinase_matrix,
                                         build_topology, default_params)
    if hetero:
        inter = pd.DataFrame({
            "protein": ["GA", "GA", "GB", "GC", "GD", "GD", "GD"],
            "psite": ["S1", "S2", "S1", "S1", "S1", "S2", "S3"],
            "kinase": ["K1", "K1", "K2", "K1", "K2", "K1", "K2"]})
        tf = pd.DataFrame({"tf": ["GA", "GC", "GD"],
                           "target": ["GB", "GA", "GC"]})
    else:
        inter = pd.DataFrame({
            "protein": ["GA", "GA", "GB", "GC"],
            "psite": ["S1", "S2", "S1", "S1"],
            "kinase": ["K1", "K1", "K2", "K1"]})
        tf = pd.DataFrame({"tf": ["GA", "GC"], "target": ["GB", "GA"]})
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


def _batched(sys_, pj, pop=3, seed=1, **kw):
    from phoskintime_tpu.network.expo import exponential_simulate_batched
    rng = np.random.default_rng(seed)
    pb = {k: jnp.asarray(np.asarray(v)[None]
                         * rng.uniform(0.7, 1.3, (pop,) + (1,) * np.ndim(v)))
          for k, v in pj.items()}
    return exponential_simulate_batched(sys_, pb, GRID, **kw)


class TestKronSimulate:
    """End-to-end: the factorized re-splitting is exact linear algebra
    (pinned above) but moves the mask-0 decay −D·X₀ into the explicit
    remainder, whose ETD2RK correction stage has an RK2-style stability
    bound |h·D| ≲ 2. These tests pin BOTH sides of the negative result:
    parity in the stable regime, divergence beyond it."""

    @pytest.mark.slow
    @pytest.mark.parametrize("hetero", [False, True])
    def test_matches_dense_path_stable_regime(self, hetero):
        """substep 0.5 -> h·D ≤ ~0.75: the splittings agree to O(h³)."""
        sys_, pj = _model2_system(hetero)
        ys_k, ok_k = _batched(sys_, pj, substep=0.5, use_kron=True)
        ys_d, ok_d = _batched(sys_, pj, substep=0.5, use_kron=False,
                              width_bucketing=False)
        assert bool(jnp.all(ok_k)) and bool(jnp.all(ok_d))
        np.testing.assert_allclose(np.asarray(ys_k), np.asarray(ys_d),
                                   rtol=2e-2, atol=1e-4)

    def test_unstable_beyond_rk2_bound(self):
        """Production-plan step sizes (h·D > 2) diverge — the measured
        fact that demotes this path to opt-in."""
        sys_, pj = _model2_system()
        assert float(np.max(np.asarray(pj["D_i"]))) * 4.0 > 2.0
        ys, ok = _batched(sys_, pj, substep=4.0, use_kron=True)
        # geometric blow-up: overflows to non-finite in f32; stays finite
        # but astronomically large in f64 — assert either signature
        diverged = (not bool(jnp.all(ok))
                    or float(jnp.max(jnp.abs(ys))) > 1e12)
        assert diverged

    def test_default_stays_dense(self):
        """Default flags must NOT route model 2 through kron (it would
        diverge at the production substep)."""
        sys_, pj = _model2_system()
        ys_a, ok_a = _batched(sys_, pj, substep=16.0)
        assert bool(jnp.all(ok_a))
        assert bool(jnp.all(jnp.isfinite(ys_a)))

    @pytest.mark.slow
    def test_matches_rk45_stable_regime(self):
        from phoskintime_tpu.network.simulate import simulate
        sys_, pj = _model2_system(hetero=True, seed=2)
        ref = simulate(sys_, pj, jnp.asarray(GRID), rtol=1e-10, atol=1e-12,
                       max_steps=500_000)
        assert bool(ref.success)
        pb = {k: jnp.asarray(v)[None] for k, v in pj.items()}
        from phoskintime_tpu.network.expo import exponential_simulate_batched
        ys, ok = exponential_simulate_batched(sys_, pb, GRID, substep=0.5,
                                              use_kron=True)
        assert bool(jnp.all(ok))
        np.testing.assert_allclose(np.asarray(ys[0]), np.asarray(ref.ys),
                                   rtol=5e-3, atol=1e-5)

    @pytest.mark.slow
    def test_differentiable(self):
        """Reverse-mode AD through the kron path (stable regime)."""
        sys_, pj = _model2_system()
        pb = {k: jnp.asarray(v)[None] for k, v in pj.items()}
        from phoskintime_tpu.network.expo import exponential_simulate_batched

        def loss(ck):
            p2 = dict(pb, c_k=ck)
            ys, _ = exponential_simulate_batched(
                sys_, p2, jnp.asarray(GRID[:6]), substep=0.5, use_kron=True,
                differentiable=True)
            return jnp.sum(ys ** 2)

        g = jax.grad(loss)(pb["c_k"])
        assert bool(jnp.all(jnp.isfinite(g)))
        assert float(jnp.max(jnp.abs(g))) > 0
