"""Global-model tests: topology, vectorized RHS parity vs an independent
ragged-loop implementation of the published equations, steady-state oracles,
simulation, loss gathers, softplus packing, and sharded population eval."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from phoskintime_tpu.network import (
    GlobalSystem,
    build_kinase_matrix,
    build_topology,
    calculate_bio_bounds,
    default_params,
    evaluate_population,
    extract_observables,
    init_raw_params,
    make_objective,
    modality_losses,
    prepare_loss_data,
    simulate,
    simulate_and_measure,
    steady_state_combinatorial,
    steady_state_distributive,
    steady_state_sequential,
    unpack_params,
)
from phoskintime_tpu.network.params import softplus
from phoskintime_tpu.network.steadystate import build_y0_from_data

GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])
RNA_GRID = np.array([4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 240.0, 480.0, 960.0])


def small_net(model=0):
    """3 proteins (one is a kinase, one has 0 sites), 2 kinases, TF edges."""
    inter = pd.DataFrame({
        "protein": ["GA", "GA", "GB", "KIN1"],
        "psite": ["S10", "T20", "S5", "S99"],
        "kinase": ["KIN1", "KIN2", "KIN1", "KIN2"],
    })
    tf = pd.DataFrame({
        "tf": ["GA", "GB", "ORPH"],
        "target": ["GB", "GA", "KIN1"],
    })
    topo = build_topology(inter, tf, model=model)
    Kmat = build_kinase_matrix(topo.kinases, None, GRID)
    # vary the kinase signal so buckets matter
    Kmat = Kmat * (1.0 + 0.1 * np.arange(len(GRID))[None, :])
    return topo, Kmat


def ragged_rhs_reference(topo, params, Kt, Y_pad, model):
    """Independent flat-loop implementation of the published mechanism
    equations (the test oracle — mirrors reference semantics directly)."""
    N = topo.N
    msk = topo.site_mask()
    S_pad = np.einsum("nsk,k->ns", topo.W_pad, Kt)

    # P_vec with driver override
    P_vec = np.zeros(N)
    for i in range(N):
        if topo.model == 2:
            P_vec[i] = Y_pad[i, 1:][topo.state_mask()[i]].sum()
        else:
            ns = topo.n_sites[i]
            P_vec[i] = Y_pad[i, 1] + Y_pad[i, 2:2 + ns].sum()
        if topo.driver_map[i] >= 0:
            P_vec[i] = Kt[topo.driver_map[i]]

    v = (topo.tf_mat @ P_vec) / topo.tf_deg
    u = v / (1 + np.abs(v))

    A, B, C, D, E = (params[k] for k in ["A_i", "B_i", "C_i", "D_i", "E_i"])
    Dp = params["Dp_i"]
    tfs = params["tf_scale"]

    dY = np.zeros_like(Y_pad)
    for i in range(N):
        ui = u[i]
        if ui >= 0:
            synth = A[i] * (1 + (tfs * ui) / (1 + ui + 1e-6))
        else:
            synth = A[i] / (1 + tfs * abs(ui))
        R = Y_pad[i, 0]
        dY[i, 0] = synth - B[i] * R
        ns = int(topo.n_sites[i])

        if model in (0, 4):
            P0 = Y_pad[i, 1]
            if ns == 0:
                if model == 4:
                    dY[i, 1] = (C[i] * R) / (1 + R) - D[i] * P0
                else:
                    dY[i, 1] = C[i] * R - D[i] * P0
                continue
            ssum = back = 0.0
            for j in range(ns):
                s = S_pad[i, j]
                ps = Y_pad[i, 2 + j]
                if model == 4:
                    ff = s * P0 / (1 + P0)
                    bk = E[i] * ps
                    dY[i, 2 + j] = ff - (Dp[i, j] + D[i]) * ps - bk
                    ssum += ff; back += bk
                else:
                    ssum += s
                    back += E[i] * ps
                    dY[i, 2 + j] = s * P0 - (E[i] + Dp[i, j] + D[i]) * ps
            if model == 4:
                dY[i, 1] = (C[i] * R) / (1 + R) - D[i] * P0 - ssum + back
            else:
                dY[i, 1] = C[i] * R - (D[i] + ssum) * P0 + back

        elif model == 1:
            P0 = Y_pad[i, 1]
            if ns == 0:
                dY[i, 1] = C[i] * R - D[i] * P0
                continue
            k0 = S_pad[i, 0]
            P1 = Y_pad[i, 2]
            dY[i, 1] = C[i] * R - D[i] * P0 - k0 * P0 + E[i] * P1
            if ns == 1:
                dY[i, 2] = k0 * P0 - (E[i] + Dp[i, 0] + D[i]) * P1
                continue
            k1 = S_pad[i, 1]
            P2 = Y_pad[i, 3]
            dY[i, 2] = k0 * P0 + E[i] * P2 - (k1 + E[i] + Dp[i, 0] + D[i]) * P1
            for j in range(1, ns - 1):
                kp, kn = S_pad[i, j], S_pad[i, j + 1]
                Pp, Pj, Pn = Y_pad[i, 1 + j], Y_pad[i, 2 + j], Y_pad[i, 3 + j]
                dY[i, 2 + j] = kp * Pp + E[i] * Pn - (kn + E[i] + Dp[i, j] + D[i]) * Pj
            j = ns - 1
            dY[i, 2 + j] = (S_pad[i, j] * Y_pad[i, 1 + j]
                            - (E[i] + Dp[i, j] + D[i]) * Y_pad[i, 2 + j])

        elif model == 2:
            nst = 1 << ns
            X = Y_pad[i, 1:1 + nst]
            dX = np.zeros(nst)
            dX[0] += C[i] * R - D[i] * X[0]
            for m in range(1, nst):
                dp_rate = 0.0
                mm = m
                while mm:
                    lsb = mm & -mm
                    mm -= lsb
                    j = lsb.bit_length() - 1
                    to = m ^ lsb
                    flux = E[i] * X[m]
                    dX[m] -= flux
                    dX[to] += flux
                    dp_rate += Dp[i, j] + D[i]
                dX[m] -= dp_rate * X[m]
            for m in range(nst):
                for j in range(ns):
                    if not m & (1 << j):
                        flux = S_pad[i, j] * X[m]
                        dX[m] -= flux
                        dX[m | (1 << j)] += flux
            dY[i, 1:1 + nst] = dX
    return dY


class TestTopology:
    def test_basic_shapes(self):
        topo, Kmat = small_net()
        assert topo.N == 4  # GA, GB, KIN1, ORPH (KIN2 is input-only)
        assert "ORPH" in topo.proteins
        assert topo.n_sites[topo.p2i["GA"]] == 2
        assert topo.n_sites[topo.p2i["GB"]] == 1
        assert topo.n_sites[topo.p2i["ORPH"]] == 0

    def test_orphan_proxy(self):
        topo, _ = small_net()
        assert topo.proxy_map.get("ORPH") == "KIN1"
        i = topo.p2i["ORPH"]
        assert topo.driver_map[i] == topo.k2i["KIN1"]

    def test_site_residue_sort(self):
        inter = pd.DataFrame({
            "protein": ["G", "G", "G"],
            "psite": ["S100", "T5", "Y30"],
            "kinase": ["K", "K", "K"],
        })
        topo = build_topology(inter)
        assert topo.sites[topo.p2i["G"]] == ["T5", "Y30", "S100"]

    def test_kinase_is_driven(self):
        topo, _ = small_net()
        assert topo.driver_map[topo.p2i["KIN1"]] == topo.k2i["KIN1"]


@pytest.mark.parametrize("model", [0, 1, 4, 2])
class TestRHSParity:
    def test_matches_ragged_reference(self, model):
        topo, Kmat = small_net(model=model)
        sys = GlobalSystem(topo, GRID, Kmat)
        rng = np.random.default_rng(model)
        params = default_params(topo)
        for k in ["c_k", "A_i", "B_i", "C_i", "D_i", "E_i"]:
            params[k] = rng.uniform(0.3, 2.0, params[k].shape)
        params["Dp_i"] = rng.uniform(0.3, 2.0, params["Dp_i"].shape) * topo.site_mask()
        params["tf_scale"] = 1.7
        pj = {k: jnp.asarray(v) for k, v in params.items()}

        Y = rng.uniform(0.2, 1.5, (topo.N, topo.width))
        if model == 2:
            Y[:, 1:] *= topo.state_mask()
        else:
            Y[:, 2:] *= topo.site_mask()

        for jb in [0, 5, 13]:
            Kt = Kmat[:, jb] * params["c_k"]
            expected = ragged_rhs_reference(topo, params, Kt, Y, model)
            got = np.asarray(sys.rhs(0.0, jnp.asarray(Y).reshape(-1), jb, pj))
            np.testing.assert_allclose(got.reshape(topo.N, topo.width),
                                       expected, rtol=1e-10, atol=1e-12)


class TestSteadyStates:
    def _iso_system(self, model):
        """Network with no TF edges and no drivers: u = 0 so the analytic
        params=1 steady states are exact equilibria of the full RHS."""
        inter = pd.DataFrame({
            "protein": ["GA", "GA", "GB", "GC", "GC", "GC"],
            "psite": ["S1", "S2", "S1", "S1", "S2", "S3"],
            "kinase": ["K", "K", "K", "K", "K", "K"],
        })
        topo = build_topology(inter, None, model=model)
        topo.driver_map[:] = -1  # isolate: no live-drive
        Kmat = np.ones((topo.K, len(GRID)))
        return topo, Kmat

    @pytest.mark.parametrize("model,ss_fn", [
        (0, steady_state_distributive),
        (1, steady_state_sequential),
        (2, steady_state_combinatorial),
    ])
    def test_rhs_zero_at_steady_state(self, model, ss_fn):
        topo, Kmat = self._iso_system(model)
        sys = GlobalSystem(topo, GRID, Kmat)
        params = default_params(topo)
        params["Dp_i"] = params["Dp_i"] * topo.site_mask()
        pj = {k: jnp.asarray(v) for k, v in params.items()}
        Y = ss_fn(topo)
        dy = np.asarray(sys.rhs(0.0, jnp.asarray(Y).reshape(-1), 0, pj))
        np.testing.assert_allclose(dy, 0.0, atol=1e-9)

    def test_integration_converges_to_ss(self):
        topo, Kmat = self._iso_system(0)
        sys = GlobalSystem(topo, GRID, Kmat)
        params = {k: jnp.asarray(v) for k, v in default_params(topo).items()}
        res = simulate(sys, params, jnp.asarray([100.0, 960.0]),
                       rtol=1e-8, atol=1e-10, max_steps=50000)
        assert bool(res.success)
        Y_end = np.asarray(res.ys[-1]).reshape(topo.N, topo.width)
        Y_ss = steady_state_distributive(topo)
        np.testing.assert_allclose(Y_end, Y_ss, rtol=1e-5, atol=1e-7)


class TestLossAndObjective:
    def _data(self, topo):
        rows_p, rows_r, rows_ph = [], [], []
        rng = np.random.default_rng(0)
        for p in topo.proteins:
            for t in GRID:
                rows_p.append((p, t, rng.uniform(0.5, 2.0)))
            for t in RNA_GRID:
                rows_r.append((p, t, rng.uniform(0.5, 2.0)))
            for s in topo.sites[topo.p2i[p]]:
                for t in GRID:
                    rows_ph.append((p, s, t, rng.uniform(0.5, 2.0)))
        df_p = pd.DataFrame(rows_p, columns=["protein", "time", "fc"])
        df_r = pd.DataFrame(rows_r, columns=["protein", "time", "fc"])
        df_ph = pd.DataFrame(rows_ph, columns=["protein", "psite", "time", "fc"])
        return df_p, df_r, df_ph

    def test_loss_gathers_match_direct(self):
        topo, Kmat = small_net()
        sys = GlobalSystem(topo, GRID, Kmat)
        df_p, df_r, df_ph = self._data(topo)
        grid = np.unique(np.concatenate([GRID, RNA_GRID]))
        ld = prepare_loss_data(topo, df_p, df_r, df_ph, grid)
        params = {k: jnp.asarray(v) for k, v in default_params(topo).items()}
        res = simulate(sys, params, jnp.asarray(grid))
        obs = extract_observables(sys, res.ys)
        lp, lr, lph = modality_losses((obs.R, obs.TOT, obs.PHO), ld, 0)
        # direct: squared error over protein obs
        TOT = np.asarray(obs.TOT)
        direct = 0.0
        for k in range(len(ld.obs_prot)):
            cur = max(TOT[ld.t_prot[k], ld.p_prot[k]], 1e-9)
            base = max(TOT[ld.prot_base_idx, ld.p_prot[k]], 1e-9)
            direct += ld.w_prot[k] * (ld.obs_prot[k] - cur / base) ** 2
        assert float(lp) == pytest.approx(direct, rel=1e-10)
        assert np.isfinite(float(lr)) and np.isfinite(float(lph))

    @pytest.mark.slow
    def test_objective_and_population_sharding(self):
        topo, Kmat = small_net()
        sys = GlobalSystem(topo, GRID, Kmat)
        df_p, df_r, df_ph = self._data(topo)
        grid = np.unique(np.concatenate([GRID, RNA_GRID]))
        ld = prepare_loss_data(topo, df_p, df_r, df_ph, grid)
        defaults = default_params(topo)
        bounds = calculate_bio_bounds(topo, df_p, df_r, Kmat)
        theta0, slices, xl, xu = init_raw_params(defaults, topo, bounds)
        lambdas = {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.1}
        obj = make_objective(sys, slices, ld, defaults, lambdas, grid)

        F0 = np.asarray(obj(jnp.asarray(theta0)))
        assert F0.shape == (3,) and np.all(np.isfinite(F0))

        # population of 16 over an 8-device mesh
        from jax.sharding import Mesh
        rng = np.random.default_rng(1)
        pop = jnp.asarray(theta0[None] + 0.1 * rng.normal(size=(16, len(theta0))))
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("pop",))
        F = np.asarray(evaluate_population(obj, pop, mesh=mesh))
        assert F.shape == (16, 3)
        assert np.all(np.isfinite(F))
        # sharded result equals unsharded
        F_ref = np.asarray(evaluate_population(obj, pop))
        np.testing.assert_allclose(F, F_ref, rtol=1e-9)

    @pytest.mark.slow
    def test_uneven_population_padding_under_mesh(self):
        """P % n_devices != 0: make_batched_evaluate pads to a mesh
        multiple and strips the padding; results must equal the unsharded
        per-row evaluation with no padded-lane leakage (round-3 multichip
        validation ask)."""
        from jax.sharding import Mesh

        from phoskintime_tpu.network.optimize import make_batched_evaluate

        topo, Kmat = small_net()
        sys = GlobalSystem(topo, GRID, Kmat)
        df_p, df_r, df_ph = self._data(topo)
        grid = np.unique(np.concatenate([GRID, RNA_GRID]))
        ld = prepare_loss_data(topo, df_p, df_r, df_ph, grid)
        defaults = default_params(topo)
        bounds = calculate_bio_bounds(topo, df_p, df_r, Kmat)
        theta0, slices, xl, xu = init_raw_params(defaults, topo, bounds)
        lambdas = {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.1}
        obj = make_objective(sys, slices, ld, defaults, lambdas, grid)

        mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("pop",))
        evaluate = make_batched_evaluate(obj, mesh=mesh)
        rng = np.random.default_rng(2)
        for P in (13, 8 * 2 + 5):  # neither divisible by 8
            X = theta0[None] + 0.1 * rng.normal(size=(P, len(theta0)))
            F = evaluate(X)
            assert F.shape == (P, 3) and np.all(np.isfinite(F))
            F_ref = np.asarray(evaluate_population(obj, jnp.asarray(X)))
            np.testing.assert_allclose(F, F_ref, rtol=1e-9)

    def test_unpack_roundtrip(self):
        topo, Kmat = small_net()
        defaults = default_params(topo)
        rng = np.random.default_rng(3)
        defaults["Dp_i"] = rng.uniform(0.2, 3.0, defaults["Dp_i"].shape) * topo.site_mask()
        theta0, slices, xl, xu = init_raw_params(
            defaults, topo, {"c_k": (1e-3, 4.0), "A_i": (1e-6, 10.0),
                             "B_i": (1e-3, 1.0), "C_i": (1e-3, 2.0),
                             "D_i": (0.1, 0.5), "Dp_i": (0.05, 5.0),
                             "E_i": (1e-4, 10.0), "tf_scale": (2.0, 10.0)})
        p = unpack_params(jnp.asarray(theta0), slices, topo)
        np.testing.assert_allclose(np.asarray(p["A_i"]), defaults["A_i"], rtol=1e-9)
        np.testing.assert_allclose(np.asarray(p["Dp_i"]), defaults["Dp_i"],
                                   rtol=1e-9, atol=1e-12)
        assert float(p["tf_scale"]) == pytest.approx(1.0, rel=1e-9)
        assert np.all(xl < xu)

    def test_simulate_and_measure_frames(self):
        topo, Kmat = small_net()
        sys = GlobalSystem(topo, GRID, Kmat)
        params = {k: jnp.asarray(v) for k, v in default_params(topo).items()}
        df_p, df_r, df_ph = simulate_and_measure(sys, params, GRID, RNA_GRID, GRID)
        assert set(df_p.columns) == {"protein", "time", "pred_fc"}
        assert len(df_p) == topo.N * len(GRID)
        assert len(df_r) == topo.N * len(RNA_GRID)
        assert (df_ph.groupby("protein").size() > 0).all()

    def test_y0_from_data_mass_balance(self):
        topo, Kmat = small_net()
        df_p = pd.DataFrame({"protein": ["GA"], "time": [0.0], "fc": [2.0]})
        df_r = pd.DataFrame({"protein": ["GA"], "time": [4.0], "fc": [1.5]})
        df_ph = pd.DataFrame({"protein": ["GA", "GA"], "psite": ["S10", "T20"],
                              "time": [0.0, 0.0], "fc": [5.0, 5.0]})
        Y = build_y0_from_data(topo, df_p, df_r, df_ph)
        i = topo.p2i["GA"]
        assert Y[i, 0] == pytest.approx(1.5)
        # site mass capped at 30% of P_tot, P0 by conservation
        site_mass = Y[i, 2:4].sum()
        assert site_mass <= 0.3 * 2.0 + 1e-9
        assert Y[i, 1] == pytest.approx(2.0 - site_mass, rel=1e-9)


class TestSoftplus:
    def test_softplus_stable(self):
        x = jnp.asarray([-50.0, 0.0, 25.0, 700.0])
        y = np.asarray(softplus(x))
        assert np.all(np.isfinite(y))
        assert y[3] == pytest.approx(700.0)


@pytest.mark.slow
class TestShardedExpoObjective:
    def test_population_objective_sharded_matches(self):
        """The ETD2RK batched objective partitions over the mesh population
        axis and matches the unsharded result."""
        from jax.sharding import Mesh
        from phoskintime_tpu.network.objective import (
            evaluate_population,
            make_population_objective,
        )

        topo, Kmat = small_net()
        sys = GlobalSystem(topo, GRID, Kmat)
        rng = np.random.default_rng(0)
        rows_p, rows_r, rows_ph = [], [], []
        for p in topo.proteins:
            for t in GRID:
                rows_p.append((p, t, rng.uniform(0.5, 2.0)))
            for t in RNA_GRID:
                rows_r.append((p, t, rng.uniform(0.5, 2.0)))
            for s in topo.sites[topo.p2i[p]]:
                for t in GRID:
                    rows_ph.append((p, s, t, rng.uniform(0.5, 2.0)))
        df_p = pd.DataFrame(rows_p, columns=["protein", "time", "fc"])
        df_r = pd.DataFrame(rows_r, columns=["protein", "time", "fc"])
        df_ph = pd.DataFrame(rows_ph, columns=["protein", "psite", "time", "fc"])
        grid = np.unique(np.concatenate([GRID, RNA_GRID]))
        ld = prepare_loss_data(topo, df_p, df_r, df_ph, grid)
        defaults = default_params(topo)
        bounds = {k: (1e-3, 4.0) for k in
                  ["c_k", "A_i", "B_i", "C_i", "D_i", "Dp_i", "E_i",
                   "tf_scale"]}
        theta0, slices, xl, xu = init_raw_params(defaults, topo, bounds)
        lambdas = {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.1}
        obj = make_population_objective(sys, slices, ld, defaults, lambdas,
                                        grid)

        pop = jnp.asarray(theta0[None] + 0.1 * rng.normal(size=(16, len(theta0))))
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("pop",))
        F_sharded = np.asarray(evaluate_population(obj, pop, mesh=mesh))
        F_local = np.asarray(evaluate_population(obj, pop))
        assert F_sharded.shape == (16, 3)
        assert np.all(np.isfinite(F_sharded))
        np.testing.assert_allclose(F_sharded, F_local, rtol=1e-6)

    def test_population_objective_chunked_matches(self):
        """pop_chunk splits oversized populations into a lax.map over
        equal chunks (the pop>=16k HBM-spill fix) — bitwise-equal F."""
        from phoskintime_tpu.network.objective import make_population_objective

        topo, Kmat = small_net()
        sys = GlobalSystem(topo, GRID, Kmat)
        rng = np.random.default_rng(1)
        rows_p = [(p, t, rng.uniform(0.5, 2.0))
                  for p in topo.proteins for t in GRID]
        rows_r = [(p, t, rng.uniform(0.5, 2.0))
                  for p in topo.proteins for t in RNA_GRID]
        rows_ph = [(p, s, t, rng.uniform(0.5, 2.0))
                   for p in topo.proteins
                   for s in topo.sites[topo.p2i[p]] for t in GRID]
        df_p = pd.DataFrame(rows_p, columns=["protein", "time", "fc"])
        df_r = pd.DataFrame(rows_r, columns=["protein", "time", "fc"])
        df_ph = pd.DataFrame(rows_ph,
                             columns=["protein", "psite", "time", "fc"])
        grid = np.unique(np.concatenate([GRID, RNA_GRID]))
        ld = prepare_loss_data(topo, df_p, df_r, df_ph, grid)
        defaults = default_params(topo)
        bounds = {k: (1e-3, 4.0) for k in
                  ["c_k", "A_i", "B_i", "C_i", "D_i", "Dp_i", "E_i",
                   "tf_scale"]}
        theta0, slices, xl, xu = init_raw_params(defaults, topo, bounds)
        lambdas = {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.1}
        obj_full = make_population_objective(sys, slices, ld, defaults,
                                             lambdas, grid, pop_chunk=None)
        obj_chunk = make_population_objective(sys, slices, ld, defaults,
                                              lambdas, grid, pop_chunk=4)
        pop = jnp.asarray(theta0[None]
                          + 0.1 * rng.normal(size=(12, len(theta0))))
        F_full = np.asarray(obj_full(pop))
        F_chunk = np.asarray(obj_chunk(pop))          # 12 = 3 chunks of 4
        np.testing.assert_allclose(F_chunk, F_full, rtol=1e-6, atol=1e-8)
        # indivisible pop pads to the chunk size (edge rows) and slices
        # back — chunking must NOT silently deactivate (HBM-spill fix)
        pop13 = jnp.concatenate([pop, pop[:1]])
        F13 = np.asarray(obj_chunk(pop13))
        np.testing.assert_allclose(F13[:12], F_full, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(F13[12], F_full[0], rtol=1e-6, atol=1e-8)


class TestAutoPopChunk:
    def test_lane_budget_rule(self):
        """auto pop_chunk = pow2 chunk holding ~80k ODE lanes, clamped
        to [256, 8192] (N=40 -> 2048, N=150 -> 512; untuned for the H100)."""
        from phoskintime_tpu.network.objective import _auto_pop_chunk

        assert _auto_pop_chunk(40) == 2048
        assert _auto_pop_chunk(150) == 512
        assert _auto_pop_chunk(1) == 8192          # upper clamp
        assert _auto_pop_chunk(100_000) == 256     # lower clamp
