"""Propagator-table kernel (interpret mode on CPU, compiled on a GPU), its
routing rule, and the tridiagonal solve that steady state relies on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phoskintime_tpu.ops.tridiag import thomas_solve_batched


class TestThomasSolve:
    """``thomas_solve_batched`` against a dense solve of the same systems."""

    @pytest.mark.parametrize("B,n,seed", [(37, 6, 0), (1, 3, 1)])
    def test_matches_dense_solve(self, B, n, seed):
        rng = np.random.default_rng(seed)
        a = rng.normal(0, 1, (B, n)); a[:, 0] = 0
        c = rng.normal(0, 1, (B, n)); c[:, -1] = 0
        b = np.abs(rng.normal(0, 1, (B, n))) + 4.0
        d = rng.normal(0, 1, (B, n))
        got = thomas_solve_batched(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c), jnp.asarray(d))
        for k in range(B):
            A = (np.diag(b[k]) + np.diag(a[k, 1:], -1)
                 + np.diag(c[k, :-1], 1))
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.linalg.solve(A, d[k]),
                                       rtol=1e-10, atol=1e-12)


def _blocks(Bu, w, B, seed, scale=0.5, rate=20.0):
    rng = np.random.default_rng(seed)
    L = rng.normal(0, scale, (Bu, w, w, B)).astype(np.float32)
    for i in range(w):
        L[:, i, i, :] = -rng.uniform(0.01, rate, (Bu, B))
    return jnp.asarray(L)


def _rel_close(a, b, tol):
    scale = float(jnp.max(jnp.abs(b))) + 1e-30
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               atol=tol)


class TestPhiTablesKernel:
    """Triton-route table kernel (ops/phi_pallas.py) against the XLA ladder
    it replaces, in the Pallas interpreter."""

    @pytest.mark.parametrize("h", [0.0625, 1.0, 16.0])
    def test_matches_xla_ladder(self, h):
        from phoskintime_tpu.network.expo import _phi_vectors_lanes
        from phoskintime_tpu.ops.phi_pallas import phi_vectors_pallas

        w, B = 6, 77                   # 77 lanes: a masked tail at blk 32
        L = _blocks(1, w, B, seed=0)
        E, p1, p2 = phi_vectors_pallas(L, np.asarray([0], np.int32),
                                       np.asarray([h], np.float32),
                                       blk=32, interpret=True)
        assert E.shape == (1, w, w, B) and p1.shape == (1, w, B)
        ref = _phi_vectors_lanes(L[0], jnp.broadcast_to(jnp.float32(h), (B,)))
        for a, b in zip((E[0], p1[0], p2[0]), ref):
            _rel_close(a, b, 2e-5)

    def test_pairs_load_their_own_bucket(self):
        """All (bucket, h) pairs in one call: pair u reads slab binv[u]."""
        from phoskintime_tpu.network.expo import _phi_vectors_lanes
        from phoskintime_tpu.ops.phi_pallas import phi_vectors_pallas

        w, B = 4, 40
        L = _blocks(3, w, B, seed=3, rate=5.0)
        binv = np.asarray([2, 0, 1], np.int32)
        h_u = np.asarray([0.5, 4.0, 2.0], np.float32)
        E, p1, p2 = phi_vectors_pallas(L, binv, h_u, blk=64, interpret=True)
        for u in range(3):
            ref = _phi_vectors_lanes(
                L[binv[u]], jnp.broadcast_to(jnp.float32(h_u[u]), (B,)))
            for a, b in zip((E[u], p1[u], p2[u]), ref):
                _rel_close(a, b, 2e-5)

    def test_identity_at_zero_rates(self):
        from phoskintime_tpu.ops.phi_pallas import phi_vectors_pallas

        w, B = 6, 32
        L = jnp.zeros((1, w, w, B), jnp.float32)
        E, p1, p2 = phi_vectors_pallas(L, np.asarray([0], np.int32),
                                       np.asarray([2.0], np.float32),
                                       blk=32, interpret=True)
        np.testing.assert_allclose(
            np.asarray(E[0]), np.broadcast_to(np.eye(w)[..., None], (w, w, B)),
            atol=1e-6)
        # phi1(0) = I -> p1 = h e0; phi2(0) = I/2 -> p2 = h^2/2 e0
        np.testing.assert_allclose(np.asarray(p1[0, 0]), 2.0, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(p2[0, 0]), 2.0, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(p1[0, 1:]), 0.0, atol=1e-9)

    def test_block_must_be_power_of_two(self):
        from phoskintime_tpu.ops.phi_pallas import phi_vectors_pallas

        L = jnp.zeros((1, 2, 2, 8), jnp.float32)
        with pytest.raises(ValueError, match="power of two"):
            phi_vectors_pallas(L, np.asarray([0], np.int32),
                               np.asarray([1.0], np.float32), blk=48,
                               interpret=True)

    @pytest.mark.gpu
    def test_compiled_matches_xla_on_gpu(self, gpu_device):
        """The compiled kernel on the card, at a real width, against the
        f64 XLA ladder on the same card."""
        from phoskintime_tpu.network.expo import _phi_vectors_lanes
        from phoskintime_tpu.ops.phi_pallas import phi_vectors_pallas

        w, B = 6, 5000
        L = jax.device_put(_blocks(2, w, B, seed=7), gpu_device)
        binv = np.asarray([0, 1], np.int32)
        h_u = np.asarray([0.25, 16.0], np.float32)
        E, p1, p2 = phi_vectors_pallas(L, binv, h_u)
        for u in range(2):
            ref = _phi_vectors_lanes(
                L[binv[u]].astype(jnp.float64)
                if jax.config.jax_enable_x64 else L[binv[u]],
                jnp.full((B,), h_u[u], L.dtype))
            for a, b in zip((E[u], p1[u], p2[u]), ref):
                _rel_close(a, b, 1e-4)


class TestTableRoute:
    """Which table build a trace takes (network/expo.py:_table_route)."""

    @pytest.mark.parametrize("dtype,width,diff,backend,want", [
        (jnp.float32, 6, False, "gpu", "pallas"),
        (jnp.float32, 6, False, "cpu", "xla"),
        (jnp.float64, 6, False, "gpu", "xla"),
        (jnp.float32, 6, True, "gpu", "xla"),
        (jnp.float32, 17, False, "gpu", "xla"),
    ])
    def test_rule(self, dtype, width, diff, backend, want):
        from phoskintime_tpu.network.expo import _table_route

        assert _table_route(dtype, width, diff, backend=backend) == want

    def test_sharded_trace_keeps_xla(self):
        """A trace under a mesh (how sharded callers run) takes XLA; the
        same function traced without one takes the kernel route."""
        from jax.sharding import Mesh

        from phoskintime_tpu.network.expo import _table_route
        from phoskintime_tpu.parallel.mesh import sharded_jit

        seen = []

        def f(x):
            seen.append(_table_route(jnp.float32, 6, False, backend="gpu"))
            return x + 1

        mesh = Mesh(np.array(jax.devices()[:2]), ("pop",))
        sharded_jit(f, mesh)(jnp.zeros(4))
        jax.jit(f)(jnp.zeros(4))
        assert seen == ["xla", "pallas"]

    def test_cpu_objective_never_calls_the_kernel(self, monkeypatch):
        """On the CPU the production objective takes the XLA ladder: the
        kernel module is never asked for a table."""
        import phoskintime_tpu.ops.phi_pallas as K
        from test_expo import GRID, make_system

        from phoskintime_tpu.network.expo import exponential_simulate_batched

        def boom(*a, **k):
            raise AssertionError("table kernel called on the CPU")

        monkeypatch.setattr(K, "phi_vectors_pallas", boom)
        sys_, pj = make_system(0)
        pb = {k: jnp.asarray(v)[None] for k, v in pj.items()}
        ys, ok = exponential_simulate_batched(sys_, pb, GRID)
        assert bool(ok.all()) and bool(jnp.all(jnp.isfinite(ys)))


class TestPropagatorTables:
    """``expo.propagator_tables``: the one table build production, the
    bench's stage cut and the smoke run call."""

    def _pairs(self):
        # lane 0 of bucket 0 rotates far past the rate cap, so the short
        # pair's own ladder_len clamps it below the longest pair's (and
        # the clamp changes its tables at O(1))
        L = np.array(_blocks(2, 4, 16, seed=5, rate=3.0))
        L[0, 0, 1, 0], L[0, 1, 0, 0] = 2000.0, -2000.0
        return (jnp.asarray(L, jnp.float64), np.asarray([0, 1, 0], np.int32),
                np.asarray([0.0625, 1.0, 16.0]))

    def test_differentiable_clamps_each_pair_at_its_own_ladder(self):
        from phoskintime_tpu.network.expo import (_phi_vectors_lanes,
                                                  ladder_len,
                                                  propagator_tables)

        L, binv, u_h = self._pairs()
        w, B = L.shape[1], L.shape[-1]
        assert ladder_len(w, u_h[0]) < ladder_len(w, u_h[2])
        got = propagator_tables(L, binv, u_h, differentiable=True)
        for u, h in enumerate(u_h):
            want = _phi_vectors_lanes(L[binv[u]], jnp.full((B,), h),
                                      unroll=ladder_len(w, h))
            for a, b in zip(got, want):
                np.testing.assert_allclose(np.asarray(a[u]), np.asarray(b),
                                           rtol=1e-12, atol=1e-14)

    def test_traced_ladder_per_pair(self):
        from phoskintime_tpu.network.expo import (_phi_vectors_lanes,
                                                  propagator_tables)

        L, binv, u_h = self._pairs()
        B = L.shape[-1]
        E, p1, p2 = propagator_tables(L, binv, u_h)
        assert E.shape == (3, 4, 4, B) and p1.shape == p2.shape == (3, 4, B)
        for u, h in enumerate(u_h):
            want = _phi_vectors_lanes(L[binv[u]], jnp.full((B,), h))
            for a, b in zip((E, p1, p2), want):
                np.testing.assert_allclose(np.asarray(a[u]), np.asarray(b),
                                           rtol=1e-12, atol=1e-14)

    def test_gradient_flows_through_the_differentiable_build(self):
        from phoskintime_tpu.network.expo import propagator_tables

        L, binv, u_h = self._pairs()
        g = jax.grad(lambda L: sum(jnp.sum(t) for t in propagator_tables(
            L, binv, u_h, differentiable=True)))(L)
        assert g.shape == L.shape and bool(jnp.all(jnp.isfinite(g)))

    def test_forced_kernel_route(self, monkeypatch):
        import phoskintime_tpu.ops.phi_pallas as K
        from phoskintime_tpu.network.expo import propagator_tables

        seen = []
        monkeypatch.setattr(K, "phi_vectors_pallas",
                            lambda *a, **k: seen.append(a) or "kernel")
        L, binv, u_h = self._pairs()
        assert propagator_tables(L, binv, u_h, use_pallas=True) == "kernel"
        assert propagator_tables(L, binv, u_h) != "kernel"   # CPU: XLA
        assert len(seen) == 1


class TestWidthClasses:
    """``expo.width_classes``: the combinatorial mechanism's width
    classes, each with its own table build and route."""

    @staticmethod
    def _topo(model, n_sites):
        from types import SimpleNamespace

        n_sites = np.asarray(n_sites)
        w = 1 + 2 ** int(n_sites.max()) if model == 2 else 2 + int(
            n_sites.max())
        return SimpleNamespace(N=len(n_sites), width=w, model=model,
                               n_sites=n_sites)

    def test_classes_cover_every_protein_at_its_width_or_wider(self):
        from phoskintime_tpu.network.expo import width_classes

        n_sites = [1] * 20 + [2] * 12 + [3] * 1 + [4] * 7
        classes = width_classes(self._topo(2, n_sites))
        widths = [wc for wc, _ in classes]
        assert widths == sorted(widths) and len(classes) > 1
        seen = np.concatenate([idx for _, idx in classes])
        assert sorted(seen.tolist()) == list(range(len(n_sites)))
        for wc, idx in classes:
            assert np.all(1 + 2 ** np.asarray(n_sites)[idx] <= wc)

    @pytest.mark.parametrize("model,n_sites,bucketing", [
        (0, [1, 2, 4], None),           # affine mechanisms never bucket
        (2, [4, 4, 4], None),           # one width: nothing to split
        (2, [1, 2, 4], False),          # forced off
    ])
    def test_no_classes(self, model, n_sites, bucketing):
        from phoskintime_tpu.network.expo import width_classes

        assert width_classes(self._topo(model, n_sites), bucketing) == []
