"""Benchmark: batched full-network stiff ODE objective evaluations on a GPU.

Prints the device it runs on, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...}.

Metric: global-model objective evaluations per second (one evaluation =
softplus unpack -> full-network stiff integration over the union grid
(bucketed ETD2RK exponential integrator, the production fit path) ->
3-modality robust loss) at population batch 8192 on a 40-protein synthetic
network mirroring the reference's data scale.

Baseline: the reference evaluates candidates with SciPy LSODA + Numba-style
ragged RHS, one process per candidate on 80 CPU cores
(``config.toml:278``, ``global_model/runner.py:643-648``). The single-core
SciPy rate for the SAME network/equations is PINNED (measured once on an
idle machine; live measurement swung vs_baseline by 50% with CPU load) and
scaled by 80; vs_baseline = device_rate / (80 * SCIPY_1CORE_EVALS_PER_S).
The live rate is still measured and emitted as ``scipy_live_evals_per_s``.

Timing: every time is the host clock around warmed calls that end in
``jax.block_until_ready`` (median of several). Each run checks that clock
on the objective against a forced host fetch of the result and against
calls dispatched back to back (``timing_check_ms``, :func:`sync_check`).

The bench needs a GPU: it fails, and prints no result, anywhere else.
"""

import json
import subprocess
import time

import numpy as np

POP = 8192
N_PROTEINS = 40
N_KINASES = 12

# Pinned single-core SciPy LSODA rate for THIS bench problem (evals/s).
# Provenance: median of 5 runs of scipy_single_core_rate() on an idle x86
# host, 2026-08-17: samples [0.311, 0.291, 0.253, 0.276, 0.338] -> median
# 0.291. Re-pin only with an idle-machine median and update this line.
SCIPY_1CORE_EVALS_PER_S = 0.291

# Published peaks by ``device_kind``. Source: NVIDIA H100 data sheet, SXM
# part, dense rates without sparsity, at the 700 W power limit (as quoted
# in the on-chip measurement notes, section 4). A device that is not in
# the table is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,          # float32 outside the tensor cores
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)",
    },
}


def device_peaks(kind: str) -> dict:
    """Peak rates of the device named ``kind`` (``jax.Device.device_kind``);
    KeyError for a device the table does not know."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add it to bench.PEAKS with its source")
    return PEAKS[kind]


def card_info() -> str:
    """``name, power.limit`` of the card from nvidia-smi (off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def device_record() -> dict:
    """Platform, kind and count of the JAX devices; SystemExit off-GPU."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {d.platform!r}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def time_call(f, *args, n=5):
    """Median seconds of warmed ``f(*args)`` calls, each ended by
    ``jax.block_until_ready``."""
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def sync_check(f, *args, n=10, k=20):
    """Three clocks on warmed ``f(*args)`` calls, in ms: each call ended
    by ``block_until_ready`` (median), each ended by copying the whole
    result to the host (median and every sample), and ``k`` calls
    dispatched back to back with one host copy at the end (per call).
    The last needs no trust in ``block_until_ready``: if it returned
    before the device finished, the first would undercut the other two."""
    import jax

    jax.block_until_ready(f(*args))
    bur = time_call(f, *args, n=n)
    fetch = []
    for _ in range(n):
        t0 = time.perf_counter()
        np.asarray(f(*args))
        fetch.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(k):
        out = f(*args)
    np.asarray(out)
    chain = (time.perf_counter() - t0) / k
    return {"block_until_ready_ms": bur * 1e3,
            "host_fetch_ms": float(np.median(fetch)) * 1e3,
            "host_fetch_samples_ms": [t * 1e3 for t in fetch],
            "chained_ms": chain * 1e3}


def bench_network(n_proteins=N_PROTEINS, n_kinases=N_KINASES, seed=0,
                  model=0, dtype=np.float32):
    from phoskintime_tpu.demo import build_demo_network

    return build_demo_network(n_proteins=n_proteins, n_kinases=n_kinases,
                              seed=seed, model=model, dtype=dtype)


def perturbed_thetas(b, pop, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return jnp.asarray(b["theta0"][None] + 0.05 * rng.normal(
        size=(pop, len(b["theta0"]))), jnp.float32)


def device_rate(b, peaks):
    import jax

    from phoskintime_tpu.network.objective import make_population_objective

    objective = make_population_objective(
        b["system"], b["slices"], b["loss_data"], b["defaults"],
        b["lambdas"], b["grid"])
    thetas = perturbed_thetas(b, POP)
    f = jax.jit(objective)
    F = f(thetas)
    assert bool(np.all(np.isfinite(np.asarray(F)))), "non-finite objectives"
    ca = f.lower(thetas).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    sync = sync_check(f, thetas)
    t_call = sync["block_until_ready_ms"] / 1e3
    rate = POP / t_call
    bytes_per_call = float(ca.get("bytes accessed", 0.0))
    return rate, {
        "objective_ms": round(t_call * 1e3, 3),
        "timing_check_ms": {k: round(v, 4) for k, v in sync.items()
                            if k != "host_fetch_samples_ms"},
        # XLA's own count; it does not see inside the table kernel
        "hbm_bw_util": round(bytes_per_call / t_call
                             / peaks["hbm_bytes_per_s"], 4),
        "flops_per_eval": round(float(ca.get("flops", 0.0)) / POP),
        "bytes_per_eval": round(bytes_per_call / POP),
    }


def table_inputs(b, pop):
    """Inputs of the bench objective's propagator-table build at ``pop``:
    (L (Bu, w, w, pop*N) f32 lane blocks, bucket_inv (U,), u_h (U,))."""
    import jax
    import jax.numpy as jnp

    from phoskintime_tpu.network import expo as X
    from phoskintime_tpu.network.params import unpack_params

    system = b["system"]
    plan = X._segment_plan(tuple(np.asarray(system.kin_grid, float)),
                           tuple(np.asarray(b["grid"], float)), 16.0)
    u_jb, u_h = plan[5], plan[6]
    bucket_uniq, bucket_inv = np.unique(u_jb, return_inverse=True)
    params_b = jax.jit(jax.vmap(lambda t: unpack_params(
        t, b["slices"], system.topo)))(perturbed_thetas(b, pop))
    L = jax.jit(lambda pb: X._linear_blocks_lanes(
        system, pb, bucket_uniq, jnp.float32))(params_b)
    return L, bucket_inv, u_h


def stage_decomp(b, pop=2048):
    """Stage cut of the objective at ``pop``: the propagator-table build
    as production routes it (:func:`expo.propagator_tables`), and the
    whole objective."""
    import jax
    import jax.numpy as jnp

    from phoskintime_tpu.network import expo as X
    from phoskintime_tpu.network.objective import make_population_objective

    L, bucket_inv, u_h = table_inputs(b, pop)
    build = jax.jit(lambda L: X.propagator_tables(L, bucket_inv, u_h))
    t_tables = time_call(build, L)
    obj = jax.jit(make_population_objective(
        b["system"], b["slices"], b["loss_data"], b["defaults"],
        b["lambdas"], b["grid"], pop_chunk=None))
    t_obj = time_call(obj, perturbed_thetas(b, pop))
    return {"pop": pop,
            "table_route": X._table_route(jnp.float32, L.shape[1], False),
            "objective_ms": round(t_obj * 1e3, 3),
            "table_build_ms": round(t_tables * 1e3, 3)}


def scipy_single_core_rate(b):
    """Reference-style LSODA evaluation of the same network (ragged loops).
    Returns (evals/s, tight-tolerance trajectory for the accuracy gate)."""
    from scipy.integrate import odeint

    topo = b["system"].topo
    Kmat = np.asarray(b["system"].Kmat, float)
    grid = np.asarray(b["system"].kin_grid, float)
    p = {k: np.asarray(v, float) for k, v in b["true"].items()}
    times = np.asarray(b["grid"], float)
    Y0 = b["system"].y0().astype(float)
    N, width = Y0.shape
    msk = topo.site_mask()

    def rhs_flat(y, t):
        Y = y.reshape(N, width)
        jb = min(max(int(np.searchsorted(grid, t, side="right") - 1), 0),
                 Kmat.shape[1] - 1)
        Kt = Kmat[:, jb] * p["c_k"]
        S = np.einsum("nsk,k->ns", topo.W_pad, Kt)
        P_vec = Y[:, 1] + (Y[:, 2:] * msk).sum(axis=1)
        drv = topo.driver_map >= 0
        P_vec[drv] = Kt[topo.driver_map[drv]]
        v = (topo.tf_mat @ P_vec) / topo.tf_deg
        u = v / (1 + np.abs(v))
        act = p["A_i"] * (1 + (p["tf_scale"] * u) / (1 + u + 1e-6))
        rep = p["A_i"] / (1 + p["tf_scale"] * np.abs(u))
        synth = np.where(u >= 0, act, rep)
        dY = np.zeros_like(Y)
        dY[:, 0] = synth - p["B_i"] * Y[:, 0]
        sites = Y[:, 2:] * msk
        Sm = S * msk
        dY[:, 2:] = (Sm * Y[:, 1:2]
                     - (p["E_i"][:, None] + p["Dp_i"] + p["D_i"][:, None]) * sites) * msk
        dY[:, 1] = (p["C_i"] * Y[:, 0] - (p["D_i"] + Sm.sum(1)) * Y[:, 1]
                    + p["E_i"] * sites.sum(1))
        return dY.reshape(-1)

    n_solves = 3
    t0 = time.perf_counter()
    for _ in range(n_solves):
        odeint(rhs_flat, Y0.reshape(-1), times, rtol=1e-5, atol=1e-7,
               mxstep=5000)
    dt = time.perf_counter() - t0
    # separate TIGHT solve for the accuracy gate: at rtol 1e-5 most of the
    # measured gate would be the oracle's own discretization error
    Y_tight = odeint(rhs_flat, Y0.reshape(-1), times, rtol=1e-7,
                     atol=1e-9, mxstep=20000)
    return n_solves / dt, Y_tight


def fold_change_error(b, ys0, Y_ref):
    """Max relative error over every observable fold-change (mRNA, total
    protein, per-site phospho) of trajectory ``ys0`` against ``Y_ref``."""
    import jax.numpy as jnp

    from phoskintime_tpu.network.simulate import (extract_observables,
                                                  fold_changes)

    system = b["system"]
    times = jnp.asarray(np.asarray(b["grid"], float))
    msk = np.asarray(system.topo.site_mask(), bool)

    def fcs(Y_flat):
        obs = extract_observables(system, jnp.asarray(Y_flat))
        fc_r, fc_p, fc_pho = fold_changes(obs, times)
        return (np.asarray(fc_r, float), np.asarray(fc_p, float),
                np.asarray(fc_pho, float)[:, msk])

    return float(max(np.max(np.abs(a - o) / np.maximum(np.abs(o), 1e-6))
                     for a, o in zip(fcs(ys0), fcs(Y_ref))))


def accuracy_vs_lsoda(b, Y_lsoda):
    """Accuracy gate: production ETD2RK fold-changes vs the LSODA oracle,
    through the BATCHED path (P=1) the throughput metric runs, at the true
    parameters and the production dtype."""
    import jax.numpy as jnp

    from phoskintime_tpu.network.expo import exponential_simulate_batched

    p_b = {k: jnp.asarray(v, jnp.float32)[None] for k, v in b["true"].items()}
    ys, success = exponential_simulate_batched(b["system"], p_b,
                                               np.asarray(b["grid"], float))
    assert bool(success[0]), "ETD2RK reported failure at true params"
    return fold_change_error(b, ys[0], Y_lsoda)


def northstar_10k_ensemble():
    """North-star arm (BASELINE.md): full-network fit, 10k-member
    ensemble, ENTIRE generation loop on device, 100 generations at
    reference parameter scale (n_var ~1.1k); the baseline comparison is
    ONE reference fit (pop 300 x 1000 gens = 3e5 LSODA solves on the
    80-core pool at the pinned SciPy rate). Reference anchors:
    ``config.toml:296-297``, ``global_model/runner.py:663-702``.
    """
    from phoskintime_tpu.network.optimize import run_global_fit

    b10 = bench_network(150, 24, seed=1)
    t0 = time.perf_counter()
    res = run_global_fit(b10["system"], b10["slices"], b10["loss_data"],
                         b10["defaults"], b10["lambdas"], b10["grid"],
                         b10["xl"], b10["xu"], pop=10_000, n_gen=100,
                         seed=0, ftol=0.0, ftol_period=10_000,
                         n_max_evals=None, frechet_pick=False,
                         gens_per_dispatch=10)
    wall = time.perf_counter() - t0
    ref_one_fit_s = 3e5 / (80.0 * SCIPY_1CORE_EVALS_PER_S)
    return {
        "wall_s": round(wall, 3),
        "gens": len(res.history),
        "pop": 10_000,
        "evals_per_s": round(res.n_evals / wall, 1),
        "ideal": [round(float(v), 4) for v in res.F.min(axis=0)],
        # the north-star clause: 10k-member ensemble fit in less
        # wall-clock than ONE reference multi-start fit on 80 CPU cores
        "vs_one_ref_fit": round(ref_one_fit_s / wall, 1),
    }


def main():
    from phoskintime_tpu.parallel.profile import enable_compilation_cache

    device = device_record()
    peaks = device_peaks(device["kind"])
    card = card_info()
    print(f"device: {device} | card: {card}", flush=True)
    enable_compilation_cache()

    b = bench_network()
    rate, extras = device_rate(b, peaks)
    decomp = stage_decomp(b)
    cpu_rate, Y_lsoda = scipy_single_core_rate(b)
    acc = accuracy_vs_lsoda(b, Y_lsoda)
    assert acc < 1e-3, f"ETD2RK drifted from the LSODA oracle: {acc:.2e}"
    ns10k = northstar_10k_ensemble()
    baseline = 80.0 * SCIPY_1CORE_EVALS_PER_S  # reference: 80-core pool
    print(json.dumps({
        "metric": "global_model_objective_evals_per_s",
        "value": round(rate, 2),
        "unit": "evals/s (pop=8192, N=40 proteins, ETD2RK + 3-mod loss)",
        "vs_baseline": round(rate / baseline, 3),
        "accuracy_rel_err": round(acc, 6),
        "scipy_live_evals_per_s": round(cpu_rate, 4),
        "northstar_10k_ensemble": ns10k,
        "stage_decomp": decomp,
        "device": device,
        "card": card,
        **extras,
    }))


if __name__ == "__main__":
    main()
