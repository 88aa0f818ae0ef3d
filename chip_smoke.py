"""Smoke run of the global-model fit on one GPU, through its normal entry
points, at the full size of the models the repository supports.

    python chip_smoke.py           # phases a-f on one card
    python chip_smoke.py --four    # phase g only: the sharded 10k ensemble
                                   # on four cards against one card

Phases (one process owns the card; any failure exits non-zero):

  a. device     -- JAX devices, the card's name and power limit, versions
  b. kernel     -- propagator-table kernel vs the f64 XLA ladder on the card
  c. objective  -- pop-8192 objective, LSODA accuracy gate, kernel vs XLA
  d. mechanisms -- models 0/1/2/4 at f32 vs the same program at f64
  e. fit        -- reference-scale device GA, host GA loop, gradient polish
  f. cli        -- ``global-model`` on a seeded project (needs pandas)

Every line names the card. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from bench import card_info, sync_check, time_call

CARD = "card unknown"

# full sizes: the bench network (N = 40) and the reference-scale fit
# (N = 150, ~1.1k free parameters, the 10k-member ensemble)
SIZES = {"kernel_pop": 2048, "objective_pop": 8192, "mechanism_pop": 2048,
         "fit_proteins": 150, "fit_kinases": 24, "fit_pop": 10_000,
         "host_pop": 2048, "cli_pop": 64}

# tolerances, each with its reason (CHANGES.md records the measured values)
# kernel vs f64 ladder, relative to max|ref|: f32 rounding over a ladder
# of up to ~15 squarings
KERNEL_TOL = 1e-4
# accuracy gate against the tight SciPy LSODA oracle (bench.py)
LSODA_TOL = 1e-3
# f32 vs f64 fold-changes of one program on the card
MECH_TOL = 1e-3
# sharded vs one-card first-generation objectives
FOUR_RTOL = 1e-5


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def require_gpu(platform: str) -> None:
    """Exit non-zero unless JAX's first device is a GPU."""
    if platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {platform!r}",
              file=sys.stderr)
        raise SystemExit(2)


@contextlib.contextmanager
def x64():
    """Trace f64 inside the block (the card's native f64 is the plain
    reference here); restores the previous setting."""
    import jax

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def peak_gib(dev) -> float:
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2 ** 30


def rel_err(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-30))


# ---------------------------------------------------------------- phases

def phase_device():
    import jax

    devs = jax.devices()
    d = devs[0]
    say(f"a. devices: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} {devs}")
    say(f"a. jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}"
        f"; JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR')!r}")
    have = {}
    for mod in ("pandas", "matplotlib", "sklearn"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    say(f"a. optional packages importable: {have}")
    return d, have


def phase_kernel(b):
    """Table kernel at the bench plan (w = 6, 81,920 lanes, all pairs)
    against the f64 XLA ladder, both on the card."""
    import jax
    import jax.numpy as jnp

    from bench import table_inputs
    from phoskintime_tpu.network import expo as X

    w = b["topo"].width
    pop = SIZES["kernel_pop"]
    L, binv, u_h = table_inputs(b, pop)
    L = jax.block_until_ready(L)
    say(f"b. L {L.shape} ({L.shape[-1]} lanes = N {b['topo'].N} x pop "
        f"{pop}), {len(u_h)} (bucket, h) pairs, production route "
        f"{X._table_route(jnp.float32, w, False)}")

    def tables(use_pallas):
        return jax.jit(lambda L: X.propagator_tables(L, binv, u_h,
                                                     use_pallas=use_pallas))

    kern, xla_map = tables(True), tables(False)
    binv_j, h_j = jnp.asarray(binv), jnp.asarray(u_h, jnp.float32)
    xla_vmap = jax.jit(lambda L: jax.vmap(lambda s, h: X._phi_vectors_lanes(
        L[s], jnp.broadcast_to(h, (L.shape[-1],))))(binv_j, h_j))

    t0 = time.perf_counter()
    compiled = kern.lower(L).compile()
    say(f"b. kernel compile {time.perf_counter() - t0:.3f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    t_k = time_call(kern, L)
    with x64():
        ref = jax.block_until_ready(tables(False)(L.astype(jnp.float64)))
    names = ("E", "p1", "p2")
    errs = {n: rel_err(a, r) for n, a, r in zip(names, kern(L), ref)}
    errs_xla = {n: rel_err(a, r) for n, a, r in zip(names, xla_map(L), ref)}
    t_map = time_call(xla_map, L)
    t_vmap = time_call(xla_vmap, L)
    say(f"b. kernel vs f64 ladder max|d|/max|ref|: {errs} (tol {KERNEL_TOL});"
        f" XLA f32 ladder vs f64: {errs_xla}")
    say(f"b. table build w={w}: kernel {t_k * 1e3:.4f} ms, XLA lax.map "
        f"{t_map * 1e3:.4f} ms, XLA vmap over pairs {t_vmap * 1e3:.4f} ms")
    assert max(errs.values()) < KERNEL_TOL, errs
    say(f"b. the kernel takes widths <= {X._KERNEL_MAX_WIDTH}: the "
        f"combinatorial mechanism's narrow width classes take it, its "
        f"wider classes (w = 9, 17) keep the XLA ladder (phase d)")
    return {"kernel_ms": t_k * 1e3, "xla_map_ms": t_map * 1e3,
            "xla_vmap_ms": t_vmap * 1e3, "err": errs}


def phase_objective(b, dev):
    """Production objective at pop 8192 (auto pop chunk), with the kernel
    and with the XLA ladder; the timing check; the LSODA accuracy gate."""
    import jax

    from bench import (accuracy_vs_lsoda, perturbed_thetas,
                       scipy_single_core_rate)
    from phoskintime_tpu.network.objective import make_population_objective

    pop = SIZES["objective_pop"]
    thetas = perturbed_thetas(b, pop)
    times, Fs = {}, {}
    for name, use_pallas in (("kernel", None), ("xla", False)):
        f = jax.jit(make_population_objective(
            b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"], use_pallas=use_pallas))
        t0 = time.perf_counter()
        F = np.asarray(f(thetas), np.float64)
        t_first = time.perf_counter() - t0
        assert F.shape == (pop, 3) and bool(np.all(np.isfinite(F))), name
        Fs[name] = F
        chk = sync_check(f, thetas)
        times[name] = chk["block_until_ready_ms"]
        samples = ", ".join(f"{t:.4f}" for t in chk["host_fetch_samples_ms"])
        say(f"c. objective pop {pop} [{name}]: first call {t_first:.3f} s; "
            f"warm {chk['block_until_ready_ms']:.4f} ms (block_until_ready, "
            f"median of 10), {chk['host_fetch_ms']:.4f} ms (host fetch, "
            f"median of 10: {samples}), {chk['chained_ms']:.4f} ms per call "
            f"(20 back to back, one fetch); "
            f"{pop / times[name] * 1e3:.1f} evals/s; "
            f"peak {peak_gib(dev):.3f} GiB")
    dF = float(np.max(np.abs(Fs["kernel"] - Fs["xla"])
                      / np.maximum(np.abs(Fs["xla"]), 1e-30)))
    say(f"c. objective F, kernel route vs XLA route: max rel diff "
        f"{dF:.3e} (tol {KERNEL_TOL})")
    assert dF < KERNEL_TOL, dF
    _, Y_lsoda = scipy_single_core_rate(b)
    acc = accuracy_vs_lsoda(b, Y_lsoda)
    say(f"c. LSODA gate: max rel fold-change error {acc:.3e} "
        f"(limit {LSODA_TOL})")
    assert acc < LSODA_TOL, acc
    return {"kernel_ms": times["kernel"], "xla_ms": times["xla"],
            "lsoda_err": acc}


def phase_mechanisms(dev):
    """Models 0, 1, 2 and 4 at N = 40, pop 2048: f32 against the same
    program in f64 on the card, compared on fold-changes."""
    import jax
    import jax.numpy as jnp

    from bench import bench_network
    from phoskintime_tpu.network.expo import (_table_route,
                                              exponential_simulate_batched,
                                              width_classes)

    pop = SIZES["mechanism_pop"]
    out = {}
    for model in (0, 1, 2, 4):
        b = bench_network(model=model)
        rng = np.random.default_rng(model)
        pb64 = {k: np.asarray(v, np.float64)[None] * rng.uniform(
            0.8, 1.2, (pop,) + np.shape(v)) for k, v in b["true"].items()}
        grid = np.asarray(b["grid"], float)

        def fcs(system, pb):
            run = jax.jit(lambda p: exponential_simulate_batched(
                system, p, grid, return_observables=True))
            t = time_call(run, pb, n=2)
            (R, TOT, PHO), ok = run(pb)
            t_ = jnp.asarray(grid)
            base = lambda x, t0: jnp.maximum(x, 1e-9) / jnp.maximum(
                x[:, jnp.argmin(jnp.abs(t_ - t0))][:, None], 1e-9)
            return t, bool(ok.all()), [np.asarray(base(R, 4.0)),
                                       np.asarray(base(TOT, 0.0)),
                                       np.asarray(base(PHO, 0.0))]

        pb32 = {k: jnp.asarray(v, jnp.float32) for k, v in pb64.items()}
        t32, ok32, f32 = fcs(b["system"], pb32)
        with x64():
            sys64 = b["system"].astype(np.float64)
            t64, ok64, f64 = fcs(sys64, {k: jnp.asarray(v)
                                         for k, v in pb64.items()})
        classes = width_classes(b["topo"]) or [(b["topo"].width, None)]
        routes = ", ".join(f"w={wc} {_table_route(np.float32, wc, False)}"
                           for wc, _ in classes)
        msk = np.asarray(b["topo"].site_mask(), bool)
        f32[2], f64[2] = f32[2][..., msk], f64[2][..., msk]
        err = max(float(np.max(np.abs(a - r) / np.maximum(np.abs(r), 1e-6)))
                  for a, r in zip(f32, f64))
        say(f"d. model {model} (w={b['topo'].width}; f32 table routes: "
            f"{routes}) pop {pop}: f32 "
            f"{t32 * 1e3:.4f} ms, f64 {t64 * 1e3:.4f} ms; max rel "
            f"fold-change error {err:.3e} (tol {MECH_TOL}); ok "
            f"{ok32}/{ok64}; peak {peak_gib(dev):.3f} GiB")
        assert ok32 and ok64 and err < MECH_TOL, (model, err)
        out[model] = err
    return out


def _monotone(ideals) -> bool:
    ideals = np.asarray(ideals, float)
    return bool(np.all(np.diff(ideals, axis=0) <= 1e-6 * (
        1.0 + np.abs(ideals[:-1]))))


def phase_fit(dev):
    """run_global_fit at reference scale on the device GA, the host GA
    loop (the user's default), and a few gradient-polish steps."""
    import jax
    import jax.numpy as jnp

    from bench import bench_network
    from phoskintime_tpu.network.objective import make_population_objective
    from phoskintime_tpu.network.optimize import run_global_fit
    from phoskintime_tpu.network.polish import polish_solutions

    b = bench_network(SIZES["fit_proteins"], SIZES["fit_kinases"], seed=1)
    n_var = len(b["theta0"])
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"], b["xl"], b["xu"])
    pop = SIZES["fit_pop"]
    t0 = time.perf_counter()
    res = run_global_fit(*args, pop=pop, n_gen=4, seed=0, ftol=0.0,
                         n_max_evals=None, frechet_pick=False,
                         gens_per_dispatch=2)
    wall = time.perf_counter() - t0
    ideals = [h[1] for h in res.history]
    assert np.all(np.isfinite(res.F)) and _monotone(ideals), ideals
    say(f"e. device GA N={b['topo'].N} n_var={n_var} pop {pop} x "
        f"{len(ideals)} gens "
        f"(2/dispatch): {wall:.3f} s incl. compile; ideal "
        f"{np.round(ideals[-1], 5).tolist()}; peak {peak_gib(dev):.3f} GiB")

    t0 = time.perf_counter()
    res_h = run_global_fit(*args, pop=SIZES["host_pop"], n_gen=2, seed=0,
                           ftol=0.0,
                           n_max_evals=None, frechet_pick=False,
                           gens_per_dispatch=1)
    wall_h = time.perf_counter() - t0
    ideals_h = [h[1] for h in res_h.history]
    assert np.all(np.isfinite(res_h.F)) and _monotone(ideals_h), ideals_h
    say(f"e. host GA loop pop {SIZES['host_pop']} x {len(ideals_h)} gens: "
        f"{wall_h:.3f} s "
        f"incl. compile; ideal {np.round(ideals_h[-1], 5).tolist()}")

    X0 = res.pareto_X[:8]
    F0 = res.pareto_F[:8]
    # one polish step alone: the forward + reverse sweep of the
    # differentiable objective (static-length ladder) over 8 members
    obj_d = make_population_objective(*args[:6], differentiable=True)
    step = jax.jit(jax.value_and_grad(lambda X: jnp.sum(obj_d(X))))
    X0j = jnp.asarray(X0, jnp.float32)
    t0 = time.perf_counter()
    jax.block_until_ready(step(X0j))
    t_step_c = time.perf_counter() - t0
    t_step = time_call(step, X0j)
    say(f"e. polish step (value and gradient, 8 members): first call "
        f"{t_step_c:.3f} s; warm {t_step * 1e3:.4f} ms")
    t0 = time.perf_counter()
    pX, pF = polish_solutions(*args[:6], X0, b["xl"], b["xu"], steps=5,
                              chunk=8)
    wall_p = time.perf_counter() - t0
    assert np.all(np.isfinite(pF))
    say(f"e. gradient polish 8 members x 5 Adam steps: {wall_p:.3f} s incl."
        f" compile; sum F {float(F0.sum(1).min()):.5f} -> "
        f"{float(pF.sum(1).min()):.5f}")
    return {"device_ga_s": wall, "host_ga_s": wall_h, "polish_s": wall_p,
            "polish_step_ms": t_step * 1e3}


CONFIG = """
[paths]
data_dir = "data"
results_dir = "results"
logs_dir = "results/logs"

[global_model]
kinase_net = "data/input2.csv"
tf_net = "data/input4.csv"
ms = "data/input1.csv"
rna = "data/input3.csv"
output_dir = "results_global"
optimizer = "pymoo"
pop = {pop}
n_gen = 4
seed = 42
sensitivity_analysis = false
"""


def phase_cli():
    """``global-model`` through the CLI entry point, in process, on a
    project written from a seed into the checkout's chiprun_out/."""
    import pandas as pd

    from phoskintime_tpu.cli import main as cli_main

    root = os.path.abspath(os.path.join("chiprun_out", "smoke_project"))
    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    with open(os.path.join(root, "config.toml"), "w") as fh:
        fh.write(CONFIG.format(pop=SIZES["cli_pop"]))
    rng = np.random.default_rng(0)
    genes = [f"G{i:02d}" for i in range(12)] + ["KIN1", "KIN2"]

    def wide(gs, psites, n):
        d = {"GeneID": gs}
        if psites is not None:
            d["Psite"] = psites
        for i in range(1, n + 1):
            d[f"x{i}"] = rng.uniform(0.5, 2.0, len(gs))
        return pd.DataFrame(d)

    ms_g, ms_p, ks = [], [], []
    for g in genes:
        ms_g.append(g)
        ms_p.append("")
        for s in range(int(rng.integers(1, 4))):
            ms_g.append(g)
            ms_p.append(f"S_{10 * (s + 1)}")
            ks.append((g, f"S_{10 * (s + 1)}",
                       "{" + ("KIN1" if rng.random() < 0.5 else "KIN2") + "}"))
    wide(ms_g, ms_p, 14).to_csv(os.path.join(data, "input1.csv"), index=False)
    pd.DataFrame(ks, columns=["GeneID", "Psite", "Kinase"]).to_csv(
        os.path.join(data, "input2.csv"), index=False)
    wide(genes, None, 9).to_csv(os.path.join(data, "input3.csv"), index=False)
    pd.DataFrame({"Source": genes[:4], "Target": genes[4:8]}).to_csv(
        os.path.join(data, "input4.csv"), index=False)

    cwd = os.getcwd()
    os.chdir(root)
    t0 = time.perf_counter()
    try:
        cli_main(["global-model"])
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    pX = np.load(os.path.join(root, "results_global", "pareto_X.npy"))
    assert pX.ndim == 2 and np.all(np.isfinite(pX))
    say(f"f. cli global-model ({len(genes)} genes, pop {SIZES['cli_pop']} "
        f"x 4 gens): "
        f"{wall:.3f} s incl. compile; {len(pX)} Pareto members")
    return {"cli_s": wall}


def phase_four():
    """The 10k ensemble (N = 150, pop 10,000) through run_unsga3_device
    over a 1-D population mesh on four cards, against the same seed on one
    card: first-generation objectives and wall time per generation.

    Sharded traces take the XLA table build (expo._table_route) and the
    one-card run the kernel; phase c bounds that route difference in F
    (3.9e-7 relative at pop 8192 on an H100), well inside FOUR_RTOL."""
    import jax

    from bench import bench_network
    from phoskintime_tpu.network.objective import (evaluate_population,
                                                   make_population_objective)
    from phoskintime_tpu.ops.nsga import lhs_sampling
    from phoskintime_tpu.ops.nsga_device import (make_device_ga_blocks,
                                                 run_unsga3_device)
    from phoskintime_tpu.parallel.mesh import population_mesh

    mesh = population_mesh(4)
    assert mesh is not None and mesh.size == 4, jax.devices()
    b = bench_network(SIZES["fit_proteins"], SIZES["fit_kinases"], seed=1)
    obj = make_population_objective(
        b["system"], b["slices"], b["loss_data"], b["defaults"],
        b["lambdas"], b["grid"])
    xl, xu = np.asarray(b["xl"], float), np.asarray(b["xu"], float)
    pop, gens = SIZES["fit_pop"], 2
    X0 = lhs_sampling(pop, xl, xu, np.random.default_rng(0))
    F4 = np.asarray(evaluate_population(obj, X0, mesh=mesh))
    F1 = np.asarray(evaluate_population(obj, X0))
    diff = float(np.max(np.abs(F4 - F1) / np.maximum(np.abs(F1), 1e-30)))
    say(f"g. first-generation F (pop {pop}), four cards vs one card: max "
        f"rel diff {diff:.3e} (rtol {FOUR_RTOL})")
    assert diff < FOUR_RTOL, diff
    for name, m in (("one card", None), ("four cards", mesh)):
        blocks = make_device_ga_blocks(obj, len(xl), pop, gens_per_block=1,
                                       mesh=m)
        t0 = time.perf_counter()
        run_unsga3_device(obj, xl, xu, pop_size=pop, n_gen=1, seed=0,
                          ftol=0.0, n_max_evals=None, gens_per_block=1,
                          prebuilt=blocks)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run_unsga3_device(obj, xl, xu, pop_size=pop, n_gen=gens,
                                seed=0, ftol=0.0, n_max_evals=None,
                                gens_per_block=1, prebuilt=blocks)
        per_gen = (time.perf_counter() - t0) / (gens + 1)
        assert np.all(np.isfinite(res.F))
        say(f"g. {name}: first generation {t_first:.3f} s incl. compile; "
            f"{per_gen:.4f} s per generation warm (init + {gens} gens)")
    return diff


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded ensemble phase")
    args = ap.parse_args(argv)

    import jax

    require_gpu(jax.devices()[0].platform)
    CARD = card_info()
    from phoskintime_tpu.parallel.profile import enable_compilation_cache

    say(f"card: {CARD} (name, power limit)")
    enable_compilation_cache()
    dev, have = phase_device()
    t_start = time.perf_counter()
    if args.four:
        phases = [("g", phase_four)]
    else:
        from bench import bench_network

        b = bench_network()
        phases = [("b", lambda: phase_kernel(b)),
                  ("c", lambda: phase_objective(b, dev)),
                  ("d", lambda: phase_mechanisms(dev)),
                  ("e", lambda: phase_fit(dev))]
        if have["pandas"]:
            phases.append(("f", phase_cli))
        else:
            say("f. cli: skipped, pandas is not installed")
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        say(f"{name}. phase wall {time.perf_counter() - t0:.3f} s "
            f"(compilation included)")
    say(f"all phases passed in {time.perf_counter() - t_start:.3f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
