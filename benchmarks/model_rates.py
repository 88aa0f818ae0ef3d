"""Per-mechanism objective throughput (models 2 and 4) on a GPU.

Same timing as bench.py: warmed calls ended by ``jax.block_until_ready``,
median of several. Device figures: not measured on the H100 yet.

Usage: python benchmarks/model_rates.py [--pop 2048]
Reference anchor: the mechanisms' hot loops this replaces,
/root/reference/global_model/models.py:322-432 (hypercube) and
solvers.py:292-440 (LSODA stepping).
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def rate_for_model(model, pop, pop_chunk=2048):
    import jax
    import jax.numpy as jnp

    from bench import device_record, time_call
    from phoskintime_tpu.demo import build_demo_network
    from phoskintime_tpu.network.objective import make_population_objective

    b = build_demo_network(n_proteins=40, n_kinases=12, model=model,
                           seed=0, dtype=np.float32)
    objective = make_population_objective(
        b["system"], b["slices"], b["loss_data"], b["defaults"],
        b["lambdas"], b["grid"], pop_chunk=min(pop_chunk, pop))
    rng = np.random.default_rng(0)
    thetas = jnp.asarray(
        b["theta0"][None] + 0.05 * rng.normal(size=(pop, len(b["theta0"]))),
        jnp.float32)
    f = jax.jit(objective)
    F = f(thetas)
    jax.block_until_ready(F)
    assert bool(jnp.all(jnp.isfinite(F)))

    t_call = time_call(f, thetas)
    return {"model": model, "pop": pop, "device": device_record(),
            "evals_per_s": round(pop / t_call, 1),
            "ms_per_call": round(t_call * 1e3, 3)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pop", type=int, default=2048)
    ap.add_argument("--models", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    from phoskintime_tpu.parallel.profile import enable_compilation_cache

    enable_compilation_cache()
    for m in args.models:
        t0 = time.time()
        out = rate_for_model(m, args.pop)
        out["total_wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
