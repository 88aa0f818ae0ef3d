"""phoskintime_tpu — an accelerator-native framework for ODE-based modeling of
phosphorylation cascades.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the reference
``phoskintime`` toolkit (kinetic parameter fitting of mRNA -> protein ->
phospho-site dynamics across distributive / successive / random mechanistic
hypotheses, steady-state initialization, Morris sensitivity, in-silico
knockouts, identifiability, multi-objective evolutionary optimization, and a
reporting layer).

Design principles (accelerator-first, not a port):

* Per-gene kinetic models are **linear time-invariant ODEs**; instead of an
  adaptive CPU integrator per sample, they are solved exactly with batched
  matrix exponentials (``vmap`` over genes x starts x weights x lambdas)
  which map straight onto the accelerator's matrix units.
* The global network model is nonlinear; it runs through a vmap-safe
  adaptive Dormand-Prince RK45 (``lax.while_loop`` with per-lane step
  control, bucketed piecewise-constant kinase inputs and Hermite dense
  output), so a whole optimizer population integrates as ONE XLA program.
* "Parallelism" is never a process pool: populations / multistarts / Morris
  samples / bootstrap draws are batch axes, sharded over a
  ``jax.sharding.Mesh`` via ``NamedSharding``/``shard_map``.
* Reporting, IO and CLI stay host-side (pandas/matplotlib) — they are not
  performance-critical.
"""

__version__ = "0.1.0"

from phoskintime_tpu.config import numerics  # noqa: F401  (dtype policy)
