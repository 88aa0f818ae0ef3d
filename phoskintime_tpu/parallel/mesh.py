"""Device-mesh construction and sharding helpers.

The workload's scaling axis is the candidate-population batch (SURVEY.md
§2.10): candidates are embarrassingly parallel, so the mesh is 1-D over
all available devices with the population sharded across it; XLA inserts
the (tiny) cross-device reductions for ideal-point/argmin bookkeeping.
Multi-host runs extend the same mesh transparently through
``jax.distributed`` — no hand-written collectives.
"""

from __future__ import annotations

import numpy as np


def population_mesh(n_devices: int | None = None, axis: str = "pop"):
    """1-D mesh over (up to) all devices; None if only one device."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n = len(devs) if n_devices is None else min(n_devices, len(devs))
    if n <= 1:
        return None
    return Mesh(np.array(devs[:n]).reshape(n), (axis,))


def sharded_jit(fn, mesh, **shardings):
    """``jax.jit(fn, **shardings)`` whose calls trace and run under
    ``jax.set_mesh(mesh)``.

    The mesh in context is how a trace knows it is sharded:
    :func:`phoskintime_tpu.network.expo._table_route` keeps such traces on
    the XLA table build, because a ``pallas_call`` has no partitioning
    rule. The context mesh is part of jit's cache key, so the same
    objective traced without a mesh keeps its own program."""
    import functools

    import jax

    jitted = jax.jit(fn, **shardings)

    @functools.wraps(fn)
    def call(*args):
        with jax.set_mesh(mesh):
            return jitted(*args)

    return call


def pad_to_devices(P: int, mesh) -> int:
    """Smallest population size >= P divisible by the mesh."""
    if mesh is None:
        return P
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    return int(np.ceil(P / n) * n)


def initialize_distributed():
    """Multi-host initialization (no-op on a single host)."""
    import jax

    try:
        jax.distributed.initialize()
    except (ValueError, RuntimeError):
        pass  # single-process run
    return len(jax.devices())
