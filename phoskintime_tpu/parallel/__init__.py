"""Scaling utilities: device meshes, checkpoint/resume, profiling."""

from phoskintime_tpu.parallel.checkpoint import (  # noqa: F401
    GACheckpointer,
    load_checkpoint,
    load_sampler,
    save_checkpoint,
    save_sampler,
)
from phoskintime_tpu.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    pad_to_devices,
    population_mesh,
    sharded_jit,
)
from phoskintime_tpu.parallel.profile import (  # noqa: F401
    enable_compilation_cache,
    timed,
    trace,
)
