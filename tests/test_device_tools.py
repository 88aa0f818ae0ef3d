"""The GPU-facing tools that must behave on the CPU too: the bench's peak
table and device record, the chip smoke run's device check, the compile
cache location, and the mesh-scoped jit."""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


class TestPeakTable:
    def test_h100_found(self):
        peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
        assert peaks["hbm_bytes_per_s"] == 3.35e12
        assert peaks["bf16_flops"] == 989e12
        assert "data sheet" in peaks["source"]

    def test_unknown_kind_raises(self):
        with pytest.raises(KeyError, match="no published peaks"):
            bench.device_peaks("cpu")


class TestDeviceChecks:
    def test_bench_refuses_cpu(self):
        with pytest.raises(SystemExit):
            bench.device_record()

    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(SystemExit) as e:
            chip_smoke.require_gpu("cpu")
        assert e.value.code not in (0, None)
        chip_smoke.require_gpu("gpu")          # the card passes

    def test_main_exits_nonzero_without_result(self, capsys):
        with pytest.raises(SystemExit) as e:
            chip_smoke.main([])
        assert e.value.code not in (0, None)
        out = capsys.readouterr().out
        assert '"ok"' not in out
        for line in out.splitlines():
            with pytest.raises(json.JSONDecodeError):
                json.loads(line)


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        from phoskintime_tpu.parallel.profile import compilation_cache_dir

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compilation_cache_dir() == str(tmp_path)

    def test_default_is_fixed_and_ignored(self, monkeypatch):
        from phoskintime_tpu.parallel.profile import (DEFAULT_CACHE_DIR,
                                                      compilation_cache_dir)

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = Path(compilation_cache_dir())
        assert path == DEFAULT_CACHE_DIR and path.parent == ROOT
        ignored = (ROOT / ".gitignore").read_text().split()
        assert f"{path.name}/" in ignored

    def test_disabled_in_the_suite(self):
        from phoskintime_tpu.parallel.profile import enable_compilation_cache

        assert os.environ.get("PHOSKINTIME_DISABLE_COMPILE_CACHE")
        assert enable_compilation_cache() == ""


def test_sharded_jit_matches_jit():
    """The mesh-scoped jit computes what plain jit computes, sharded."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from phoskintime_tpu.parallel.mesh import sharded_jit

    mesh = Mesh(np.array(jax.devices()[:4]), ("pop",))
    sh = NamedSharding(mesh, P("pop", None))
    f = sharded_jit(lambda x: jnp.tanh(x) * 2.0, mesh, in_shardings=sh,
                    out_shardings=sh)
    x = jnp.arange(32.0).reshape(8, 4) / 7.0
    y = f(x)
    assert y.sharding.is_equivalent_to(sh, 2)
    np.testing.assert_allclose(np.asarray(y), np.tanh(np.asarray(x)) * 2.0)


def test_sync_check_reports_three_clocks():
    f = jax.jit(lambda x: jnp.tanh(x) @ x.T)
    chk = bench.sync_check(f, jnp.ones((16, 16)), n=3, k=4)
    assert len(chk["host_fetch_samples_ms"]) == 3
    for key in ("block_until_ready_ms", "host_fetch_ms", "chained_ms"):
        assert chk[key] > 0.0
