"""Device-facing runtime rules that must hold on every platform: where the
compile cache lives, that meshes never swap platforms, how the memory
budget is sized, that only out-of-memory errors take the out-of-core path,
and that the GPU entry points refuse to run without a GPU."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

import datafusion_parallelism_tpu as dfp
from datafusion_parallelism_tpu.parallel.mesh import make_mesh
from datafusion_parallelism_tpu.runtime.budget import (TUNED_DEVICE_BYTES,
                                                       _OVERRIDES,
                                                       is_out_of_memory,
                                                       memory_budget)
from datafusion_parallelism_tpu.runtime.executor import QueryHandle

from oracle import assert_rows_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_overrides, drop=()):
    env = dict(os.environ, **env_overrides)
    for k in drop:
        env.pop(k, None)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)


@pytest.mark.parametrize("set_var", [True, False], ids=["env", "default"])
def test_compile_cache_dir(set_var, tmp_path):
    code = ("import datafusion_parallelism_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    want = str(tmp_path / "cache") if set_var else os.path.join(REPO,
                                                                ".jax_cache")
    proc = _run(["-c", code],
                {"JAX_COMPILATION_CACHE_DIR": want} if set_var else {},
                drop=() if set_var else ("JAX_COMPILATION_CACHE_DIR",))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == want


def test_make_mesh_never_swaps_platform():
    n = len(jax.devices())
    assert make_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="requested"):
        make_mesh(n + 1)
    with pytest.raises(ValueError, match="requested"):
        make_mesh(len(jax.devices("cpu")) + 1, platform="cpu")


def _fake_device(platform, stats):
    return SimpleNamespace(platform=platform, device_kind="fake",
                           memory_stats=lambda: stats)


def test_memory_budget_scales_with_bytes_limit(monkeypatch):
    for var in _OVERRIDES.values():
        monkeypatch.delenv(var, raising=False)
    b = memory_budget(_fake_device("gpu",
                                   {"bytes_limit": 4 * TUNED_DEVICE_BYTES}))
    assert b.device_bytes == 4 * TUNED_DEVICE_BYTES
    assert (b.stream_bytes, b.stream_rows, b.stage_bytes,
            b.dist_stage_bytes, b.grace_resident_rows) == (
        4 * (6 << 30), 4 << 26, 4 << 30, 4 << 30, 4 * (96 << 20))


def test_memory_budget_on_cpu_keeps_tuned_constants(monkeypatch):
    for var in _OVERRIDES.values():
        monkeypatch.delenv(var, raising=False)
    b = memory_budget()          # the test platform is the CPU
    assert jax.devices()[0].platform == "cpu"
    assert (b.device_bytes, b.stream_bytes, b.stream_rows, b.stage_bytes,
            b.dist_stage_bytes, b.grace_resident_rows) == (
        TUNED_DEVICE_BYTES, 6 << 30, 1 << 26, 1 << 30, 1 << 30, 96 << 20)


@pytest.mark.parametrize("field,var", sorted(_OVERRIDES.items()))
def test_memory_budget_env_override_wins(field, var, monkeypatch):
    monkeypatch.setenv(var, "12345")
    b = memory_budget(_fake_device("gpu",
                                   {"bytes_limit": 4 * TUNED_DEVICE_BYTES}))
    assert getattr(b, field) == 12345
    assert b.device_bytes == 4 * TUNED_DEVICE_BYTES
    others = [f for f in _OVERRIDES if f != field]
    assert all(getattr(b, f) != 12345 for f in others)


@pytest.mark.parametrize(
    "preset", ["", "--xla_gpu_force_compilation_parallelism=3"],
    ids=["unset", "caller_set"])
def test_enable_parallel_gpu_compile(preset, monkeypatch):
    monkeypatch.setenv("XLA_FLAGS",
                       f"--xla_dump_to=/dev/null {preset}".strip())
    dfp.enable_parallel_gpu_compile()
    flags = os.environ["XLA_FLAGS"].split()
    assert flags[0] == "--xla_dump_to=/dev/null"      # caller's flags kept
    assert "--xla_gpu_enable_llvm_module_compilation_parallelism=true" in flags
    par = [f for f in flags
           if f.startswith("--xla_gpu_force_compilation_parallelism=")]
    assert len(par) == 1 and int(par[0].split("=")[1]) >= 1
    if preset:
        assert par == [preset]                         # never overridden


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_memory_budget_gpu_without_limit_is_an_error(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        memory_budget(_fake_device("gpu", stats))


@pytest.mark.parametrize("msg,oom", [
    ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 8 bytes",
     True),
    ("Out of memory allocating 123 bytes", True),
    ("INTERNAL: Failed to launch kernel", False),
    ("INVALID_ARGUMENT: shape mismatch", False),
])
def test_is_out_of_memory(msg, oom):
    assert is_out_of_memory(jax.errors.JaxRuntimeError(msg)) is oom


_ROWS = {"k": [i % 13 for i in range(3000)],
         "v": [float(i % 7) for i in range(3000)]}
_SQL = "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY k"


def _expected():
    out = {}
    for k, v in zip(_ROWS["k"], _ROWS["v"]):
        s, n = out.get(k, (0.0, 0))
        out[k] = (s + v, n + 1)
    return [{"k": k, "s": s, "n": n} for k, (s, n) in out.items()]


def _handle():
    ctx = dfp.SessionContext()
    ctx.register_pydict("t", _ROWS)
    return ctx.sql(_SQL)


def _raise(msg):
    def run_resident(self, adaptive):
        raise jax.errors.JaxRuntimeError(msg)
    return run_resident


def test_resident_oom_takes_out_of_core_path(monkeypatch):
    monkeypatch.setenv("DFP_STREAM_CHUNK_ROWS", "1024")
    monkeypatch.setattr(QueryHandle, "_run_resident", _raise(
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate"))
    h = _handle()
    assert_rows_equal(h.collect().to_pylist(), _expected())
    assert h.metrics.streamed_chunks > 1


def test_resident_non_oom_error_propagates(monkeypatch):
    monkeypatch.setenv("DFP_STREAM_CHUNK_ROWS", "1024")
    monkeypatch.setattr(QueryHandle, "_run_resident",
                        _raise("INTERNAL: an unrelated failure"))
    h = _handle()
    with pytest.raises(jax.errors.JaxRuntimeError, match="unrelated"):
        h.collect()
    assert h.metrics.streamed_chunks == 0


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    proc = _run([script], {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
