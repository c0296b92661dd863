"""Stopgap benchmark: single-GPU hash-join throughput (build + probe).

Scenario mirrors the reference's BuildSpeed/LookupSpeed `Size512` (512
batches x 8192 rows = 4,194,304 rows, uniform int keys — reference
benches/build_speed.rs:38,131-160, benches/lookup_speed.rs:122-141), fused
here into one end-to-end join step: build and probe compile into one program.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"baseline_host"}. vs_baseline divides by a vectorized numpy join of the same
inputs (sort + searchsorted), timed in this process on the host CPU that
`baseline_host` names (the Rust reference is not built here). Exits non-zero
when JAX finds no GPU; there is no fallback value.

    python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_ROWS = 512 * 8192          # reference Size512
KEY_RANGE = N_ROWS           # ~1 match per probe row
OUT_CAP = N_ROWS + N_ROWS // 2   # ~1 match/row + <=cap/4 bucket collisions
ITERS = 20


def make_inputs(seed: int = 0):
    """(build keys, build payload, probe keys, probe payload) for Size512."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, KEY_RANGE, N_ROWS).astype(np.int32)
    bv = rng.random(N_ROWS).astype(np.float32)
    pk = rng.integers(0, KEY_RANGE, N_ROWS).astype(np.int32)
    pv = rng.random(N_ROWS).astype(np.float32)
    return bk, bv, pk, pv


def reference_join(bk, bv, pk, pv):
    """Vectorized numpy inner join (sort + searchsorted) -> (match count,
    float64 sum of both payloads over the matched pairs)."""
    order = np.argsort(bk, kind="stable")          # build
    sk = bk[order]
    lo = np.searchsorted(sk, pk, side="left")      # probe
    hi = np.searchsorted(sk, pk, side="right")
    count = hi - lo
    total = int(count.sum())
    probe_idx = np.repeat(np.arange(len(pk)), count)
    offs = np.arange(total) - np.repeat(np.cumsum(count) - count, count)
    build_idx = order[np.repeat(lo, count) + offs]
    s = float(bv[build_idx].astype(np.float64).sum()
              + pv[probe_idx].astype(np.float64).sum())
    return total, s


def cpu_baseline_rows_per_s(inputs) -> float:
    t0 = time.perf_counter()
    _, s = reference_join(*inputs)
    dt = time.perf_counter() - t0
    assert np.isfinite(s)
    return 2 * N_ROWS / dt


def device_inputs(inputs):
    """Upload the inputs as (build, probe) DeviceTables."""
    from datafusion_parallelism_tpu.utils.columnar import HostTable

    bk, bv, pk, pv = inputs
    build = HostTable.from_numpy({"b_key": bk, "b_val": bv}).to_device()
    probe = HostTable.from_numpy({"p_key": pk, "p_val": pv}).to_device()
    return build, probe


def join_step():
    """The jitted join step: (build, probe) -> (match count, float32 sum of
    both payloads over the matches, candidate total for the overflow check)."""
    import jax
    import jax.numpy as jnp

    from datafusion_parallelism_tpu.ops.join import JoinType, hash_join

    @jax.jit
    def step(build, probe):
        out, total = hash_join(build, probe, ["b_key"], ["p_key"],
                               JoinType.INNER, OUT_CAP)
        live = out.row_mask()
        s = jnp.float32(0)
        for name in ("b_val", "p_val"):
            v, valid = out.column(name)
            s = s + jnp.sum(jnp.where(valid & live, v, 0.0))
        return out.num_rows, s, total

    return step


def gpu_rows_per_s(inputs) -> float:
    import jax

    build, probe = device_inputs(inputs)
    step = join_step()
    _, _, total = jax.block_until_ready(step(build, probe))  # compile
    assert int(total) <= OUT_CAP, f"out_cap overflow: {int(total)}"
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = step(build, probe)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return ITERS * 2 * N_ROWS / dt


def nvidia_smi() -> str:
    """`name, power.limit` of every card, from a child that never imports
    JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return platform.processor() or platform.machine()


def main() -> int:
    import datafusion_parallelism_tpu as dfp
    import jax

    dfp.enable_parallel_gpu_compile()     # before JAX creates its backend

    if jax.default_backend() != "gpu":
        print(f"bench.py: no GPU (JAX default backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    inputs = make_inputs()
    baseline = cpu_baseline_rows_per_s(inputs)
    value = gpu_rows_per_s(inputs)
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "hash_join_build_probe_throughput_size512",
        "value": value,
        "unit": "rows/s",
        "vs_baseline": value / baseline,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": nvidia_smi()},
        "baseline_host": host_cpu(),
        "baseline_rows_per_s": baseline,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
