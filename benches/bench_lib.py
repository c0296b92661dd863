"""Shared microbenchmark harness (criterion-equivalent).

Scenario parameters mirror the reference benches so numbers are
apples-to-apples by construction:
  * Size512   — 512 batches x 8192 rows (reference benches/build_speed.rs:38)
  * Size256   — 10,000 x 1024-row base cycling 256 id-blocks; dims 256x1024
                (reference benches/my_benchmark.rs:151-216)
  * exp-dist  — exponential skewed keys y=(16^x-1)/15
                (reference src/api_utils.rs:15-23)

Statistics (criterion analog, reference benches/my_benchmark.rs:29-37 uses
warmup 30 s / 300 s / 50 samples): every measurement reports median and
sigma over N samples, not just best-of. For env-gated feature A/Bs use
`sandwich()` — device throughput drifts between runs, so the trustworthy
comparison is ON/OFF/ON legs back-to-back in one process; the repeated leg
exposes the drift.
"""

from __future__ import annotations

import json
import os
import statistics
import time

import numpy as np


def make_exponential_int_array(rng, n: int, max_value: int) -> np.ndarray:
    """Reference src/api_utils.rs:15-23: y = max * (16^x - 1) / 15, x~U[0,1]."""
    x = rng.random(n)
    return (max_value * (16.0 ** x - 1) / 15.0).astype(np.int64).clip(0, max_value - 1)


def timeit_stats(fn, warmup: int = 2, iters: int = 10) -> dict:
    """-> {best_s, mean_s, median_s, std_s, samples}. fn must SYNCHRONIZE:
    end in `jax.block_until_ready` (or a host fetch of the result)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "median_s": statistics.median(times),
        "std_s": statistics.stdev(times) if len(times) > 1 else 0.0,
        "samples": len(times),
    }


def timeit_block(fn, warmup: int = 2, iters: int = 10):
    """Back-compat shim -> (best_s, mean_s); prefer timeit_stats."""
    s = timeit_stats(fn, warmup, iters)
    return s["best_s"], s["mean_s"]


def sandwich(make_fn, env_var: str, on_value: str | None = None,
             off_value: str = "1", warmup: int = 1, iters: int = 5) -> dict:
    """ON/OFF/ON drift-controlled A/B of an env-gated feature, one process.

    make_fn() is called fresh per leg (so trace-time env reads see the gate)
    and must return a synchronizing callable. Returns per-leg stats plus:
      * speedup  — OFF median / ON median (pooled ON legs); >1 = feature wins
      * drift    — |on1 - on2| / pooled ON median; if drift ~ |speedup-1| the
                   result is noise, not signal.
    """
    legs = {}
    order = [("on1", on_value), ("off", off_value), ("on2", on_value)]
    saved = os.environ.get(env_var)
    try:
        for leg, val in order:
            if val is None:
                os.environ.pop(env_var, None)
            else:
                os.environ[env_var] = val
            legs[leg] = timeit_stats(make_fn(), warmup, iters)
    finally:
        if saved is None:
            os.environ.pop(env_var, None)
        else:
            os.environ[env_var] = saved
    on_med = statistics.median([legs["on1"]["median_s"], legs["on2"]["median_s"]])
    off_med = legs["off"]["median_s"]
    return {
        "legs": legs,
        "speedup": off_med / on_med if on_med else float("inf"),
        "drift": abs(legs["on1"]["median_s"] - legs["on2"]["median_s"]) / on_med
        if on_med else 0.0,
    }


def report(name: str, rows: int, best_s: float, mean_s: float, extra=None,
           stats: dict | None = None):
    out = {"bench": name, "rows": rows,
           "best_ms": round(best_s * 1e3, 3),
           "mean_ms": round(mean_s * 1e3, 3),
           "rows_per_s": round(rows / best_s, 1)}
    if stats:
        out["median_ms"] = round(stats["median_s"] * 1e3, 3)
        out["std_ms"] = round(stats["std_s"] * 1e3, 3)
        out["samples"] = stats["samples"]
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def report_stats(name: str, rows: int, stats: dict, extra=None):
    return report(name, rows, stats["best_s"], stats["mean_s"], extra, stats)
