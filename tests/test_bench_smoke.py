"""Every bench script must import and run its fast path — benches rotted
silently in round 1 when probe_candidates' signature changed (the reference
runs all of its benches as part of `cargo bench`; this is our equivalent
guard, cf. reference benches/lookup_speed.rs:122-141).

Each bench runs as a subprocess (they parse argv and configure jax at
import) with tiny sizes on the CPU backend.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCHES = [
    ("build_speed.py", ["--rows", "4096"]),
    ("build_speed.py", ["--rows", "4096", "--strategy", "sort"]),
    ("lookup_speed.py", ["--rows", "4096", "--iters", "2"]),
    ("lookup_speed.py", ["--rows", "4096", "--iters", "2",
                         "--strategy", "sort"]),
    ("build_speed.py", ["--rows", "4096", "--strategy", "oa"]),
    ("lookup_speed.py", ["--rows", "4096", "--iters", "2",
                         "--strategy", "oa"]),
    ("exponential_distribution.py", ["--rows", "4096"]),
    ("sort_bench.py", ["--rows", "4096", "--cols", "3"]),
    ("my_benchmark.py", ["--base-batches", "8", "--iterations", "1"]),
]


def run_bench(script, args, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if extra_env:
        env.update(extra_env)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benches", script), *args],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert proc.returncode == 0, (
        f"{script} {' '.join(args)} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


@pytest.mark.parametrize("script,args", BENCHES,
                         ids=[f"{s}:{' '.join(a)}" for s, a in BENCHES])
def test_bench_fast_path(script, args):
    out = run_bench(script, args)
    # every bench must emit at least one JSON result line
    lines = [l for l in out.splitlines() if l.startswith("{")]
    assert lines, f"no JSON output from {script}: {out!r}"
    for line in lines:
        rec = json.loads(line)
        assert "bench" in rec or "op" in rec or "metric" in rec


def test_exponential_distribution_mesh():
    out = run_bench(
        "exponential_distribution.py", ["--rows", "4096", "--mesh", "4"],
        extra_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    lines = [l for l in out.splitlines() if l.startswith("{")]
    assert len(lines) >= 2  # partitioned + skew_salted
