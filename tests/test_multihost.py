"""True multi-process SPMD execution: two OS processes, each owning 4
virtual CPU devices of one 8-device mesh, run the SAME distributed query
and must both produce the oracle answer. This is the multi-host simulation
layer the reference lacks (SURVEY.md §4) — the identical code path drives
multi-host device meshes via jax.distributed."""

import os
import socket
import subprocess
import sys

import pytest

SCRIPT = r"""
import os, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["DFP_NO_CAP_STORE"] = "1"
from datafusion_parallelism_tpu.parallel.multihost import init_multihost
init_multihost(f"localhost:{port}", num_processes=nproc, process_id=pid)

from datafusion_parallelism_tpu import SessionConfig, SessionContext

ctx = SessionContext(SessionConfig(target_partitions=8))
n = 64
ctx.register_pydict("ta", {
    "a_id": [i % 16 for i in range(n)],
    "a_val": list(range(n)),
})
ctx.register_pydict("tb", {
    "b_id": [i % 12 for i in range(n)],
    "b_val": [i * 2 for i in range(n)],
})
rows = ctx.sql(
    "SELECT a_id, SUM(b_val) AS s, COUNT(*) AS c FROM ta "
    "JOIN tb ON a_id = b_id GROUP BY a_id ORDER BY a_id"
).collect().to_pylist()
print(f"RESULT {pid} {rows!r}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_query(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(SCRIPT)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=560)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    # both processes computed the same full result
    results = []
    for out in outs:
        line = next(l for l in out.splitlines() if l.startswith("RESULT"))
        results.append(eval(line.split(" ", 2)[2]))
    assert results[0] == results[1]

    # and it matches the single-process oracle
    ids = [i % 16 for i in range(64)]
    bids = [i % 12 for i in range(64)]
    expected = []
    for a in sorted(set(ids)):
        if a not in bids:
            continue
        matches = [i * 2 for i in range(64) if bids[i] == a]
        na = ids.count(a)
        expected.append({"a_id": a, "s": sum(matches) * na,
                         "c": len(matches) * na})
    assert results[0] == expected
