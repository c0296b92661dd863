"""End-to-end check of the query engine on the GPU, through its user entry
points, at data sizes users run.

    python chip_smoke.py                # one GPU: phases 1-5
    python chip_smoke.py --four-cards   # four GPUs: device + distributed phase

Phases (one process owns the card; each prints one JSON line with its wall
time, compile time and result):
  1. device       — require JAX's GPU backend; print the card and its budget;
  2. join         — the Size512 inner join (bench.py) against numpy;
  3. tpch_sf1     — all 22 TPC-H queries at SF1 through `tpch.cli`, checked
                    against the Python oracle (one iteration each);
  4. tpch_sf10    — Q1/3/5/6/9/13/18/21 at SF10, resident on the device,
                    two iterations each;
  5. out_of_core  — SF10 Q1/Q3 morsel-streamed and Q18 grace-partitioned,
                    forced through the executor's DFP_* switches.
`--four-cards` runs, at SF10 on a 4-GPU mesh, one iteration each of
DIST4_QUERIES, DIST4_STAGED_QUERIES forced staged, and Q1/Q3
distributed-streamed, and prints the devices holding each output.

Any failure raises and exits non-zero. The last line, printed only when
every phase passed, is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from contextlib import contextmanager

SF10_QUERIES = [1, 3, 5, 6, 9, 13, 18, 21]
# the four-card set: sized so a cold run on four cards stays near five
# minutes, most of it compilation (a distributed program compiles 2-3x
# slower than its one-card form). It keeps group-by and global aggregates,
# a join chain with top-k, LEFT join + COUNT and EXISTS / NOT EXISTS, and
# leaves out Q5 and Q9 (more join chains) and Q18 (IN; the costliest
# compile). Staging only changes plans with two or more joins: Q3.
DIST4_QUERIES = [1, 3, 6, 13, 21]
DIST4_STAGED_QUERIES = [3]
# grace forced at SF10 the way tests/test_grace.py forces it at SF 0.01:
# lineitem (60M rows) and orders (15M) both partition, and orders sits above
# the demotion ceiling so it cannot go resident
GRACE_ENV = {"DFP_FORCE_GRACE": "1",
             "DFP_STREAM_ROW_THRESHOLD": str(10_000_000),
             "DFP_GRACE_RESIDENT_CEILING": str(10_000_000)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


@contextmanager
def env(**overrides):
    """Set environment variables for the block; restore them afterwards."""
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update({k: str(v) for k, v in overrides.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_device(n_cards: int) -> dict:
    import jax

    from bench import nvidia_smi
    from datafusion_parallelism_tpu.runtime.budget import memory_budget

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX default backend is "
                         f"{backend!r})")
    devices = jax.devices()
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} GPUs needed, "
                         f"{len(devices)} found")
    d = devices[0]
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", platform=d.platform, kind=d.device_kind,
         count=len(devices), nvidia_smi=smi.splitlines(),
         bytes_limit=d.memory_stats()["bytes_limit"],
         budget=memory_budget(d).__dict__)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def phase_join() -> None:
    import jax

    import bench

    t0 = time.time()
    inputs = bench.make_inputs()
    want_n, want_sum = bench.reference_join(*inputs)
    build, probe = bench.device_inputs(inputs)
    step = bench.join_step()
    tc = time.time()
    compiled = step.lower(build, probe).compile()
    compile_s = time.time() - tc
    n, s, total = jax.block_until_ready(compiled(build, probe))
    n, s, total = int(n), float(s), int(total)
    assert total <= bench.OUT_CAP, f"out_cap overflow: {total}"
    assert n == want_n, f"match count {n} != numpy {want_n}"
    rel = abs(s - want_sum) / abs(want_sum)
    assert rel <= 1e-5, f"payload sum {s} vs numpy {want_sum} (rel {rel})"
    emit("join", wall_s=time.time() - t0, compile_s=compile_s, matches=n,
         payload_sum=s, reference_sum=want_sum, rel_err=rel)


def _peak_bytes() -> int:
    import jax
    return jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)


def share_statistics(tables) -> None:
    """Let every session registered over `tables` share one Statistics
    object per table (the hint a stored table directory carries), so the
    per-query sessions below compute each distinct count once: at SF10 a
    fresh session's planning statistics cost seconds of host time per query
    (PERF.md)."""
    from datafusion_parallelism_tpu.utils.catalog import Statistics

    for t in tables.values():
        t.statistics_hint = Statistics(row_count=t.num_rows)


def run_tpch(tag: str, tables, answers: dict, queries, *, iterations=2,
             concurrency=1, min_chunks=0, resident=False) -> dict:
    """Run `queries` through tpch.cli with --check, one session per query
    (for its peak memory); every query must pass the oracle, with no error
    entry. `answers` keeps the oracle's answers over `tables`. One
    JSON line per query: every iteration's wall time, the warm median when
    there are two or more, and the first run's decomposition."""
    from datafusion_parallelism_tpu.tpch import cli

    argv = ["--iterations", str(iterations), "--check",
            "--concurrency", str(concurrency)]
    compile_s = 0.0
    for q in queries:
        t0 = time.time()
        res = cli.run(argv + ["--query", str(q)], tables=tables,
                      oracle_cache=answers)
        m = res["query_metrics"][q]
        assert "error" not in m, f"{tag} Q{q}: {m['error']}"
        assert res["checked"][q] is True, f"{tag} Q{q}: check=FAIL"
        if min_chunks:
            assert m["streamed_chunks"] >= min_chunks, \
                f"{tag} Q{q}: streamed {m['streamed_chunks']} chunks"
        if resident:
            assert m["streamed_chunks"] == 0, \
                f"{tag} Q{q}: left the resident path"
        if concurrency > 1:
            assert len(m["output_devices"]) == concurrency, \
                f"{tag} Q{q}: output on {m['output_devices']}"
        compile_s += m["compile_time_s"]
        warm = ({"median_warm_ms": res["query_summary"][q]["median_warm_ms"]}
                if iterations > 1 else {})
        emit(f"{tag}/Q{q}", check="PASS", wall_s=time.time() - t0,
             iteration_ms=res["query_times_ms"][q], **warm,
             decomposition=m["decomposition"],
             oracle_ms=res["query_summary"][q]["oracle_ms"],
             compile_s=m["compile_time_s"], compiles=m["compiles"],
             retries=m["retries"], launches=m["launches"],
             streamed_chunks=m["streamed_chunks"],
             output_devices=m.get("output_devices"),
             peak_bytes_in_use=_peak_bytes())
        del res
        gc.collect()     # drop the run's session and its device buffers
    return {"compile_s": compile_s}


def phase_tpch_sf1() -> None:
    from datafusion_parallelism_tpu.tpch.datagen import generate_tables
    from datafusion_parallelism_tpu.tpch.queries import QUERIES

    t0 = time.time()
    tables = generate_tables(sf=1)
    share_statistics(tables)
    # one iteration: a second one recompiles nearly every query (the
    # deferred capacity shrink lands there) and nearly doubles the phase's
    # compile time (PERF.md); SF10 keeps two
    r = run_tpch("tpch_sf1", tables, {}, sorted(QUERIES), iterations=1)
    emit("tpch_sf1", wall_s=time.time() - t0, compile_s=r["compile_s"],
         queries=len(QUERIES), result="all PASS")


def grace_plan_of(tables, q: int) -> dict:
    """The grace plan the executor takes for `q` under GRACE_ENV."""
    import datafusion_parallelism_tpu as dfp
    from datafusion_parallelism_tpu.runtime.grace import plan_grace
    from datafusion_parallelism_tpu.tpch.queries import QUERIES

    ctx = dfp.SessionContext()
    for name, t in tables.items():
        ctx.register_table(name, t)
    gp, reason = plan_grace(ctx.sql(QUERIES[q]).plan, ctx.catalog,
                            int(GRACE_ENV["DFP_STREAM_ROW_THRESHOLD"]))
    assert gp is not None, f"Q{q} is not grace-eligible: {reason}"
    return {"kind": gp.kind,
            "parts": {s.table_name: c for s, c in gp.parts.values()}}


def phase_sf10(tables) -> None:
    share_statistics(tables)
    answers = {}
    t0 = time.time()
    r = run_tpch("tpch_sf10", tables, answers, SF10_QUERIES, resident=True)
    emit("tpch_sf10", wall_s=time.time() - t0, compile_s=r["compile_s"],
         queries=SF10_QUERIES, result="all PASS, resident")

    t0 = time.time()
    with env(DFP_STREAM_THRESHOLD_BYTES=0):
        a = run_tpch("stream_sf10", tables, answers, [1, 3], min_chunks=2)
    with env(**GRACE_ENV):
        plan = grace_plan_of(tables, 18)
        b = run_tpch("grace_sf10", tables, answers, [18], min_chunks=2)
    emit("out_of_core", wall_s=time.time() - t0,
         compile_s=a["compile_s"] + b["compile_s"], grace_plan_q18=plan,
         result="streamed Q1/Q3 and grace Q18 PASS")


def phase_four_cards(tables) -> None:
    share_statistics(tables)
    answers = {}
    t0 = time.time()
    a = run_tpch("dist4_sf10", tables, answers, DIST4_QUERIES, iterations=1,
                 concurrency=4)
    with env(DFP_DIST_STAGED=1):
        b = run_tpch("dist4_staged_sf10", tables, answers,
                     DIST4_STAGED_QUERIES, iterations=1, concurrency=4)
    with env(DFP_STREAM_THRESHOLD_BYTES=0):
        c = run_tpch("dist4_stream_sf10", tables, answers, [1, 3],
                     iterations=1, concurrency=4, min_chunks=2)
    emit("distributed", wall_s=time.time() - t0,
         compile_s=a["compile_s"] + b["compile_s"] + c["compile_s"],
         result="all PASS on 4 GPUs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phase, on a 4-GPU mesh")
    args = ap.parse_args(argv)

    # the package must come from this checkout, never from elsewhere
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datafusion_parallelism_tpu as dfp   # x64, compile cache
    from datafusion_parallelism_tpu.tpch.datagen import generate_tables

    dfp.enable_parallel_gpu_compile()    # before JAX creates its backend

    n_cards = 4 if args.four_cards else 1
    device = phase_device(n_cards)
    if args.four_cards:
        phase_four_cards(generate_tables(sf=10))
    else:
        phase_join()
        phase_tpch_sf1()
        phase_sf10(generate_tables(sf=10))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
