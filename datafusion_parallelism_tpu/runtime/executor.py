"""Query executor: traces the whole physical DAG into one XLA program.

Replaces the reference's runtime layer (tokio worker streams + the shared
OnceLock executor in parallel_hash_join.rs:140-152 + compaction barriers):
under XLA there is nothing to synchronize — the plan compiles to one program
and the compiler schedules independent subtrees (e.g. the builds of a star
query's dimension tables) concurrently.

Join output capacities are data-dependent; the executor owns the
run -> check-overflow -> grow -> recompile loop (capacities grow to the next
power of two, so the number of distinct compiled programs stays logarithmic).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.physical import (ExecContext, PhysicalPlan, PScan,
                               find_adaptive, find_joins)
from ..utils.catalog import Catalog
from ..utils.columnar import DeviceTable, HostTable, round_capacity
from .budget import is_out_of_memory, memory_budget


class ExecutorMetrics:
    """Per-query metrics (the MetricsSet the reference never implemented —
    SURVEY.md §5.5 flags that gap; here it is first-class)."""

    def __init__(self):
        self.compile_count = 0
        self.compile_time_s = 0.0
        self.run_time_s = 0.0
        self.retries = 0
        self.join_caps: Dict[int, int] = {}
        self.streamed_chunks = 0
        # time decomposition: every executable invocation is a LAUNCH;
        # host_pack_s is stream-chunk packing on the host
        self.launches = 0
        self.host_pack_s = 0.0
        self.upload_s = 0.0   # host->device transfer windows (device_put)
        # distributed scaling proxies (no multi-chip hardware attached):
        # collective bytes received per device per step (exact, from static
        # shapes at trace time), per-join per-device candidate totals, and
        # the per-stage per-device memory model of staged execution
        self.comm_bytes = 0
        self.balance: Dict[int, list] = {}
        self.output_devices: list = []   # devices holding the output shards
        self.stage_bytes: list = []
        # distributed streaming: host pack/upload vs device compute windows
        # per chunk — the shuffle/compute-overlap evidence
        self.stream_timeline: list = []


def _maybe_dump_hlo(lowered, tag: str):
    """DFP_DUMP_HLO_DIR=<dir>: write each lowered program's StableHLO there
    (with source-line attributions) before compiling — the way to find which
    op a compile-time OOM report is pointing at."""
    import os
    d = os.environ.get("DFP_DUMP_HLO_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{tag}.mlir"), "w") as f:
            f.write(lowered.as_text())


# don't shrink-retry small overshoots: below this capacity the recompile
# costs more than the memory it frees
_SHRINK_FLOOR = 1 << 20


def _debug_retry(kind, key, node, cap, total, fit):
    """DFP_DEBUG_RETRIES=1: print each capacity correction (which node, how
    far off the estimate was) — every retry is a recompile, so this is the
    tuning loop for the planner's cardinality estimates."""
    import os
    if os.environ.get("DFP_DEBUG_RETRIES"):
        desc = node.describe() if node is not None else "?"
        print(f"[retry:{kind}] cap[{key}] {cap} -> {fit} (true total {total})"
              f" at {desc}", flush=True)


class QueryHandle:
    """A compiled, re-runnable query (analog of a criterion-prepared plan,
    reference benches/utils/prepare_query.rs)."""

    def __init__(self, plan: PhysicalPlan, catalog: Catalog,
                 scalar_subqueries=(), config=None):
        self.plan = plan
        self.catalog = catalog
        self.scalar_subqueries = list(scalar_subqueries)
        self.config = config
        self.metrics = ExecutorMetrics()
        self._caps: Dict[int, int] = {}
        self._compiled = None
        self._compiled_key = None
        self._staged_compiled: Dict[int, Tuple] = {}  # stage idx -> (key, exe)
        self._caps_loaded = False
        self._sub_handles = None   # cached scalar-subquery QueryHandles

    # -- learned-capacity persistence ----------------------------------------
    # Every overflow/shrink retry is a fresh XLA shape (minutes cold at SF1);
    # remembering the settled capacities per (plan, input shapes) makes later
    # processes compile the final shape directly.
    def _caps_store_path(self):
        # kept beside the persistent compile cache it saves recompiles for;
        # None (no store) when compile caching is off
        import os
        base = jax.config.jax_compilation_cache_dir
        return os.path.join(base, "learned_caps.json") if base else None

    def _caps_signature(self):
        import hashlib
        leaf = sorted((n.label, self.catalog.get(n.table_name).host.num_rows)
                      for n in self.plan.walk() if isinstance(n, PScan))
        raw = self.plan.tree() + repr(leaf)
        return hashlib.sha1(raw.encode()).hexdigest()

    def _load_caps(self, adaptive):
        import json
        import os
        self._caps_loaded = True
        path = self._caps_store_path()
        if os.environ.get("DFP_NO_CAP_STORE") or path is None:
            return
        try:
            with open(path) as f:
                stored = json.load(f).get(self._caps_signature())
            if stored and len(stored) == len(adaptive):
                for (k, _), cap in zip(adaptive, stored):
                    if cap is not None:  # None = node was fused away
                        self._caps[k] = cap
        except (OSError, ValueError):
            pass

    def _save_caps(self, adaptive):
        import json
        import os
        path = self._caps_store_path()
        if os.environ.get("DFP_NO_CAP_STORE") or path is None:
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            data[self._caps_signature()] = [self._caps.get(k)
                                            for k, _ in adaptive]
            with open(path, "w") as f:
                json.dump(data, f)
        except OSError:
            pass

    # -- inputs ---------------------------------------------------------------
    def _live_columns(self) -> Dict[str, set]:
        """Plan-live column set per TABLE (union over its scan labels)."""
        from ..models.optimizer import required_leaf_columns
        live = required_leaf_columns(self.plan)
        per_table: Dict[str, set] = {}
        for node in self.plan.walk():
            if isinstance(node, PScan):
                per_table.setdefault(node.table_name, set()).update(
                    live.get(node.label) or set())
        return per_table

    def _leaf_tables(self, skip_labels=()) -> Dict[str, DeviceTable]:
        """Upload each scan's LIVE columns only: the resident HBM set is what
        OOMs big scale factors (SF10 lineitem is ~6 GB full-width, ~2.5 GB at
        Q9's seven live columns). Narrowed uploads are cached per column-set
        on the registration so repeat runs don't re-transfer.
        `skip_labels`: scans left out entirely (streamed in chunks instead)."""
        from ..models.optimizer import required_leaf_columns
        live = required_leaf_columns(self.plan)
        # one upload per TABLE: the union over its labels (self-joins), so
        # the per-table subset cache never thrashes within a query
        per_table: Dict[str, set] = {}
        for node in self.plan.walk():
            if isinstance(node, PScan):
                per_table.setdefault(node.table_name, set()).update(
                    live.get(node.label) or set())
        tables = {}
        for node in self.plan.walk():
            if isinstance(node, PScan) and node.label not in tables \
                    and node.label not in skip_labels:
                reg = self.catalog.get(node.table_name)
                cols = per_table[node.table_name] & set(reg.host.schema.names)
                if not cols:
                    cols = {reg.host.schema.names[0]}
                dev = reg.device_subset(frozenset(cols))
                tables[node.label] = dev.rename(
                    {c: f"{node.label}.{c}" for c in dev.schema.names})
        return tables

    # -- execution --------------------------------------------------------------
    def run(self) -> DeviceTable:
        # uncorrelated scalar subqueries run first; their values are baked
        # in. Handles are cached across run() calls: a fresh QueryHandle per
        # iteration re-traces and re-lowers the whole subplan (seconds of
        # host time per iteration on Q11/Q15-sized subqueries); a cached one
        # reuses its compiled executable.
        if self._sub_handles is None:
            self._sub_handles = [
                QueryHandle(sub.plan, self.catalog, sub.scalar_subqueries,
                            self.config)
                for _, sub in self.scalar_subqueries]
        for (sv, _), handle in zip(self.scalar_subqueries,
                                   self._sub_handles):
            if getattr(sv, "_settled", False):
                # registered tables are immutable, so the value cannot
                # change between collect() calls on this handle — re-running
                # the subquery program would add its launches and host
                # syncs to every warm iteration
                continue
            result = handle.run().to_host()
            rows = result.to_pylist()
            if len(rows) != 1:
                raise ValueError(f"scalar subquery returned {len(rows)} rows")
            value = rows[0][result.schema.fields[0].name]
            sv.holder[0] = value
            sv._settled = True

        adaptive = find_adaptive(self.plan)
        plan = self.plan
        if not self._caps_loaded:
            self._load_caps(adaptive)

        # Morsel streaming: when the biggest scan's upload alone breaks the
        # HBM budget and it reaches the top aggregate row-linearly, chunk it
        # through the plan instead of materializing it (out-of-core path —
        # the analog of the reference's streaming probe, inner.rs:48-75).
        import os
        sp = None
        if not os.environ.get("DFP_NO_STREAM"):
            from .streaming import (plan_stream, run_streamed,
                                    stream_upload_bytes)
            # the stream TRIGGER is decided from the biggest scan directly
            # (the same candidate plan_stream picks), so that the build/
            # probe side-swap — which undoes the planner's cost-based
            # build-side choice and must not fire for resident-sized runs —
            # can be attempted exactly when streaming is required
            scans = [n for n in self.plan.walk() if isinstance(n, PScan)]
            need_stream = False
            if scans:
                big = max(scans, key=lambda s:
                          self.catalog.get(s.table_name).host.num_rows)
                live_big = self._live_columns().get(big.table_name)
                # default: stream only when the scan's upload alone exceeds
                # the budget's share of device memory: the single-program
                # path needs ~2-3x the table for packs/sorts/gather temps.
                # Streaming re-uploads every chunk across the host link each
                # iteration, so prefer in-memory whenever the table fits.
                # The row-count trigger besides the upload-bytes one: a long
                # probe OOMs on its per-launch join packs/gather temps even
                # when its (narrow) upload is small — SF100 Q22's orders is
                # 150M rows x 1 live column
                budget = memory_budget()
                reg_big = self.catalog.get(big.table_name)
                need_stream = (stream_upload_bytes(self.catalog,
                                                   big.table_name, live_big)
                               > budget.stream_bytes
                               or reg_big.host.num_rows > budget.stream_rows)
            if need_stream and os.environ.get("DFP_FORCE_GRACE"):
                # skip the streamed attempt outright: for plans whose
                # RESIDENT stream set is known to break HBM (Q7's unfiltered
                # orders⋈customer build) the streamed prepare pays a long
                # doomed compile before the OOM fallback reaches grace
                gp = self._plan_grace()
                if gp is not None:
                    return self._run_grace(gp, adaptive)
            sp = plan_stream(self.plan, self.catalog)
            if sp is None and need_stream:
                # side-swap rule: flip joins whose BUILD side carries the
                # stream candidate so the big table probes (unlocks Q8/Q9/
                # Q12-shaped plans where a filtered small side made lineitem
                # the cost-based build side)
                sp = plan_stream(self.plan, self.catalog, allow_swap=True)
            if sp is not None and need_stream:
                try:
                    # the leaf upload itself can OOM (a 150M-row resident
                    # sibling), so it sits INSIDE the fallback scope
                    live = self._live_columns().get(sp.scan.table_name)
                    resident = self._leaf_tables(
                        skip_labels=(sp.scan.label,))
                    return run_streamed(self, sp, resident, live, adaptive)
                except jax.errors.JaxRuntimeError as e:
                    # the stream's RESIDENT set (frozen builds) ran out of
                    # device memory — Q7's unfiltered 150M-row
                    # orders⋈customer build. Key-hash partitioning bounds
                    # every side.
                    gp = self._plan_grace() if is_out_of_memory(e) else None
                    if gp is None:
                        raise
                    self._drop_device_caches()
                    return self._run_grace(gp, adaptive)
            if sp is None and need_stream:
                # self-joins of the big table (Q2/Q17/Q18/Q21): no row-range
                # stream exists; grace-partition every big scan by join key
                gp = self._plan_grace()
                if gp is not None:
                    return self._run_grace(gp, adaptive)

        try:
            return self._run_resident(adaptive)
        except jax.errors.JaxRuntimeError as e:
            # a device-memory compile/run OOM downgrades to the out-of-core
            # path when one exists; every other runtime error is a bug and
            # propagates
            if not is_out_of_memory(e):
                raise
            if sp is None and not os.environ.get("DFP_NO_STREAM"):
                from .streaming import plan_stream, run_streamed
                # resident OOM'd: the side-swap is now justified even if the
                # size trigger didn't fire
                sp = plan_stream(self.plan, self.catalog, allow_swap=True)
                if sp is None:
                    gp = self._plan_grace()
                    if gp is not None:
                        self._drop_device_caches()
                        return self._run_grace(gp, adaptive)
            if sp is None:
                raise
            self._drop_device_caches()
            live = self._live_columns().get(sp.scan.table_name)
            resident = self._leaf_tables(skip_labels=(sp.scan.label,))
            try:
                return run_streamed(self, sp, resident, live, adaptive)
            except jax.errors.JaxRuntimeError as e:
                gp = self._plan_grace() if is_out_of_memory(e) else None
                if gp is None:
                    raise
                self._drop_device_caches()
                return self._run_grace(gp, adaptive)

    def _drop_device_caches(self):
        """Release every registration's cached device buffers so an
        out-of-core retry starts with free device memory — releasing only the streamed
        table left enough resident/fragmented buffers after a hard OOM abort
        that the retry OOM'd allocating its (tiny) accumulator (observed:
        SF100 Q22)."""
        self._compiled = None
        self._staged_compiled.clear()
        for node in self.plan.walk():
            if isinstance(node, PScan):
                reg = self.catalog.get(node.table_name)
                reg._device = None
                if hasattr(reg, "_device_subsets"):
                    reg._device_subsets.clear()

    def _plan_grace(self):
        import os
        if os.environ.get("DFP_NO_GRACE"):
            return None
        from .grace import plan_grace
        gp, _ = plan_grace(self.plan, self.catalog,
                           memory_budget().stream_rows)
        return gp

    def _run_grace(self, gp, adaptive):
        from .grace import run_grace
        return run_grace(self, gp, adaptive)

    def _run_resident(self, adaptive) -> DeviceTable:
        plan = self.plan
        tables = self._leaf_tables()

        # Staged execution for large plans: one XLA program holding every
        # join's packed intermediates grows with the whole plan.
        # Materializing at join boundaries bounds each launch's working set
        # and makes overflow retries per-stage. Threshold: big inputs + >1
        # join. Small queries stay single-program (fewer launches).
        total_cap = sum(t.capacity * len(t.schema.fields)
                        for t in tables.values())
        joins = find_joins(plan)
        if total_cap * 8 > memory_budget().stage_bytes and len(joins) > 1:
            return self._run_staged(tables, adaptive, joins)

        while True:
            key = (tuple(sorted(self._caps.items())),
                   tuple(sv.holder[0] for sv, _ in self.scalar_subqueries))
            if self._compiled is None or self._compiled_key != key:
                # a FRESH closure per compile: jax caches traces by function
                # identity, so reusing one closure would silently resurrect a
                # stale trace with the old capacities
                caps = dict(self._caps)

                def fn(tables, _caps=caps):
                    ctx = ExecContext(_caps)
                    out = plan.execute(tables, ctx)
                    totals = [ctx.join_totals[k] for k, _ in adaptive]
                    return out, totals

                t0 = time.time()
                lowered = jax.jit(fn).lower(tables)
                _maybe_dump_hlo(lowered, f"single_c{self.metrics.compile_count}")
                self._compiled = lowered.compile()
                # capacity defaults chosen at trace time are recorded in caps
                self._caps.update(caps)
                self._compiled_key = key
                self.metrics.compile_count += 1
                self.metrics.compile_time_s += time.time() - t0
            t0 = time.time()
            self.metrics.launches += 1
            out, totals = self._compiled(tables)
            totals = [int(t) for t in totals]   # the retry check needs them
            self.metrics.run_time_s += time.time() - t0

            overflow = False
            for (k, n), total in zip(adaptive, totals):
                # nodes fused away (filter under a global aggregate) report 0
                # and never own a capacity
                cap = self._caps.get(k, total)
                fit = round_capacity(max(total, 1), minimum=1024)
                if total > cap:
                    self._caps[k] = fit
                    overflow = True
                    _debug_retry("grow", k, n, cap, total, fit)
                elif cap > 4 * fit and cap > _SHRINK_FLOOR:
                    # shrink-on-overshoot is DEFERRED, not retried: the
                    # oversized run already produced a CORRECT result (too
                    # much capacity never truncates), so re-running buys
                    # nothing — the shrunk capacity takes effect at the next
                    # run()/compile and persists via the learned-cap store.
                    # (SF1 Q18 paid a full recompile to re-run a 4M-cap
                    # aggregate holding 62 rows before this.) Bounded to
                    # 64x per step: capacities COUPLE (a smaller build
                    # shrinks its bucket table, raising downstream false-hit
                    # candidates), so a full collapse can overshoot the
                    # other way and ping-pong.
                    self._caps[k] = max(fit, cap >> 6)
                    _debug_retry("shrink", k, n, cap, total, self._caps[k])
            self.metrics.join_caps = dict(self._caps)
            if not overflow:
                self._save_caps(adaptive)
                return out
            self.metrics.retries += 1
            self._compiled = None

    def _run_staged(self, tables, adaptive, joins) -> DeviceTable:
        """Execute join subtrees bottom-up in separate launches; each join's
        result feeds later stages through ctx.materialized (as jit ARGUMENTS,
        so retracing only happens when that stage's capacities change)."""
        # bottom-up join order: a join runs after every join beneath it
        # (identity-based: dataclass equality would deep-compare plans)
        order: List = []
        seen = set()
        join_ids = {id(j) for j in joins}

        def post(n):
            for c in n.children():
                post(c)
            if id(n) in join_ids and id(n) not in seen:
                seen.add(id(n))
                order.append(n)

        post(self.plan)
        mats: Dict[int, DeviceTable] = {}
        stages = [(True, j) for j in order if j is not self.plan]
        stages.append((False, self.plan))

        for stage_idx, (materialize, node) in enumerate(stages):
            # adaptive nodes in this subtree; ones beneath already-
            # materialized joins short-circuit and report 0 (no-ops here)
            sub_adaptive = [(k, n) for k, n in adaptive
                            if any(m is n for m in node.walk())]
            while True:
                caps = dict(self._caps)
                mat_keys = sorted(mats)
                # compiled-stage cache: repeat run() calls (bench iterations)
                # must not pay tracing+lowering per stage per call. Key on
                # the caps THIS subtree can read (later stages add unrelated
                # entries), the materialized input shapes, and baked-in
                # scalar subquery values.
                sub_ids = {k for k, _ in sub_adaptive}

                def stage_key():
                    return (
                        tuple(sorted((k, v) for k, v in self._caps.items()
                                     if k in sub_ids)),
                        tuple((k, mats[k].capacity) for k in mat_keys),
                        tuple(sv.holder[0]
                              for sv, _ in self.scalar_subqueries))

                cached = self._staged_compiled.get(stage_idx)
                mat_list = [mats[k] for k in mat_keys]
                if cached is not None and cached[0] == stage_key():
                    compiled = cached[1]
                else:
                    def fn(tables, mat_list, _caps=caps, _node=node,
                           _keys=tuple(mat_keys)):
                        ctx = ExecContext(_caps, dict(zip(_keys, mat_list)))
                        out = _node.execute(tables, ctx)
                        totals = [ctx.join_totals.get(k, jnp.int32(0))
                                  for k, _ in sub_adaptive]
                        return out, totals

                    t0 = time.time()
                    lowered = jax.jit(fn).lower(tables, mat_list)
                    _maybe_dump_hlo(lowered, f"stage{stage_idx}"
                                    f"_c{self.metrics.compile_count}")
                    compiled = lowered.compile()
                    self._caps.update(caps)
                    self.metrics.compile_count += 1
                    self.metrics.compile_time_s += time.time() - t0
                    # key under POST-trace caps so the next call's lookup
                    # (which sees the trace-time defaults) hits
                    self._staged_compiled[stage_idx] = (stage_key(), compiled)
                t0 = time.time()
                self.metrics.launches += 1
                out, totals = compiled(tables, mat_list)
                totals = [int(t) for t in totals]
                self.metrics.run_time_s += time.time() - t0

                overflow = False
                for (k, n), total in zip(sub_adaptive, totals):
                    cap = self._caps.get(k, total)
                    fit = round_capacity(max(total, 1), minimum=1024)
                    if total > cap:
                        _debug_retry("grow", k, n, cap, total, fit)
                        self._caps[k] = fit
                        overflow = True
                    elif total > 0 and cap > 4 * fit \
                            and cap > _SHRINK_FLOOR:
                        # deferred shrink, bounded to 64x per step (see
                        # _run_resident: capacity coupling can ping-pong)
                        self._caps[k] = max(fit, cap >> 6)
                        _debug_retry("shrink", k, n, cap, total,
                                     self._caps[k])
                self.metrics.join_caps = dict(self._caps)
                if not overflow:
                    break
                self.metrics.retries += 1
            if materialize:
                mats[node.join_id] = out
        self._save_caps(adaptive)
        return out

    def collect(self) -> HostTable:
        return self.run().to_host()

    def explain(self) -> str:
        return self.plan.tree()

    def analyze(self) -> str:
        """EXPLAIN ANALYZE: per-operator output rows + wall time, measured by
        jit-executing each subtree (the per-op MetricsSet the reference never
        implemented — SURVEY.md §5.5). Subtree timings include their inputs;
        read them as cumulative, like postgres EXPLAIN ANALYZE."""
        self.run()  # settle capacities / fill scalar subqueries
        tables = self._leaf_tables()
        lines = []

        def visit(node, depth):
            caps = dict(self._caps)

            def fn(tables, _caps=caps):
                ctx = ExecContext(_caps)
                out = node.execute(tables, ctx)
                return out.num_rows, out

            compiled = jax.jit(fn).lower(tables).compile()
            jax.block_until_ready(compiled(tables))
            t0 = time.time()
            n, _ = jax.block_until_ready(compiled(tables))
            dt = time.time() - t0
            lines.append("  " * depth
                         + f"{node.describe()}  [rows={int(n)} "
                         f"cumulative={dt * 1e3:.2f}ms]")
            for c in node.children():
                visit(c, depth + 1)

        visit(self.plan, 0)
        return "\n".join(lines)
