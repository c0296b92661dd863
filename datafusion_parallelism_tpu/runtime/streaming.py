"""Morsel-streaming execution: chunk the biggest scan through the plan.

Restoration of the reference's streaming dataflow: its probe side
is *pipelined* — batches from the probe stream map through the join against a
frozen build side one at a time (reference
src/operator/probe_lookup_implementation/inner.rs:48-75) with bounded queues
upstream (reference src/operator/work_stealing_repartition_exec.rs:308-329).
Our single-program executor instead materializes every table in device
memory, which caps the scale factor at what the device holds.

This module streams ONE designated scan (the largest — TPC-H lineitem)
through the compiled plan in fixed-size chunks: per chunk, upload → filter/
project/probe → PARTIAL aggregate; an on-device merge folds each chunk's
partials into an accumulator (the same decompose_for_partial machinery the
distributed two-phase aggregate uses). HBM holds the resident (non-streamed)
tables, one chunk, and the accumulator — out-of-core execution for
SF100-class inputs on a single chip.

Correctness requires the streamed scan to reach the MERGE-POINT aggregate
(the lowest aggregate above it) through per-chunk-decomposable operators:
  * Filter / Project are row-wise;
  * a join whose PROBE side carries the stream decomposes per chunk:
    - INNER / RIGHT / RIGHT_SEMI / RIGHT_ANTI emit a function of each probe
      row independently (RIGHT adds the chunk's own unmatched probe rows);
    - LEFT / FULL / LEFT_SEMI / LEFT_ANTI (build-side emitting) stream too:
      each chunk emits its probe-linear part (pairs; FULL also the chunk's
      unmatched probe rows; semi/anti nothing) while a DEVICE-RESIDENT
      visited mask over the frozen build side folds across chunks — the
      cross-chunk analog of the reference's build-side ConcurrentBitSet that
      outlives every probe batch (full.rs:77-201). After the last chunk a
      FLUSH pass per such join emits the deferred build rows (unmatched for
      LEFT/FULL/LEFT_ANTI with NULL probe columns where applicable, matched
      for LEFT_SEMI) through the remaining path — the last-stream finalizer
      (full.rs:181-201) with the barrier replaced by the end of the loop;
  * the build side of every join on the path must not contain the streamed
    scan, and no second aggregate may sit between the scan and the merge
    point. ANYTHING may sit above the merge point (outer aggregates, joins,
    sorts — Q13's double aggregate); it executes once on the merged result.
The chunk program is compiled once (all chunks share shapes); join/filter
capacity overflows retry the CURRENT chunk only, aggregate-capacity overflow
restarts the stream with the grown capacity.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


import jax
import jax.numpy as jnp

from ..models.physical import (ExecContext, PAggregate, PFilter, PHashJoin,
                               PProject, PScan, PhysicalPlan)
from ..ops.aggregate import (agg_output_schema, decompose_for_partial,
                             finish_partial, hash_aggregate_counted)
from ..ops.join import JoinType, prepare_build
from ..utils.columnar import (DeviceTable, PackedTable, concat_tables,
                              pack_host_slice, round_capacity, unpack_table)

_LINEAR_JOIN_TYPES = (JoinType.INNER, JoinType.RIGHT, JoinType.RIGHT_SEMI,
                      JoinType.RIGHT_ANTI)
# build-emitting types: stream-eligible via the cross-chunk visited mask
_VISITED_JOIN_TYPES = (JoinType.LEFT, JoinType.FULL, JoinType.LEFT_SEMI,
                       JoinType.LEFT_ANTI)


@dataclass
class StreamPlan:
    agg: PAggregate              # the cross-chunk merge point (lowest agg)
    root: PhysicalPlan           # full plan; nodes above agg run at finish
    scan: PScan                  # the streamed scan
    # build-emitting joins on the stream path, INNERMOST (closest to the
    # scan) first — the flush order: a lower join's deferred rows probe the
    # higher joins and mark their visited masks before those flush
    visited_joins: List[PHashJoin]


def _contains(node: PhysicalPlan, scan: PScan) -> bool:
    return any(n is scan for n in node.walk())


def _path_to(node: PhysicalPlan, scan: PScan) -> Optional[List[PhysicalPlan]]:
    if node is scan:
        return [node]
    for c in node.children():
        p = _path_to(c, scan)
        if p is not None:
            return [node] + p
    return None


def _swap_join(j: PHashJoin) -> None:
    """In-place build/probe side swap. Every join type remaps under a swap
    (INNER/FULL are symmetric; LEFT<->RIGHT families mirror — the same flip
    the planner's statistics-driven build-side choice uses, and the move the
    reference makes when its statistics steer build-side selection,
    reference src/lib.rs:519-547). join_id is preserved (executor capacities
    key on it); side-specific statistics seeds are reset — an undershoot
    costs one grow-retry, a stale seed can cost HBM."""
    from ..models.planner import _flip_join_type
    j.build, j.probe = j.probe, j.build
    j.build_keys, j.probe_keys = j.probe_keys, j.build_keys
    j.join_type = _flip_join_type(j.join_type)
    j.probe_mcv_share = 0.0
    j.dist_mode = "partitioned"
    j.__post_init__()


def plan_stream(plan: PhysicalPlan, catalog,
                allow_swap: bool = False) -> Optional[StreamPlan]:
    return plan_stream_ex(plan, catalog, allow_swap)[0]


def plan_stream_ex(plan: PhysicalPlan, catalog, allow_swap: bool = False):
    """-> (StreamPlan | None, rejection_reason | None).

    The single source of truth for out-of-core eligibility (the committed
    eligibility report renders these reasons verbatim). With
    `allow_swap=True`, a join on the stream path whose BUILD subtree
    carries the stream candidate is side-swapped IN PLACE (`_swap_join`) so
    the big table probes a frozen build — only call it when streaming has
    been decided (the swap undoes the planner's cost-based build-side
    choice, which is right for resident execution). Swaps are rolled back
    if a later check rejects the plan."""
    scans = [n for n in plan.walk() if isinstance(n, PScan)]
    if not scans:
        return None, "no scans"
    scan = max(scans, key=lambda s: catalog.get(s.table_name).host.num_rows)
    # the streamed TABLE must be scanned exactly once in the whole plan:
    # a second scan of it (self-join) would still have to be resident
    n_scans = sum(1 for n in plan.walk()
                  if isinstance(n, PScan) and n.table_name == scan.table_name)
    if n_scans != 1:
        return None, (f"{scan.table_name} scanned {n_scans}x (self-join): "
                      "every scan would have to be resident; chunking one "
                      "leaves the others whole")
    path = _path_to(plan, scan)
    aggs_on_path = [n for n in path if isinstance(n, PAggregate)]
    if not aggs_on_path:
        return None, ("no aggregate above the scan: the output is row-shaped "
                      "in the streamed table, so there is no bounded merge "
                      "point to fold chunks into")
    agg = aggs_on_path[-1]      # LOWEST aggregate above the scan: the merge
    # point. Everything above it (outer aggregates, joins, sorts — Q13)
    # executes once on the merged result at finish time.
    bad = [a.func for a in agg.aggs
           if a.func not in ("sum", "count", "count_star", "min", "max",
                             "avg")]
    if bad:
        return None, f"non-decomposable aggregates at merge point: {bad}"
    # identity scan, not path.index(agg): dataclass __eq__ recurses over
    # whole subtrees (O(plan) per element) and correctness would rest on
    # node_id uniqueness rather than object identity
    agg_pos = next(i for i, n in enumerate(path) if n is agg)
    sub = path[agg_pos + 1:]               # agg.child .. scan, outermost 1st
    visited_joins: List[PHashJoin] = []
    swapped: List[PHashJoin] = []

    def reject(reason):
        for j in swapped:       # _swap_join is an involution
            _swap_join(j)
        return None, reason

    for i, node in enumerate(sub[:-1]):
        if isinstance(node, (PFilter, PProject)):
            continue
        if isinstance(node, PHashJoin):
            nxt = sub[i + 1]
            if not any(m is nxt for m in node.probe.walk()):
                # stream side must be the probe side (the lookup table must
                # be frozen before any probe batch flows)
                if not allow_swap:
                    return reject(
                        f"{scan.table_name} is the BUILD side of a "
                        f"{node.join_type.value} join: the lookup table "
                        "must be frozen before any probe batch flows")
                _swap_join(node)
                swapped.append(node)
            if node.join_type in _VISITED_JOIN_TYPES:
                visited_joins.append(node)
            elif node.join_type not in _LINEAR_JOIN_TYPES:
                return reject(f"join type {node.join_type.value} on the "
                              "stream path is neither probe-linear nor "
                              "visited-streamable")
            continue
        if isinstance(node, PAggregate):
            return reject("a second aggregate sits between the scan and the "
                          "merge point")
        # PSort / PLimit between the scan and the merge point
        return reject(f"{node.__class__.__name__} between the scan and the "
                      "merge point is not row-decomposable")
    if swapped:
        # a swap reorders the join's output columns; recompute every
        # ancestor schema bottom-up (consumers resolve by NAME, but the
        # plan-time Schema field order must match what executes)
        for anc in reversed(path[:-1]):
            if hasattr(anc, "__post_init__"):
                anc.__post_init__()
    visited_joins.reverse()                # innermost first = flush order
    return StreamPlan(agg, plan, scan, visited_joins), None


def stream_upload_bytes(catalog, table_name: str, live_cols) -> int:
    reg = catalog.get(table_name)
    cols = live_cols or set(reg.host.schema.names)
    return sum(v.nbytes + valid.nbytes
               for n, (v, valid) in reg.host.columns.items() if n in cols)


def _chunk_arrays(reg, live_cols, lo: int, chunk_rows: int, label: str):
    """Host-pack rows [lo, lo+chunk_rows) of the live columns into ONE
    [W, chunk_rows] matrix (+ f64 columns): a single host->device transfer
    per chunk instead of one padded upload per column. Returns
    (schema, layout, packed, f64s, n)."""
    n = min(chunk_rows, reg.host.num_rows - lo)
    schema, layout, packed, f64s = pack_host_slice(
        reg.host, live_cols, lo, n, chunk_rows,
        rename_prefix=f"{label}.")
    return schema, layout, packed, f64s, n


def _flush_input(J: PHashJoin, build: DeviceTable,
                 vis: jnp.ndarray) -> DeviceTable:
    """The deferred build-side emission of a streamed build-emitting join,
    shaped as J's OUTPUT: matched build rows for LEFT_SEMI, unmatched for
    LEFT_ANTI, unmatched + NULL probe columns for LEFT/FULL (reference
    finalizer emissions, full.rs:181-201 / left_semi.rs:166)."""
    from ..utils.columnar import filter_rows, hstack_tables, null_columns_like
    bin_ = build.row_mask()
    if J.join_type is JoinType.LEFT_SEMI:
        return filter_rows(build, bin_ & vis)
    if J.join_type is JoinType.LEFT_ANTI:
        return filter_rows(build, bin_ & ~vis)
    ub = filter_rows(build, bin_ & ~vis)
    nulls = DeviceTable(J.probe.schema,
                        null_columns_like(J.probe.schema, ub.capacity),
                        ub.num_rows)
    return hstack_tables(ub, nulls, ub.num_rows)


def run_streamed(handle, sp: StreamPlan, resident: Dict[str, DeviceTable],
                 live_cols, adaptive) -> DeviceTable:
    """Drive the chunk loop. `handle` is the owning QueryHandle (capacities,
    metrics); `resident` is its _leaf_tables() WITHOUT the streamed label."""
    agg = sp.agg
    reg = handle.catalog.get(sp.scan.table_name)
    chunk_rows = int(os.environ.get("DFP_STREAM_CHUNK_ROWS", 1 << 22))
    chunk_rows = round_capacity(min(chunk_rows,
                                    max(1024, reg.host.num_rows)))
    n_chunks = -(-reg.host.num_rows // chunk_rows)

    partial_specs, merge_specs, finishers = decompose_for_partial(agg.aggs)
    partial_schema = agg_output_schema(agg.child.schema, agg.group_keys,
                                       partial_specs)
    vjoins = sp.visited_joins          # innermost first (flush order)
    vids = [j.join_id for j in vjoins]

    # Joins on the stream path probe a FROZEN build side: their build
    # subtrees are stream-free (guaranteed by plan_stream), so the lookup
    # structures are built ONCE and passed into the chunk program as
    # arguments instead of being rebuilt per chunk — the reference's
    # build-once / probe-stream split (inner.rs:48-75).
    path_joins = [n for n in agg.child.walk()
                  if isinstance(n, PHashJoin) and _contains(n.probe, sp.scan)]
    prep_nodes = {id(m) for j in path_joins for m in j.build.walk()}
    prep_adaptive = [(k, n) for k, n in adaptive if id(n) in prep_nodes]
    # adaptive nodes inside the chunk program (stream path only);
    # the agg's own capacity doubles as the accumulator capacity
    sub_adaptive = [(k, n) for k, n in adaptive
                    if n is not agg and id(n) not in prep_nodes
                    and any(m is n for m in agg.child.walk())]

    # prepare program: execute every frozen build subtree, with the usual
    # overflow-retry loop around its adaptive nodes
    prepared = {}
    if path_joins:
        while True:
            caps = dict(handle._caps)

            def prep_fn(resident, _caps=caps):
                ctx = ExecContext(_caps)
                out = {}
                for j in path_joins:
                    b = j.build.execute(resident, ctx)
                    out[j.join_id] = prepare_build(b, j.build_keys,
                                                   j.strategy)
                totals = [ctx.join_totals.get(k, jnp.int32(0))
                          for k, _ in prep_adaptive]
                return out, totals

            t0 = time.time()
            compiled_prep = jax.jit(prep_fn).lower(resident).compile()
            handle._caps.update(caps)
            handle.metrics.compile_count += 1
            handle.metrics.compile_time_s += time.time() - t0
            t0 = time.time()
            handle.metrics.launches += 1
            prepared, totals = compiled_prep(resident)
            totals = [int(t) for t in totals]
            handle.metrics.run_time_s += time.time() - t0
            overflow = False
            for (k, _), total in zip(prep_adaptive, totals):
                cap = handle._caps.get(k, total)
                if total > cap:
                    handle._caps[k] = round_capacity(max(total, 1),
                                                     minimum=1024)
                    overflow = True
            if not overflow:
                break
            handle.metrics.retries += 1

    while True:   # aggregate-capacity (accumulator) restarts
        agg_cap = handle._caps.get(agg.node_id)
        if agg_cap is None:
            # clamp the planner's group estimate hard: cross-table composite
            # keys can be wildly overestimated (the single-chip path clamps
            # by child.capacity; here the analogs are the stream table's row
            # count and a 4M accumulator ceiling — the overflow restart
            # covers true undershoot, and the settled capacity persists)
            est = (round_capacity(int(2 * agg.est_groups))
                   if agg.est_groups > 0 else 1 << 16)
            # 16M ceiling (was 4M): per-customer-level group counts at SF100
            # are ~15M and a low ceiling guarantees 2-3 FULL stream restarts
            # (every restart replays every chunk); the overflow restart still
            # covers genuine undershoot and the deferred shrink + cap store
            # trim real overshoot after the first run
            agg_cap = max(128, min(est,
                                   round_capacity(max(1024,
                                                      reg.host.num_rows)),
                                   1 << 24))
            handle._caps[agg.node_id] = agg_cap

        chunk_schema, chunk_layout, _, _, _ = _chunk_arrays(
            reg, live_cols, 0, chunk_rows, sp.scan.label)

        def make_step():
            caps = dict(handle._caps)

            def step(resident, packed, f64s, chunk_n, acc_cols, acc_rows,
                     vis_list, prepared, _caps=caps):
                ctx = ExecContext(_caps, prepared=prepared)
                ctx.stream_visited = dict(zip(vids, vis_list))
                tables = dict(resident)
                # reconstruct the chunk from its single packed upload
                # (unpack is elementwise bit ops — fused for free)
                tables[sp.scan.label] = unpack_table(
                    PackedTable(packed, f64s, chunk_layout), chunk_schema,
                    chunk_n)
                child, row_filter = agg.fused_child(tables, ctx)
                partial, _ = hash_aggregate_counted(
                    child, agg.group_keys, partial_specs, agg_cap, row_filter)
                acc = DeviceTable(partial_schema, acc_cols, acc_rows)
                merged, mtotal = hash_aggregate_counted(
                    concat_tables([acc, partial]), agg.group_keys,
                    merge_specs, agg_cap)
                totals = [ctx.join_totals.get(k, jnp.int32(0))
                          for k, _ in sub_adaptive]
                new_vis = [ctx.visited_out[v] for v in vids]
                return (merged.columns, merged.num_rows, mtotal, new_vis,
                        totals)

            return caps, jax.jit(step)

        caps, step = make_step()
        compiled = None
        # global aggregates produce a single-row table; the accumulator must
        # match the merge output's capacity exactly
        acc_cap = agg_cap if agg.group_keys else 1
        if os.environ.get("DFP_STREAM_DEBUG"):
            print(f"[stream] agg_cap={agg_cap} acc_cap={acc_cap} "
                  f"chunk_rows={chunk_rows} n_chunks={n_chunks} "
                  f"caps={dict(handle._caps)}", flush=True)
        acc_cols = {f.name: (jnp.zeros((acc_cap,), f.dtype.device_dtype),
                             jnp.zeros((acc_cap,), jnp.bool_))
                    for f in partial_schema.fields}
        acc_rows = jnp.int32(0)
        # device-resident visited accumulators, one per build-emitting join
        # on the path (bool over its FROZEN build capacity)
        vis_list = [jnp.zeros((prepared[j.join_id].build.capacity,),
                              jnp.bool_) for j in vjoins]
        restart = False
        handle.metrics.streamed_chunks = 0

        # Double-buffered chunk loop: chunk i's device compute overlaps the
        # HOST PACKING of chunk i+1 (dispatch is async; the blocking int()
        # validation of chunk i is deferred until after chunk i+1 is
        # packed). On overflow the pending chunk re-runs from its saved
        # input accumulator — nothing later has been dispatched yet.
        debug = bool(os.environ.get("DFP_STREAM_DEBUG"))
        pending = None   # (idx, acc_in, outs): dispatched, not yet validated
        mtotal = 0

        def validate(pending):
            """-> (ok, mtotal). Blocks on the pending chunk's scalars."""
            nonlocal restart, compiled, caps, step
            idx, _, (new_cols, new_rows, mt, _nv, tot) = pending
            t0 = time.time()
            mt = int(mt)
            tot = [int(x) for x in tot]
            handle.metrics.run_time_s += time.time() - t0
            if debug:
                print(f"[stream] chunk {idx} mtotal={mt} totals={tot}",
                      flush=True)
            overflow = False
            for (k, _), total in zip(sub_adaptive, tot):
                cap = handle._caps.get(k, total)
                if total > cap:
                    handle._caps[k] = round_capacity(max(total, 1),
                                                     minimum=1024)
                    overflow = True
            if overflow:
                # joins/filters are per-chunk stateless: recompile and
                # retry the pending chunk with the grown capacities
                handle.metrics.retries += 1
                caps, step = make_step()
                compiled = None
                return False, mt
            if mt > agg_cap:
                # accumulator overflow: every prior chunk's fold was
                # truncated — grow and restart the stream
                handle._caps[agg.node_id] = round_capacity(
                    max(mt, 2 * agg_cap), minimum=1024)
                handle.metrics.retries += 1
                restart = True
                return False, mt
            handle.metrics.streamed_chunks += 1
            return True, mt

        i = 0
        while i < n_chunks and not restart:
            t0 = time.time()
            _, _, packed, f64s, chunk_n = _chunk_arrays(
                reg, live_cols, i * chunk_rows, chunk_rows, sp.scan.label)
            handle.metrics.host_pack_s += time.time() - t0
            chunk_n = jnp.int32(chunk_n)
            # start the async host->device transfer NOW, before blocking on
            # the pending chunk's scalars: the upload then overlaps chunk
            # i-1's compute
            t0u = time.time()
            packed, f64s = jax.device_put((packed, f64s))
            handle.metrics.upload_s += time.time() - t0u
            if debug:
                print(f"[stream] chunk {i} packed in {time.time()-t0:.2f}s",
                      flush=True)
            if pending is not None:
                ok, mtotal = validate(pending)
                if not ok:
                    if restart:
                        break
                    # re-run the failed chunk from its input accumulator
                    i, (acc_cols, acc_rows, vis_list) = pending[0], pending[1]
                    pending = None
                    continue
                acc_cols, acc_rows = pending[2][0], pending[2][1]
                vis_list = pending[2][3]
                pending = None
            if compiled is None:
                t0 = time.time()
                compiled = step.lower(resident, packed, f64s, chunk_n,
                                      acc_cols, acc_rows, vis_list,
                                      prepared).compile()
                handle._caps.update(caps)
                handle.metrics.compile_count += 1
                handle.metrics.compile_time_s += time.time() - t0
            handle.metrics.launches += 1
            outs = compiled(resident, packed, f64s, chunk_n, acc_cols,
                            acc_rows, vis_list, prepared)
            pending = (i, (acc_cols, acc_rows, vis_list), outs)
            i += 1
        while pending is not None and not restart:
            ok, mtotal = validate(pending)
            if not ok:
                if restart:
                    break
                idx, (acc_cols, acc_rows, vis_list) = pending[0], pending[1]
                pending = None
                t0 = time.time()
                _, _, packed, f64s, chunk_n = _chunk_arrays(
                    reg, live_cols, idx * chunk_rows, chunk_rows,
                    sp.scan.label)
                chunk_n = jnp.int32(chunk_n)
                compiled = step.lower(resident, packed, f64s, chunk_n,
                                      acc_cols, acc_rows, vis_list,
                                      prepared).compile()
                handle._caps.update(caps)
                handle.metrics.compile_count += 1
                handle.metrics.compile_time_s += time.time() - t0
                handle.metrics.launches += 1
                outs = compiled(resident, packed, f64s, chunk_n, acc_cols,
                                acc_rows, vis_list, prepared)
                pending = (idx, (acc_cols, acc_rows, vis_list), outs)
                continue
            acc_cols, acc_rows = pending[2][0], pending[2][1]
            vis_list = pending[2][3]
            pending = None
        if restart:
            continue

        # FLUSH passes: one per build-emitting join, innermost first — emit
        # the deferred build rows as that join's output and run the path
        # ABOVE it (marking higher joins' visited masks as these rows probe
        # them), folding into the same accumulator. The reference's
        # last-stream finalizer (full.rs:181-201), with the stream barrier
        # replaced by the end of the chunk loop.
        for k, J in enumerate(vjoins):
            flush_ok = False
            while not flush_ok:
                fcaps = dict(handle._caps)

                def flush_fn(resident, vis_list, acc_cols, acc_rows,
                             prepared, _caps=fcaps, _k=k, _J=J):
                    ctx = ExecContext(_caps, prepared=prepared)
                    ctx.stream_visited = {
                        j.join_id: vis_list[idx]
                        for idx, j in enumerate(vjoins) if idx > _k}
                    X = _flush_input(_J, prepared[_J.join_id].build,
                                     vis_list[_k])
                    ctx.materialized = {_J.join_id: X}
                    child, row_filter = agg.fused_child(resident, ctx)
                    partial, _ = hash_aggregate_counted(
                        child, agg.group_keys, partial_specs, agg_cap,
                        row_filter)
                    acc = DeviceTable(partial_schema, acc_cols, acc_rows)
                    merged, mtotal = hash_aggregate_counted(
                        concat_tables([acc, partial]), agg.group_keys,
                        merge_specs, agg_cap)
                    new_vis = [ctx.visited_out.get(j.join_id, vis_list[idx])
                               for idx, j in enumerate(vjoins)]
                    totals = [ctx.join_totals.get(kk, jnp.int32(0))
                              for kk, _ in sub_adaptive]
                    return (merged.columns, merged.num_rows, mtotal, new_vis,
                            totals)

                t0 = time.time()
                compiled_fl = jax.jit(flush_fn).lower(
                    resident, vis_list, acc_cols, acc_rows,
                    prepared).compile()
                handle._caps.update(fcaps)
                handle.metrics.compile_count += 1
                handle.metrics.compile_time_s += time.time() - t0
                t0 = time.time()
                handle.metrics.launches += 1
                outs = compiled_fl(resident, vis_list, acc_cols, acc_rows,
                                   prepared)
                mt = int(outs[2])
                tot = [int(x) for x in outs[4]]
                handle.metrics.run_time_s += time.time() - t0
                if debug:
                    print(f"[stream] flush join {J.join_id} mtotal={mt} "
                          f"totals={tot}", flush=True)
                overflow = False
                for (kk, _), total in zip(sub_adaptive, tot):
                    cap = handle._caps.get(kk, total)
                    if total > cap:
                        handle._caps[kk] = round_capacity(max(total, 1),
                                                          minimum=1024)
                        overflow = True
                if overflow:
                    handle.metrics.retries += 1
                    continue          # recompile this flush with grown caps
                if mt > agg_cap:
                    # new groups from the deferred rows overflowed the
                    # accumulator: grow and restart the whole stream
                    handle._caps[agg.node_id] = round_capacity(
                        max(mt, 2 * agg_cap), minimum=1024)
                    handle.metrics.retries += 1
                    restart = True
                    break
                acc_cols, acc_rows = outs[0], outs[1]
                vis_list = outs[3]
                mtotal = mt
                flush_ok = True
            if restart:
                break
        if restart:
            continue

        # persist the settled capacities (with the aggregate shrunk to its
        # true group count) so later processes compile the final shapes
        # directly — same contract as the materialized executor
        fit = round_capacity(max(mtotal, 1), minimum=1024)
        if agg_cap > 4 * fit:
            handle._caps[agg.node_id] = fit
        handle.metrics.join_caps = dict(handle._caps)
        handle._save_caps(adaptive)

        # finish: complete the merge-point aggregate, then run the REST of
        # the plan above it (outer aggregates / joins / sorts — e.g. Q13's
        # second aggregate) on the finished result, with overflow retries
        # for any adaptive nodes above the merge point
        head_adaptive = [(kk, n) for kk, n in adaptive
                         if not any(m is n for m in agg.walk())]
        while True:
            hcaps = dict(handle._caps)

            def finish_fn(acc_cols, acc_rows, resident, _caps=hcaps):
                acc = DeviceTable(partial_schema, acc_cols, acc_rows)
                out = finish_partial(acc, agg.group_keys, agg.aggs,
                                     finishers, agg.child.schema)
                if sp.root is agg:
                    return out, []
                ctx = ExecContext(_caps)
                ctx.materialized = {agg.node_id: out}
                res = sp.root.execute(resident, ctx)
                totals = [ctx.join_totals.get(kk, jnp.int32(0))
                          for kk, _ in head_adaptive]
                return res, totals

            t0 = time.time()
            compiled_fin = jax.jit(finish_fn).lower(acc_cols, acc_rows,
                                                    resident).compile()
            handle._caps.update(hcaps)
            handle.metrics.compile_count += 1
            handle.metrics.compile_time_s += time.time() - t0
            handle.metrics.launches += 1
            out, totals = compiled_fin(acc_cols, acc_rows, resident)
            totals = [int(x) for x in totals]
            overflow = False
            for (kk, _), total in zip(head_adaptive, totals):
                cap = handle._caps.get(kk, total)
                if total > cap:
                    handle._caps[kk] = round_capacity(max(total, 1),
                                                      minimum=1024)
                    overflow = True
            if not overflow:
                handle._save_caps(adaptive)
                return out
            handle.metrics.retries += 1
