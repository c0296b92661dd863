"""Distributed morsel streaming: chunk the biggest scan through the SPMD
plan — streaming and distribution COMPOSED (BASELINE config #5's shape:
out-of-core scale factors on an N-device mesh with shuffle/compute overlap).

Division of labor per chunk:
  * HOST: slice the next chunk's live columns into P contiguous shards and
    start the async upload (double-buffered: chunk i+1 packs and uploads
    while chunk i computes — the only work the host does per chunk);
  * DEVICES (one shard_map program, compiled once): shuffle the chunk to
    each path join's frozen build key range, probe, partial
    aggregate LOCALLY, and fold into a per-device accumulator. No
    cross-device collective touches the accumulator until finish.

Frozen build sides are computed ONCE by a prepare program (each path join's
build subtree executes distributed, shuffles to its key range, and builds
its lookup table per device); they stay resident as sharded pytrees across
all chunks — the reference's build-once / probe-stream split (reference
src/operator/probe_lookup_implementation/inner.rs:48-75) lifted onto a mesh.

Build-emitting joins (LEFT/FULL/LEFT_SEMI/LEFT_ANTI) stream with PER-DEVICE
visited masks over their local build shards (hash partitioning puts every
build row on exactly one device, so local masks compose exactly); flush
passes after the last chunk emit the deferred build rows through the path
(runtime/streaming.py's single-chip design, distributed).

The per-chunk timeline (host pack/upload vs device compute windows) is
recorded in handle.metrics.stream_timeline — the shuffle/compute-overlap
evidence artifact (reference gets overlap implicitly from pipelined tokio
streams; here the double buffer makes it explicit and measurable).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial as fpartial
from jax import lax
from jax.sharding import PartitionSpec as P

from ..models.physical import ExecContext, PHashJoin
from ..ops.aggregate import (agg_output_schema, decompose_for_partial,
                             finish_partial, hash_aggregate,
                             hash_aggregate_counted)
from ..ops.join import prepare_build
from ..parallel.distributed import _all_gather_table
from ..parallel.shuffle import (get_comm_bytes, local_table, reset_comm_bytes,
                                shuffle_by_hash, unlocal_table)
from ..utils.columnar import (DeviceTable, Schema, concat_tables,
                              round_capacity)
from .distributed_executor import execute_dist
from .streaming import StreamPlan, _contains, _flush_input


def _unlocal_tree(tree):
    """Re-add the length-1 shard axis to every leaf (shard_map out_specs)."""
    return jax.tree_util.tree_map(lambda x: x[None], tree)


def _local_tree(tree):
    """Strip the length-1 shard axis from every leaf inside shard_map."""
    return jax.tree_util.tree_map(lambda x: x[0], tree)


def _chunk_shards(reg, live_names: List[str], label: str, lo: int,
                  chunk_rows: int, Pn: int):
    """Host-slice rows [lo, lo+chunk_rows) of the live columns into P
    contiguous shards ([P, per] arrays). Returns (cols, num_rows)."""
    n = max(0, min(chunk_rows, reg.host.num_rows - lo))
    per = chunk_rows // Pn
    num_rows = np.zeros((Pn,), np.int32)
    cols = {}
    for name in live_names:
        v, valid = reg.host.columns[name]
        sv = np.zeros((Pn, per), dtype=v.dtype)
        svalid = np.zeros((Pn, per), dtype=np.bool_)
        for p in range(Pn):
            a, b = lo + p * per, lo + min((p + 1) * per, n)
            k = max(b - a, 0)
            num_rows[p] = k
            if k:
                sv[p, :k] = v[a:b]
                svalid[p, :k] = valid[a:b]
        cols[f"{label}.{name}"] = (sv, svalid)
    return cols, num_rows


def run_streamed_dist(handle, sp: StreamPlan, live, adaptive):
    """Drive the distributed chunk loop. `handle` is the owning
    DistributedQueryHandle (mesh, capacities, metrics)."""
    agg, axis, mesh = sp.agg, handle.axis, handle.mesh
    Pn = mesh.devices.size
    reg = handle.catalog.get(sp.scan.table_name)
    live_names = sorted((live or set(reg.host.schema.names))
                        & set(reg.host.schema.names)) \
        or [reg.host.schema.names[0]]
    chunk_rows = int(os.environ.get("DFP_STREAM_CHUNK_ROWS", 1 << 22))
    chunk_rows = round_capacity(min(chunk_rows,
                                    max(Pn * 128, reg.host.num_rows)))
    chunk_rows = max(Pn, chunk_rows - chunk_rows % Pn)
    n_chunks = -(-reg.host.num_rows // chunk_rows)
    chunk_schema = Schema([f for f in sp.scan.schema.fields
                           if f.name.split(".", 1)[-1] in live_names])
    per = chunk_rows // Pn

    labels, leaf_cols, leaf_rows, schemas, multiproc = handle._shard_inputs(
        skip_labels=(sp.scan.label,))
    if multiproc:
        raise NotImplementedError("streamed distributed execution is "
                                  "single-process SPMD for now")
    root_sort = handle._root_local_sort()
    local_ids = (frozenset({id(root_sort)}) if root_sort is not None
                 else frozenset())

    partial_specs, merge_specs, finishers = decompose_for_partial(agg.aggs)
    partial_schema = agg_output_schema(agg.child.schema, agg.group_keys,
                                       partial_specs)
    vjoins = sp.visited_joins
    vids = [j.join_id for j in vjoins]
    path_joins = [n for n in agg.child.walk()
                  if isinstance(n, PHashJoin) and _contains(n.probe, sp.scan)]
    pids = [j.join_id for j in path_joins]
    prep_nodes = {id(m) for j in path_joins for m in j.build.walk()}
    # adaptive keys owned by the prepare program: nodes inside the frozen
    # build subtrees (their joins carry shuffle-drop counters too) plus the
    # co-partitioning shuffle of each frozen build
    prep_join_ids = [n.join_id for j in path_joins for n in j.build.walk()
                     if isinstance(n, PHashJoin)]
    prep_keys = [k for jid in prep_join_ids
                 for k in (jid, (jid, "bs"), (jid, "ps"))]
    prep_keys += [(jid, "bs") for jid in pids]
    prep_keys += [k for k, n in adaptive
                  if id(n) in prep_nodes and not isinstance(n, PHashJoin)]
    # adaptive keys inside the chunk program: path joins (candidate caps +
    # probe-chunk shuffle drops) and any filter/agg nodes on the path
    sub_keys = [k for jid in pids for k in (jid, (jid, "ps"))]
    sub_keys += [k for k, n in adaptive
                 if n is not agg and id(n) not in prep_nodes
                 and not isinstance(n, PHashJoin)
                 and any(m is n for m in agg.child.walk())]
    debug = bool(os.environ.get("DFP_STREAM_DEBUG"))

    def grow(keys, totals) -> bool:
        overflow = False
        for k, total in zip(keys, totals):
            if isinstance(k, tuple):
                if total > 0:      # dropped shuffle rows: double the block
                    handle._caps[k] = 2 * handle._caps[k]
                    overflow = True
                continue
            cap = handle._caps.get(k, total)
            if total > cap:
                handle._caps[k] = round_capacity(max(total, 1), minimum=1024)
                overflow = True
        return overflow

    # ---- prepare program: freeze every path join's build side ------------
    prepared_global = None
    while True:
        caps = dict(handle._caps)

        @fpartial(jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
                  out_specs=(P(axis), P()))
        def prep(leaf_cols, leaf_rows, _caps=caps):
            tables = {l: local_table(schemas[l], c, r)
                      for l, c, r in zip(labels, leaf_cols, leaf_rows)}
            ctx = ExecContext(_caps)
            P_ = lax.psum(1, axis)
            out = []
            for j in path_joins:
                b = execute_dist(j.build, tables, ctx, axis)
                skey = (j.join_id, "bs")
                scap = ctx.join_caps.get(skey)
                if scap is None:
                    scap = min(b.capacity,
                               max(1024, 4 * (b.capacity // max(P_, 1))))
                    ctx.join_caps[skey] = scap
                b2, bdrop = shuffle_by_hash(b, j.build_keys, scap, axis)
                ctx.join_totals[skey] = bdrop
                out.append(prepare_build(b2, j.build_keys, j.strategy))
            totals = jnp.stack(
                [jnp.asarray(ctx.join_totals.get(k, 0), jnp.int32)
                 for k in prep_keys]) if prep_keys \
                else jnp.zeros((0,), jnp.int32)
            return _unlocal_tree(out), totals

        t0 = time.time()
        reset_comm_bytes()
        compiled_prep = jax.jit(prep).lower(leaf_cols, leaf_rows).compile()
        prep_comm = get_comm_bytes()
        handle._caps.update(caps)
        handle.metrics.compile_count += 1
        handle.metrics.compile_time_s += time.time() - t0
        t0 = time.time()
        prepared_global, totals = compiled_prep(leaf_cols, leaf_rows)
        totals = [int(t) for t in totals]
        handle.metrics.run_time_s += time.time() - t0
        if not grow(prep_keys, totals):
            break
        handle.metrics.retries += 1

    total_comm = prep_comm

    # ---- chunk loop ------------------------------------------------------
    while True:   # aggregate-capacity (accumulator) restarts
        agg_cap = handle._caps.get(agg.node_id)
        if agg_cap is None:
            est = (round_capacity(int(2 * agg.est_groups))
                   if agg.est_groups > 0 else 1 << 16)
            # 16M ceiling — see runtime/streaming.py: a low ceiling forces
            # full stream restarts for customer-level group counts at SF100
            agg_cap = max(128, min(est,
                                   round_capacity(max(1024,
                                                      reg.host.num_rows)),
                                   1 << 24))
            handle._caps[agg.node_id] = agg_cap

        def make_step():
            caps = dict(handle._caps)

            @fpartial(jax.shard_map, mesh=mesh,
                      in_specs=(P(axis), P(axis), P(axis), P(axis),
                                P(axis), P(axis), P(axis), P(axis)),
                      out_specs=(P(axis), P(axis), P(), P(axis), P()))
            def step(leaf_cols, leaf_rows, chunk_cols, chunk_rows_,
                     acc_cols, acc_rows, vis_list, prepared, _caps=caps):
                ctx = ExecContext(_caps,
                                  prepared=dict(zip(pids,
                                                    _local_tree(prepared))))
                ctx.stream_visited = dict(zip(vids, _local_tree(vis_list)))
                tables = {l: local_table(schemas[l], c, r)
                          for l, c, r in zip(labels, leaf_cols, leaf_rows)}
                tables[sp.scan.label] = local_table(chunk_schema, chunk_cols,
                                                    chunk_rows_)
                from .distributed_executor import _dist_fused_child
                child, row_filter = _dist_fused_child(agg, tables, ctx, axis)
                partial, _ = hash_aggregate_counted(
                    child, agg.group_keys, partial_specs, agg_cap, row_filter)
                acc = DeviceTable(partial_schema, _local_tree(acc_cols),
                                  acc_rows[0])
                merged, mtotal = hash_aggregate_counted(
                    concat_tables([acc, partial]), agg.group_keys,
                    merge_specs, agg_cap)
                totals = jnp.stack(
                    [jnp.asarray(ctx.join_totals.get(k, 0), jnp.int32)
                     for k in sub_keys]) if sub_keys \
                    else jnp.zeros((0,), jnp.int32)
                new_vis = [ctx.visited_out[v] for v in vids]
                return (_unlocal_tree(merged.columns),
                        merged.num_rows[None],
                        lax.pmax(mtotal, axis),
                        _unlocal_tree(new_vis), totals)

            return caps, step

        caps, step = make_step()
        compiled = None
        # global aggregates produce a single-row table; the accumulator must
        # match the merge output's capacity exactly
        acc_cap = agg_cap if agg.group_keys else 1
        acc_cols = {f.name: (jnp.zeros((Pn, acc_cap), f.dtype.device_dtype),
                             jnp.zeros((Pn, acc_cap), jnp.bool_))
                    for f in partial_schema.fields}
        acc_rows = jnp.zeros((Pn,), jnp.int32)
        # per-device visited accumulators over the frozen LOCAL build
        # shards: global [P, local_cap] (same sharding convention as the
        # prepared builds' column leaves)
        pidx = {id(j): i for i, j in enumerate(path_joins)}
        vis_list = []
        for j in vjoins:
            pb = prepared_global[pidx[id(j)]]
            local_cap = next(iter(pb.build.columns.values()))[0].shape[1]
            vis_list.append(jnp.zeros((Pn, local_cap), jnp.bool_))
        restart = False
        handle.metrics.streamed_chunks = 0
        handle.metrics.stream_timeline = []
        timeline = handle.metrics.stream_timeline
        t_origin = time.perf_counter()

        def now():
            return time.perf_counter() - t_origin

        pending = None   # (idx, state_in, outs): dispatched, not validated
        mtotal = 0

        def validate(pending):
            nonlocal restart, compiled, caps, step
            idx, _, (nc, nr, mt, nv, tot) = pending
            t0 = time.time()
            mt = int(mt)
            tot = [int(x) for x in tot]
            handle.metrics.run_time_s += time.time() - t0
            timeline.append({"event": "validated", "chunk": idx, "t": now()})
            if debug:
                print(f"[dstream] chunk {idx} mtotal={mt} totals={tot}",
                      flush=True)
            if grow(sub_keys, tot):
                handle.metrics.retries += 1
                caps, step = make_step()
                compiled = None
                return False, mt
            if mt > agg_cap:
                handle._caps[agg.node_id] = round_capacity(
                    max(mt, 2 * agg_cap), minimum=1024)
                handle.metrics.retries += 1
                restart = True
                return False, mt
            handle.metrics.streamed_chunks += 1
            return True, mt

        chunk_comm = [0]       # per-chunk bytes of the CURRENT executable
        dispatched_comm = [0]  # accumulated over every dispatched launch

        def dispatch(idx, state, chunk_cols, chunk_rows_):
            nonlocal compiled, caps
            acc_cols, acc_rows, vis_list = state
            if compiled is None:
                t0 = time.time()
                reset_comm_bytes()
                compiled = jax.jit(step).lower(
                    leaf_cols, leaf_rows, chunk_cols, chunk_rows_,
                    acc_cols, acc_rows, vis_list, prepared_global).compile()
                # per-chunk collective bytes: the probe-chunk shuffles (the
                # frozen builds never move again); multiplied by the chunk
                # count once the stream completes
                chunk_comm[0] = get_comm_bytes()
                handle._caps.update(caps)
                handle.metrics.compile_count += 1
                handle.metrics.compile_time_s += time.time() - t0
            outs = compiled(leaf_cols, leaf_rows, chunk_cols, chunk_rows_,
                            acc_cols, acc_rows, vis_list, prepared_global)
            # accumulate per DISPATCHED launch (retries included) with the
            # bytes captured for the executable that actually ran — a
            # mid-stream overflow recompile changes the per-chunk volume
            dispatched_comm[0] += chunk_comm[0]
            timeline.append({"event": "dispatch", "chunk": idx, "t": now()})
            return (idx, state, outs)

        i = 0
        while i < n_chunks and not restart:
            # pack + start the async upload of chunk i BEFORE blocking on
            # chunk i-1's scalars: host packing and the device round trip
            # overlap device compute (the double buffer)
            t0 = now()
            ccols, crows = _chunk_shards(reg, live_names, sp.scan.label,
                                         i * chunk_rows, chunk_rows, Pn)
            ccols, crows = jax.device_put((ccols, crows))
            timeline.append({"event": "pack_upload", "chunk": i,
                             "t0": t0, "t1": now()})
            if pending is not None:
                ok, mtotal = validate(pending)
                if not ok:
                    if restart:
                        break
                    i, state = pending[0], pending[1]
                    pending = None
                    ccols, crows = _chunk_shards(reg, live_names,
                                                 sp.scan.label,
                                                 i * chunk_rows, chunk_rows,
                                                 Pn)
                    ccols, crows = jax.device_put((ccols, crows))
                    pending = dispatch(i, state, ccols, crows)
                    i += 1
                    continue
                o = pending[2]
                state = (o[0], o[1], o[3])
                pending = None
            else:
                state = (acc_cols, acc_rows, vis_list)
            pending = dispatch(i, state, ccols, crows)
            i += 1
        while pending is not None and not restart:
            ok, mtotal = validate(pending)
            if not ok:
                if restart:
                    break
                idx, state = pending[0], pending[1]
                pending = None
                ccols, crows = _chunk_shards(reg, live_names, sp.scan.label,
                                             idx * chunk_rows, chunk_rows,
                                             Pn)
                ccols, crows = jax.device_put((ccols, crows))
                pending = dispatch(idx, state, ccols, crows)
                continue
            o = pending[2]
            acc_cols, acc_rows, vis_list = o[0], o[1], o[3]
            pending = None
        if restart:
            continue

        # ---- flush passes (deferred build-side emission) -----------------
        for k, J in enumerate(vjoins):
            flush_ok = False
            while not flush_ok:
                fcaps = dict(handle._caps)

                @fpartial(jax.shard_map, mesh=mesh,
                          in_specs=(P(axis), P(axis), P(axis), P(axis),
                                    P(axis), P(axis)),
                          out_specs=(P(axis), P(axis), P(), P(axis), P()))
                def flush(leaf_cols, leaf_rows, vis_list, acc_cols,
                          acc_rows, prepared, _caps=fcaps, _k=k, _J=J):
                    prep_l = _local_tree(prepared)
                    vis_l = _local_tree(vis_list)
                    ctx = ExecContext(_caps,
                                      prepared=dict(zip(pids, prep_l)))
                    ctx.stream_visited = {
                        j.join_id: vis_l[idx]
                        for idx, j in enumerate(vjoins) if idx > _k}
                    tables = {l: local_table(schemas[l], c, r)
                              for l, c, r in zip(labels, leaf_cols,
                                                 leaf_rows)}
                    pb = prep_l[[id(x) for x in path_joins].index(id(_J))]
                    X = _flush_input(_J, pb.build, vis_l[_k])
                    ctx.materialized = {_J.join_id: X}
                    from .distributed_executor import _dist_fused_child
                    child, row_filter = _dist_fused_child(agg, tables, ctx,
                                                          axis)
                    partial, _ = hash_aggregate_counted(
                        child, agg.group_keys, partial_specs, agg_cap,
                        row_filter)
                    acc = DeviceTable(partial_schema, _local_tree(acc_cols),
                                      acc_rows[0])
                    merged, mtotal = hash_aggregate_counted(
                        concat_tables([acc, partial]), agg.group_keys,
                        merge_specs, agg_cap)
                    new_vis = [ctx.visited_out.get(j.join_id, vis_l[idx])
                               for idx, j in enumerate(vjoins)]
                    totals = jnp.stack(
                        [jnp.asarray(ctx.join_totals.get(kk, 0), jnp.int32)
                         for kk in sub_keys]) if sub_keys \
                        else jnp.zeros((0,), jnp.int32)
                    return (_unlocal_tree(merged.columns),
                            merged.num_rows[None],
                            lax.pmax(mtotal, axis),
                            _unlocal_tree(new_vis), totals)

                t0 = time.time()
                reset_comm_bytes()
                compiled_fl = jax.jit(flush).lower(
                    leaf_cols, leaf_rows, vis_list, acc_cols, acc_rows,
                    prepared_global).compile()
                total_comm += get_comm_bytes()
                handle._caps.update(fcaps)
                handle.metrics.compile_count += 1
                handle.metrics.compile_time_s += time.time() - t0
                t0 = time.time()
                outs = compiled_fl(leaf_cols, leaf_rows, vis_list, acc_cols,
                                   acc_rows, prepared_global)
                mt = int(outs[2])
                tot = [int(x) for x in outs[4]]
                handle.metrics.run_time_s += time.time() - t0
                if debug:
                    print(f"[dstream] flush join {J.join_id} mtotal={mt} "
                          f"totals={tot}", flush=True)
                if grow(sub_keys, tot):
                    handle.metrics.retries += 1
                    continue
                if mt > agg_cap:
                    handle._caps[agg.node_id] = round_capacity(
                        max(mt, 2 * agg_cap), minimum=1024)
                    handle.metrics.retries += 1
                    restart = True
                    break
                acc_cols, acc_rows, vis_list = outs[0], outs[1], outs[3]
                mtotal = mt
                flush_ok = True
            if restart:
                break
        if restart:
            continue

        handle.metrics.join_caps = dict(handle._caps)
        handle.metrics.comm_bytes = total_comm + dispatched_comm[0]

        # ---- finish: merge accumulator shards, run the head --------------
        head_nodes = [(kk, n) for kk, n in adaptive
                      if not any(m is n for m in agg.walk())]
        head_keys = [kk for kk, _ in head_nodes]
        head_keys += [k for kk, n in head_nodes if isinstance(n, PHashJoin)
                      for k in ((n.join_id, "bs"), (n.join_id, "ps"))]
        while True:
            hcaps = dict(handle._caps)

            @fpartial(jax.shard_map, mesh=mesh,
                      in_specs=(P(axis), P(axis), P(axis), P(axis)),
                      out_specs=(P(axis), P(axis), P()))
            def fin(leaf_cols, leaf_rows, acc_cols, acc_rows, _caps=hcaps):
                ctx = ExecContext(_caps)
                ctx.local_sort_ids = local_ids
                acc = DeviceTable(partial_schema, _local_tree(acc_cols),
                                  acc_rows[0])
                if agg.group_keys:
                    shuffled, _ = shuffle_by_hash(acc, agg.group_keys,
                                                  acc.capacity, axis)
                    merged = hash_aggregate(shuffled, agg.group_keys,
                                            merge_specs)
                else:
                    gathered = _all_gather_table(acc, axis)
                    merged = hash_aggregate(gathered, [], merge_specs)
                    me = lax.axis_index(axis)
                    merged = DeviceTable(merged.schema, merged.columns,
                                         jnp.where(me == 0, merged.num_rows,
                                                   0))
                out = finish_partial(merged, agg.group_keys, agg.aggs,
                                     finishers, agg.child.schema)
                if sp.root is not agg:
                    tables = {l: local_table(schemas[l], c, r)
                              for l, c, r in zip(labels, leaf_cols,
                                                 leaf_rows)}
                    ctx.materialized = {agg.node_id: out}
                    out = execute_dist(sp.root, tables, ctx, axis)
                totals = jnp.stack(
                    [jnp.asarray(ctx.join_totals.get(kk, 0), jnp.int32)
                     for kk in head_keys]) if head_keys \
                    else jnp.zeros((0,), jnp.int32)
                ocols, onum = unlocal_table(out)
                return ocols, onum, totals

            t0 = time.time()
            reset_comm_bytes()
            compiled_fin = jax.jit(fin).lower(leaf_cols, leaf_rows,
                                              acc_cols, acc_rows).compile()
            handle.metrics.comm_bytes += get_comm_bytes()
            handle._caps.update(hcaps)
            handle.metrics.compile_count += 1
            handle.metrics.compile_time_s += time.time() - t0
            t0 = time.time()
            ocols, onum, totals = compiled_fin(leaf_cols, leaf_rows,
                                               acc_cols, acc_rows)
            totals = [int(x) for x in totals]
            handle.metrics.run_time_s += time.time() - t0
            if not grow(head_keys, totals):
                return handle._finish(ocols, onum, root_sort)
            handle.metrics.retries += 1
