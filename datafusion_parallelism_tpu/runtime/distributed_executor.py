"""Distributed query executor: the whole physical plan as ONE SPMD program.

Where the single-chip executor traces the plan into one XLA program
(runtime/executor.py), this wraps the same plan in `shard_map` over the
partition mesh — the analog of the reference running one plan across N
tokio partition streams (reference src/operator/parallel_hash_join.rs:140-152),
with collectives standing in for its shared-memory rendezvous:

  * scans read per-device row shards (hash/contiguous partitioned tables);
  * every hash join shuffles both children by key hash, then runs
    the single-chip vectorized join on its key range (all 8 types correct:
    each key lives on exactly one device);
  * aggregates run two-phase: local partial -> shuffle partials by group-key
    hash -> merge -> finish (AVG decomposes into SUM+COUNT);
  * ORDER BY all-gathers the (post-aggregate, small) result and sorts on
    every device, keeping rows only on device 0 so the host-side gather
    yields them exactly once. ORDER BY + LIMIT k instead sorts each shard
    locally and gathers only k rows per device (distributed top-k).

Perf machinery shared with the single-chip path:
  * the compiled shard_map step is CACHED across collect() calls (keyed on
    capacities + scalar-subquery values), so repeat runs compile nothing;
  * LATE MATERIALIZATION rides through the mesh: an expandable join
    (INNER/semi/anti) executes uncompacted + mask, and the mask folds into
    the next shuffle's routing (masked rows are never sent) or into the
    partial aggregate's row filter — the compaction gather disappears;
  * filters directly under aggregates fuse as row masks, like single-chip.

Send capacities are safe by construction in this version (a shard never
sends more rows than its own capacity), trading memory for zero
overflow-retries; join output capacities reuse the grow-and-recompile loop.
"""

from __future__ import annotations

import time
from functools import partial as fpartial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..models.physical import (ExecContext, PAggregate, PFilter, PHashJoin,
                               PLimit, PProject, PScan, PSort, PhysicalPlan,
                               _expandable_join, find_joins)
from ..ops.aggregate import (decompose_for_partial, finish_partial,
                             hash_aggregate, hash_aggregate_counted)
from ..ops.filter import filter_table
from ..ops.join import hash_join
from ..ops.project import project_table
from ..ops.sort import limit_table, sort_table
from ..parallel.distributed import _all_gather_table
from ..parallel.mesh import PARTITION_AXIS, make_mesh
from ..parallel.shuffle import (gather_shards, local_table, partition_table,
                                shuffle_by_hash, unlocal_table)
from ..utils.columnar import (DeviceTable, HostTable, filter_rows,
                              round_capacity)
from .budget import memory_budget
from .executor import ExecutorMetrics, QueryHandle


def _shrink_table(t: DeviceTable, cap: int) -> DeviceTable:
    """Slice a table's leading `cap` rows into a smaller static capacity
    (rows past num_rows are padding either way)."""
    if cap >= t.capacity:
        return t
    cols = {n: (v[:cap], valid[:cap]) for n, (v, valid) in t.columns.items()}
    return DeviceTable(t.schema, cols, jnp.minimum(t.num_rows, jnp.int32(cap)))


def _compact_masked(t: DeviceTable, mask) -> DeviceTable:
    """Materialize a late-materialized (table, mask) pair when the consumer
    cannot fold the mask (broadcast all_gather, ORDER BY, result root)."""
    if mask is None:
        return t
    return filter_rows(t, t.row_mask() & mask)


def _dist_maybe_expanded(node: PhysicalPlan, tables, ctx, axis
                         ) -> Tuple[DeviceTable, Optional[jnp.ndarray]]:
    """(table, mask|None): execute `node` late-materialized if it is an
    expandable join (through any PProject chain — projections are
    elementwise and row-aligned, so they commute with the mask)."""
    projs = []
    n = node
    while isinstance(n, PProject):
        projs.append(n)
        n = n.child
    if _expandable_join(n, ctx):
        t, mask = _dist_join(n, tables, ctx, axis, expanded=True)
        for pr in reversed(projs):
            t = project_table(t, pr.exprs, pr.out_fields)
        return t, mask
    return execute_dist(node, tables, ctx, axis), None


def _dist_join(node: PHashJoin, tables, ctx, axis, expanded: bool = False):
    """Distributed hash join: shuffle both children (folding any upstream
    late-materialization masks into the routing), then run the single-chip
    vectorized join on the local key range. expanded=True returns
    (uncompacted table, mask) for downstream fusion.

    Streaming composition: a FROZEN build side (ctx.prepared, already
    shuffled to its key range and table-built once by the stream's prepare
    program) skips the build execution and shuffle entirely — only the
    probe chunk moves per launch. A join under ctx.stream_visited executes
    chunk-wise (probe-linear emission now, build-side emission deferred to
    the flush pass) with a per-device visited mask over the LOCAL build
    shard — correct because the frozen build is hash-partitioned, so each
    build row lives on exactly one device."""
    prepared = ctx.prepared.get(node.join_id)
    if node.join_id in ctx.stream_visited:
        assert prepared is not None, "streamed join requires a frozen build"
        return _dist_stream_chunk_join(node, prepared, tables, ctx, axis,
                                       expanded)
    b_mask = None
    if prepared is None:
        b, b_mask = _dist_maybe_expanded(node.build, tables, ctx, axis)
    p, p_mask = _dist_maybe_expanded(node.probe, tables, ctx, axis)
    P_ = lax.psum(1, axis)

    def send_cap(tag, t):
        # adaptive per-destination send block: ~4x the balanced share,
        # BUMPED by the planner's probe hot-key share when salting is off
        # (a skewed key lands its whole row mass on one destination — the
        # same mcv_share_of statistic the salting decision reads predicts
        # the drop the balanced default would eat). Dropped-row counts grow
        # it on retry (capped at shard capacity, which can never drop rows).
        key = (node.join_id, tag)
        cap = ctx.join_caps.get(key)
        if cap is None:
            cap = max(1024, 4 * (t.capacity // max(P_, 1)))
            share = node.probe_mcv_share if tag == "ps" \
                and node.dist_mode != "skew_salted" else 0.0
            if share > 0:
                cap = max(cap, round_capacity(int(1.3 * share * t.capacity),
                                              minimum=1024))
            cap = min(t.capacity, cap)
            ctx.join_caps[key] = cap
        return cap

    from ..ops.join import JoinType as _JT
    if (node.dist_mode == "skew_salted" and prepared is None
            and node.join_type in (_JT.LEFT, _JT.FULL, _JT.LEFT_SEMI,
                                   _JT.LEFT_ANTI)):
        return _salted_build_emitting(node, b, b_mask, p, p_mask, send_cap,
                                      ctx, axis, expanded)
    bdrop = pdrop = jnp.int32(0)
    b_valid = p_valid = None   # masks surviving INTO the local join
    if prepared is not None:
        # frozen build (already on its key range): only the probe moves
        b2 = prepared.build
        p2, pdrop = shuffle_by_hash(p, node.probe_keys,
                                    send_cap("ps", p), axis, valid=p_mask)
    elif node.dist_mode == "broadcast":
        b2 = _all_gather_table(_compact_masked(b, b_mask), axis)
        p2, p_valid = p, p_mask
    elif node.dist_mode == "skew_salted":
        from ..parallel.shuffle import replicating_shuffle
        from ..parallel.skew import (build_replication_mask, heavy_buckets,
                                     key_histogram, salted_route)
        hist = key_histogram(p, node.probe_keys, axis, valid=p_mask)
        heavy = heavy_buckets(hist)
        rep = build_replication_mask(b, node.build_keys, heavy, valid=b_mask)
        # replicated rows can land everywhere: keep the safe capacity
        b2, _ = replicating_shuffle(b, node.build_keys, b.capacity, rep,
                                    axis, valid=b_mask)
        dest, _ = salted_route(p, node.probe_keys, heavy, axis)
        p2, pdrop = shuffle_by_hash(p, node.probe_keys,
                                    send_cap("ps", p), axis,
                                    dest_override=dest, valid=p_mask)
    else:
        b2, bdrop = shuffle_by_hash(b, node.build_keys,
                                    send_cap("bs", b), axis, valid=b_mask)
        p2, pdrop = shuffle_by_hash(p, node.probe_keys,
                                    send_cap("ps", p), axis, valid=p_mask)
    ctx.join_totals[(node.join_id, "bs")] = bdrop
    ctx.join_totals[(node.join_id, "ps")] = pdrop
    cap = ctx.join_caps.get(node.join_id)
    if cap is None:
        if node.est_rows > 0:
            # planner cardinality estimate, per-device share with 4x skew
            # headroom, clamped like single-chip (physical.py). Without this
            # the relative default compounds 8x per join level (shuffles 4x
            # their input, joins 2x the shuffle) — Q9's 5-join chain hit 4M
            # capacity rows on 8k-row inputs.
            per_dev = max(1, int(4 * node.est_rows) // max(P_, 1))
            cap = min(round_capacity(per_dev, minimum=1024),
                      4 * max(256, b2.capacity, p2.capacity))
        else:
            cap = max(256, 2 * max(b2.capacity, p2.capacity))
        ctx.join_caps[node.join_id] = cap
    residual_fn = None
    if node.residual is not None:
        res = node.residual
        residual_fn = lambda pair_tbl: res.eval(pair_tbl)[:2]
    from ..ops.join import JoinType
    if node.dist_mode == "broadcast" and prepared is None \
            and node.join_type in (JoinType.LEFT, JoinType.FULL,
                                   JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
        return _broadcast_build_emitting(node, b2, p2, p_valid, cap,
                                         residual_fn, expanded, ctx, axis)
    result = hash_join(b2, p2, node.build_keys, node.probe_keys,
                       node.join_type, cap, strategy=node.strategy,
                       residual=residual_fn, expanded=expanded,
                       prepared=prepared,
                       build_valid=b_valid, probe_valid=p_valid)
    if expanded:
        out, mask, total = result
    else:
        out, total = result
        mask = None
    ctx.join_totals[node.join_id] = lax.pmax(total, axis)
    # LOCAL candidate total: the work-balance proxy (on real hardware
    # per-device wall time is proportional to candidates processed); the
    # step returns it per-device (out_specs P(axis)) — no extra collective
    ctx.join_balance[node.join_id] = total
    return (out, mask) if expanded else out


def _salted_build_emitting(node: PHashJoin, b, b_mask, p, p_mask, send_cap,
                           ctx, axis, expanded):
    """SKEW_SALTED mode for build-emitting joins (LEFT/FULL/LEFT_SEMI/
    LEFT_ANTI) — closes the coverage gap the reference doesn't have (its
    work stealing wraps every join type,
    use_work_stealing_repartition_rule.rs:14-37).

    Light (non-heavy-bucket) build rows hash-shuffle to their key's owner
    device; every probe of such a key routes there too, so their visited
    state is device-local and EXACT. Heavy build rows are compacted and
    all_gather'd into an IDENTICAL global block on every device (appended at
    a fixed offset after the light shard — no compaction across the
    boundary, or per-device row counts would misalign the positions);
    identical replicas make the per-device visited masks OR-reduce
    positionally over the mesh, and each deferred heavy row is emitted by
    exactly one owner (index mod P) — round 4's broadcast owner-dedup
    applied to only the rows salting actually replicates. Heavy PROBE rows
    stay local (their work is already spread by the scan partitioning), so
    a hot key's probe mass never lands on one device."""
    from ..ops.join import JoinType, hash_join
    from ..parallel.shuffle import shuffle_by_hash
    from ..parallel.skew import (build_replication_mask, heavy_buckets,
                                 key_histogram, salted_route)
    from ..utils.columnar import (compact_rows, hstack_tables,
                                  null_columns_like, pack_table,
                                  unpack_table)
    me = lax.axis_index(axis)
    P_ = lax.psum(1, axis)
    hist = key_histogram(p, node.probe_keys, axis, valid=p_mask)
    heavy = heavy_buckets(hist)
    rep = build_replication_mask(b, node.build_keys, heavy, valid=b_mask)
    in_b = b.row_mask() if b_mask is None else (b.row_mask() & b_mask)

    b_light, bdrop = shuffle_by_hash(b, node.build_keys, send_cap("bs", b),
                                     axis, valid=in_b & ~rep)
    hv_key = (node.join_id, "hv")
    hcap = ctx.join_caps.get(hv_key)
    if hcap is None:
        # heavy rows are the hot-key subset: small unless the build is
        # itself skewed; the dropped-row retry owns the rest
        hcap = max(1024, round_capacity(b.capacity // 64, minimum=1024))
        ctx.join_caps[hv_key] = hcap
    hcap = min(hcap, b.capacity)   # a shard can't hold more than its rows
    (hpt,), hn = compact_rows([pack_table(b)], in_b & rep, hcap)
    b_hv_local = unpack_table(hpt, b.schema, jnp.minimum(hn, hcap))
    hdrop = jnp.maximum(hn - hcap, 0)
    b_heavy = _all_gather_table(b_hv_local, axis)   # identical on every chip
    light_cap, heavy_cap = b_light.capacity, b_heavy.capacity

    cols = {}
    for f in b.schema.fields:
        lv, lval = b_light.columns[f.name]
        hv, hval = b_heavy.columns[f.name]
        cols[f.name] = (jnp.concatenate([lv, hv]),
                        jnp.concatenate([lval, hval]))
    b2 = DeviceTable(b.schema, cols, jnp.int32(light_cap + heavy_cap))
    b2_valid = jnp.concatenate([b_light.row_mask(), b_heavy.row_mask()])

    dest, _ = salted_route(p, node.probe_keys, heavy, axis)
    p2, pdrop = shuffle_by_hash(p, node.probe_keys, send_cap("ps", p), axis,
                                dest_override=dest, valid=p_mask)
    ctx.join_totals[(node.join_id, "bs")] = bdrop
    ctx.join_totals[(node.join_id, "ps")] = pdrop
    ctx.join_totals[hv_key] = lax.pmax(hdrop, axis)

    cap = ctx.join_caps.get(node.join_id)
    if cap is None:
        if node.est_rows > 0:
            per_dev = max(1, int(4 * node.est_rows) // max(P_, 1))
            cap = min(round_capacity(per_dev, minimum=1024),
                      4 * max(256, b2.capacity, p2.capacity))
        else:
            cap = max(256, 2 * max(b2.capacity, p2.capacity))
        ctx.join_caps[node.join_id] = cap
    residual_fn = None
    if node.residual is not None:
        res = node.residual
        residual_fn = lambda pair_tbl: res.eval(pair_tbl)[:2]

    chunk_type = PHashJoin._STREAM_CHUNK_TYPE.get(node.join_type)
    if chunk_type is not None:               # LEFT / FULL: local pairs (+
        pairs, total, vis = hash_join(       # unmatched local probe: FULL)
            b2, p2, node.build_keys, node.probe_keys, chunk_type, cap,
            strategy=node.strategy, residual=residual_fn,
            build_valid=b2_valid, return_visited=True)
    else:                                    # LEFT_SEMI / LEFT_ANTI
        pairs = None
        _, _, total, vis = hash_join(
            b2, p2, node.build_keys, node.probe_keys, node.join_type, cap,
            strategy=node.strategy, residual=residual_fn,
            build_valid=b2_valid, expanded=True, return_visited=True)
    vis_l = vis[:light_cap]                            # exact, device-local
    vis_h = lax.psum(vis[light_cap:].astype(jnp.int32), axis) > 0
    owner_h = (jnp.arange(heavy_cap, dtype=jnp.int32) % P_) == me
    emit_in = jnp.concatenate([b_light.row_mask(),
                               b_heavy.row_mask() & owner_h])
    vis_all = jnp.concatenate([vis_l, vis_h])
    ctx.join_totals[node.join_id] = lax.pmax(total, axis)
    ctx.join_balance[node.join_id] = total
    if node.join_type is JoinType.LEFT_SEMI:
        mask = emit_in & vis_all
        return (b2, mask) if expanded else filter_rows(b2, mask)
    if node.join_type is JoinType.LEFT_ANTI:
        mask = emit_in & ~vis_all
        return (b2, mask) if expanded else filter_rows(b2, mask)
    assert not expanded                      # LEFT/FULL are not expandable
    ub = filter_rows(b2, emit_in & ~vis_all)
    nulls = DeviceTable(p2.schema, null_columns_like(p2.schema, ub.capacity),
                        ub.num_rows)
    unmatched = hstack_tables(ub, nulls, ub.num_rows)
    from ..utils.columnar import concat_tables
    return concat_tables([pairs, unmatched])


def _broadcast_build_emitting(node: PHashJoin, b2, p2, p_valid, cap,
                              residual_fn, expanded, ctx, axis):
    """Broadcast-mode BUILD-EMITTING join (LEFT/FULL/LEFT_SEMI/LEFT_ANTI)
    with OWNER-PARTITION emission: the replicated build probes each device's
    local (un-shuffled!) probe shard — so a skewed probe key never hot-spots
    a device — and the double-count hazard of replicated build rows is
    resolved by (1) OR-reducing the per-device visited masks over the mesh
    (the replicas are identical, so a psum over the bool mask is the global
    visited bitset — the reference's shared ConcurrentBitSet, full.rs:77-79,
    as a collective) and (2) emitting each deferred build row on exactly one
    OWNER device (row_index mod P). Extends the reference's
    work-steal-every-join-type coverage (work_stealing_repartition_exec.rs:
    50-115) to the broadcast path, which round 3 confined to probe-driven
    types."""
    from ..ops.join import JoinType
    from ..utils.columnar import hstack_tables, null_columns_like
    me = lax.axis_index(axis)
    P_ = lax.psum(1, axis)
    chunk_type = PHashJoin._STREAM_CHUNK_TYPE.get(node.join_type)
    if chunk_type is not None:               # LEFT / FULL: local pairs (+
        pairs, total, vis = hash_join(       # unmatched local probe for FULL)
            b2, p2, node.build_keys, node.probe_keys, chunk_type, cap,
            strategy=node.strategy, residual=residual_fn,
            probe_valid=p_valid, return_visited=True)
    else:                                    # LEFT_SEMI / LEFT_ANTI
        pairs = None
        _, _, total, vis = hash_join(
            b2, p2, node.build_keys, node.probe_keys, node.join_type, cap,
            strategy=node.strategy, residual=residual_fn,
            probe_valid=p_valid, expanded=True, return_visited=True)
    vis_global = lax.psum(vis.astype(jnp.int32), axis) > 0
    owner = (jnp.arange(b2.capacity, dtype=jnp.int32) % P_) == me
    bin_ = b2.row_mask() & owner
    ctx.join_totals[node.join_id] = lax.pmax(total, axis)
    ctx.join_balance[node.join_id] = total
    if node.join_type is JoinType.LEFT_SEMI:
        mask = bin_ & vis_global
        return (b2, mask) if expanded else filter_rows(b2, mask)
    if node.join_type is JoinType.LEFT_ANTI:
        mask = bin_ & ~vis_global
        return (b2, mask) if expanded else filter_rows(b2, mask)
    assert not expanded                      # LEFT/FULL are not expandable
    ub = filter_rows(b2, bin_ & ~vis_global)
    nulls = DeviceTable(p2.schema, null_columns_like(p2.schema, ub.capacity),
                        ub.num_rows)
    unmatched = hstack_tables(ub, nulls, ub.num_rows)
    from ..utils.columnar import concat_tables
    return concat_tables([pairs, unmatched])


def _dist_stream_chunk_join(node: PHashJoin, prepared, tables, ctx, axis,
                            expanded: bool):
    """One probe chunk of a build-emitting join under DISTRIBUTED morsel
    streaming: shuffle the chunk to the frozen build's key range, emit the
    chunk's probe-linear rows, fold matches into the per-device visited
    mask over the LOCAL build shard (each key lives on exactly one device,
    so local visited masks compose exactly). The deferred build-side rows
    are emitted by the stream's flush pass (runtime/distributed_streaming)."""
    from ..ops.join import JoinType
    from ..utils.columnar import null_columns_like
    assert not expanded   # _expandable_join excludes streamed joins
    p, p_mask = _dist_maybe_expanded(node.probe, tables, ctx, axis)
    P_ = lax.psum(1, axis)
    skey = (node.join_id, "ps")
    send_cap = ctx.join_caps.get(skey)
    if send_cap is None:
        send_cap = max(1024, 4 * (p.capacity // max(P_, 1)))
        if node.probe_mcv_share > 0:   # planner-predicted skew (see
            send_cap = max(send_cap,   # _dist_join.send_cap)
                           round_capacity(
                               int(1.3 * node.probe_mcv_share * p.capacity),
                               minimum=1024))
        send_cap = min(p.capacity, send_cap)
        ctx.join_caps[skey] = send_cap
    p2, pdrop = shuffle_by_hash(p, node.probe_keys, send_cap, axis,
                                valid=p_mask)
    ctx.join_totals[skey] = pdrop
    cap = ctx.join_caps.get(node.join_id)
    if cap is None:
        cap = max(256, 2 * max(prepared.build.capacity, p2.capacity))
        ctx.join_caps[node.join_id] = cap
    residual_fn = None
    if node.residual is not None:
        res = node.residual
        residual_fn = lambda pair_tbl: res.eval(pair_tbl)[:2]
    chunk_type = PHashJoin._STREAM_CHUNK_TYPE.get(node.join_type)
    if chunk_type is not None:            # LEFT / FULL
        out, total, vis = hash_join(
            prepared.build, p2, node.build_keys, node.probe_keys, chunk_type,
            cap, strategy=node.strategy, residual=residual_fn,
            prepared=prepared, return_visited=True)
    else:                                 # LEFT_SEMI / LEFT_ANTI
        _, _, total, vis = hash_join(
            prepared.build, p2, node.build_keys, node.probe_keys,
            node.join_type, cap, strategy=node.strategy,
            residual=residual_fn, prepared=prepared, expanded=True,
            return_visited=True)
        out = DeviceTable(node.schema, null_columns_like(node.schema, 128),
                          jnp.int32(0))
    incoming = ctx.stream_visited[node.join_id]
    ctx.visited_out[node.join_id] = (vis if incoming is None
                                     else incoming | vis)
    ctx.join_totals[node.join_id] = lax.pmax(total, axis)
    ctx.join_balance[node.join_id] = total
    return out


def _dist_fused_child(node: PAggregate, tables, ctx, axis
                      ) -> Tuple[DeviceTable, Optional[jnp.ndarray]]:
    """(child, row_filter): the distributed analog of PAggregate.fused_child —
    a filter or expandable join under the aggregate (through projections)
    becomes a row mask on the partial aggregate instead of a compaction."""
    projs = []
    n = node.child
    while isinstance(n, PProject):
        projs.append(n)
        n = n.child
    child = row_filter = None
    if _expandable_join(n, ctx):
        child, row_filter = _dist_join(n, tables, ctx, axis, expanded=True)
    elif isinstance(n, PFilter) and not isinstance(n.child, PFilter):
        if _expandable_join(n.child, ctx):
            child, match = _dist_join(n.child, tables, ctx, axis,
                                      expanded=True)
            v, valid, _ = n.predicate.eval(child)
            row_filter = match & valid & v.astype(jnp.bool_)
        else:
            child = execute_dist(n.child, tables, ctx, axis)
            v, valid, _ = n.predicate.eval(child)
            row_filter = valid & v.astype(jnp.bool_)
    if child is not None:
        for pr in reversed(projs):
            child = project_table(child, pr.exprs, pr.out_fields)
        return child, row_filter
    return execute_dist(node.child, tables, ctx, axis), None


def execute_dist(node: PhysicalPlan, tables: Dict[str, DeviceTable],
                 ctx: ExecContext, axis: str) -> DeviceTable:
    """Per-device execution of a plan node (call inside shard_map)."""
    if isinstance(node, PScan):
        return tables[node.label]
    if isinstance(node, PFilter):
        out, _ = filter_table(execute_dist(node.child, tables, ctx, axis),
                              node.predicate)
        return out
    if isinstance(node, PProject):
        return project_table(execute_dist(node.child, tables, ctx, axis),
                             node.exprs, node.out_fields)
    if isinstance(node, PHashJoin):
        if node.join_id in ctx.materialized:   # staged execution boundary
            return ctx.materialized[node.join_id]
        return _dist_join(node, tables, ctx, axis)
    if isinstance(node, PAggregate):
        if node.node_id in ctx.materialized:
            # streaming finish: the merge-point aggregate's completed result
            # (sharded by group key) replaces the subtree
            return ctx.materialized[node.node_id]
        child, row_filter = _dist_fused_child(node, tables, ctx, axis)
        # ADAPTIVE per-device group capacity, seeded from the planner's
        # group estimate. Defaulting to child.capacity made the merge stage
        # receive P x child_capacity rows per device — at SF1 x 8 devices
        # that is an 8M-row multi-operand sort per virtual device and tens
        # of GB of temps (the whole-host OOM on the CPU mesh). Overflow
        # (true per-device group count > capacity) reports through
        # join_totals and retries like every other adaptive capacity.
        acap = ctx.join_caps.get(node.node_id)
        if acap is None:
            if not node.group_keys:
                acap = 128      # global aggregate: one output row
            elif node.est_groups > 0:
                acap = max(128, min(round_capacity(int(2 * node.est_groups),
                                                   minimum=128),
                                    child.capacity))
            else:
                acap = min(child.capacity, max(1024, child.capacity // 4))
            ctx.join_caps[node.node_id] = acap
        if not node.aggs and node.group_keys:
            # pure dedup (DISTINCT / count-distinct stage 1): local dedup
            # FIRST (bounds the shuffle to acap rows), then co-partition and
            # dedup again — keys live on exactly one device. The fused mask
            # folds into the first dedup's row filter.
            local, dtotal = hash_aggregate_counted(child, node.group_keys,
                                                   [], acap,
                                                   row_filter=row_filter)
            ctx.join_totals[node.node_id] = lax.pmax(dtotal, axis)
            shuffled, _ = shuffle_by_hash(local, node.group_keys,
                                          acap, axis)
            return hash_aggregate(shuffled, node.group_keys, [])
        partial_specs, merge_specs, finishers = decompose_for_partial(node.aggs)
        partial, ptotal = hash_aggregate_counted(child, node.group_keys,
                                                 partial_specs, acap,
                                                 row_filter=row_filter)
        ctx.join_totals[node.node_id] = lax.pmax(ptotal, axis)
        if node.group_keys:
            shuffled, _ = shuffle_by_hash(partial, node.group_keys,
                                          partial.capacity, axis)
            merged = hash_aggregate(shuffled, node.group_keys, merge_specs)
        else:
            gathered = _all_gather_table(partial, axis)
            merged = hash_aggregate(gathered, [], merge_specs)
            # every device holds the same global row: keep it once
            me = lax.axis_index(axis)
            merged = DeviceTable(merged.schema, merged.columns,
                                 jnp.where(me == 0, merged.num_rows, 0))
        return finish_partial(merged, node.group_keys, node.aggs, finishers,
                              child.schema)
    if isinstance(node, PSort):
        child = execute_dist(node.child, tables, ctx, axis)
        if id(node) in ctx.local_sort_ids:
            # root ORDER BY without LIMIT: each shard sorts LOCALLY and
            # keeps its rows; the total order is restored by a host-side
            # merge at collection (host_sort_table). Zero collective bytes
            # move — the old path all-gathered the full result to every
            # device (unbounded for large sorted outputs).
            return sort_table(child, node.keys)
        full = _all_gather_table(child, axis)
        out = sort_table(full, node.keys)
        me = lax.axis_index(axis)
        return DeviceTable(out.schema, out.columns,
                           jnp.where(me == 0, out.num_rows, 0))
    if isinstance(node, PLimit):
        if isinstance(node.child, PSort):
            # distributed top-k: the global top k rows are contained in the
            # union of per-shard top k's, so sort each shard locally, gather
            # only k rows per device, and merge-sort the small union —
            # O(P*k) moved instead of O(total rows) (VERDICT round-1 weak #5)
            srt = node.child
            child = execute_dist(srt.child, tables, ctx, axis)
            local_sorted = sort_table(child, srt.keys)
            kcap = min(child.capacity,
                       round_capacity(max(node.n, 1), minimum=128))
            topk = _shrink_table(limit_table(local_sorted, node.n), kcap)
            full = _all_gather_table(topk, axis)
            out = limit_table(sort_table(full, srt.keys), node.n)
            me = lax.axis_index(axis)
            return DeviceTable(out.schema, out.columns,
                               jnp.where(me == 0, out.num_rows, 0))
        return limit_table(execute_dist(node.child, tables, ctx, axis), node.n)
    raise NotImplementedError(type(node))


class DistributedQueryHandle(QueryHandle):
    """QueryHandle that executes over a device mesh. Same public surface:
    run() -> DeviceTable-equivalent HostTable via collect()."""

    def __init__(self, plan, catalog, scalar_subqueries=(), config=None,
                 mesh=None):
        super().__init__(plan, catalog, scalar_subqueries, config)
        self.mesh = mesh or make_mesh(config.target_partitions)
        self.axis = self.mesh.axis_names[0]
        self._sharded_inputs = None  # cached device-sharded leaf tables

    def run(self):
        raise NotImplementedError("distributed handle returns host tables; "
                                  "use collect()")

    def _shard_inputs(self, skip_labels=()):
        """Partition + upload each scan's host table once per handle.
        `skip_labels`: scans left out entirely (streamed in chunks)."""
        Pn = self.mesh.devices.size
        sharded = {}   # label -> (cols, num_rows, schema)
        for node in self.plan.walk():
            if isinstance(node, PScan) and node.label not in sharded \
                    and node.label not in skip_labels:
                host = self.catalog.get(node.table_name).host
                renamed = HostTable(
                    node.schema,
                    {f"{node.label}.{c}": v for c, v in host.columns.items()},
                    host.num_rows)
                cols, nrows, schema, _ = partition_table(renamed, Pn)
                sharded[node.label] = (cols, nrows, schema)
        labels = sorted(sharded)
        leaf_cols = [sharded[l][0] for l in labels]
        leaf_rows = [sharded[l][1] for l in labels]
        schemas = {l: sharded[l][2] for l in labels}

        # multi-process SPMD (true multi-host): every process holds the full
        # host tables and materializes only its mesh slice; outputs come
        # back via a cross-process allgather (parallel/multihost.py)
        multiproc = jax.process_count() > 1
        if multiproc:
            from ..parallel.multihost import globalize_tree
            leaf_cols = globalize_tree(leaf_cols, self.mesh, self.axis)
            leaf_rows = globalize_tree(leaf_rows, self.mesh, self.axis)
        return labels, leaf_cols, leaf_rows, schemas, multiproc

    def _root_local_sort(self):
        """The root ORDER BY (through projections) when its key columns
        survive to the output schema — eligible for shard-local sort +
        host-merge collection. None otherwise."""
        node, projs = self.plan, False
        while isinstance(node, PProject):
            projs, node = True, node.child
        if not isinstance(node, PSort):
            return None
        if projs:
            out_names = {f.name for f in self.plan.schema.fields}
            if not all(k.column in out_names for k in node.keys):
                return None
        return node

    def _use_staged(self, joins, leaf_cols) -> bool:
        import os
        env = os.environ.get("DFP_DIST_STAGED")
        if env is not None:
            return bool(int(env)) and len(joins) > 1
        cfgd = getattr(self.config, "distributed_staged", None)
        if cfgd is not None:
            return cfgd and len(joins) > 1
        total = sum(v.nbytes + valid.nbytes
                    for cols in leaf_cols for v, valid in cols.values())
        return len(joins) > 1 and total > memory_budget().dist_stage_bytes

    def _finish(self, ocols, onum, root_sort) -> HostTable:
        sharding = getattr(onum, "sharding", None)   # None once allgathered
        if sharding is not None:
            self.metrics.output_devices = sorted(
                str(d) for d in sharding.device_set)
        out = gather_shards(self.plan.schema, ocols, onum)
        if root_sort is not None:
            from ..ops.sort import host_sort_table
            out = host_sort_table(out, root_sort.keys)
        return out

    def _check_overflow(self, keys, totals) -> bool:
        from .executor import _debug_retry
        overflow = False
        for k, total in zip(keys, totals):
            if isinstance(k, tuple):
                if total > 0:  # dropped shuffle rows: double the block
                    _debug_retry("send", k, None, self._caps[k], total,
                                 2 * self._caps[k])
                    self._caps[k] = 2 * self._caps[k]
                    overflow = True
                continue
            cap = self._caps[k]
            fit = round_capacity(max(total, 1), minimum=1024)
            if total > cap:
                _debug_retry("grow", k, None, cap, total, fit)
                self._caps[k] = fit
                overflow = True
            elif cap > 4 * fit:
                # DEFERRED shrink, as in _run_resident: the oversized run's
                # result is correct; the smaller shape compiles next call
                # (bounded 64x per step — capacity coupling can ping-pong)
                self._caps[k] = max(fit, cap >> 6)
        self.metrics.join_caps = dict(self._caps)
        return overflow

    @staticmethod
    def _tree_bytes(tree) -> int:
        return sum(x.nbytes for x in jax.tree_util.tree_leaves(tree))

    def collect(self) -> HostTable:
        # cached like QueryHandle.run (re-tracing per collect is seconds)
        if self._sub_handles is None:
            self._sub_handles = [
                QueryHandle(sub.plan, self.catalog, sub.scalar_subqueries,
                            self.config)
                for _, sub in self.scalar_subqueries]
        for (sv, _), handle in zip(self.scalar_subqueries,
                                   self._sub_handles):
            if getattr(sv, "_settled", False):
                continue   # registered tables are immutable (executor.py)
            result = handle.run().to_host()
            rows = result.to_pylist()
            if len(rows) != 1:
                raise ValueError(f"scalar subquery returned {len(rows)} rows")
            sv.holder[0] = rows[0][result.schema.fields[0].name]
            sv._settled = True

        # Morsel streaming over the mesh: when the biggest scan's upload
        # alone breaks the per-device HBM budget and the plan is
        # stream-decomposable, chunk it through the SPMD plan instead of
        # sharding it resident (streaming x distribution composed —
        # BASELINE config #5's shape)
        import os
        if not os.environ.get("DFP_NO_STREAM") \
                and jax.process_count() == 1:
            from .streaming import plan_stream, stream_upload_bytes
            scans = [n for n in self.plan.walk() if isinstance(n, PScan)]
            need_stream = False
            if scans:
                big = max(scans, key=lambda s:
                          self.catalog.get(s.table_name).host.num_rows)
                live_big = self._live_columns().get(big.table_name)
                budget = memory_budget()
                need_stream = (stream_upload_bytes(self.catalog,
                                                   big.table_name, live_big)
                               > budget.stream_bytes
                               or self.catalog.get(big.table_name)
                               .host.num_rows > budget.stream_rows)
            sp = plan_stream(self.plan, self.catalog)
            if sp is None and need_stream:
                # side-swap rule: see runtime/executor.py — only fires when
                # streaming is required, because it undoes the cost-based
                # build-side choice
                sp = plan_stream(self.plan, self.catalog, allow_swap=True)
            if sp is not None and need_stream:
                live = self._live_columns().get(sp.scan.table_name)
                from ..models.physical import find_adaptive
                from .distributed_streaming import run_streamed_dist
                return run_streamed_dist(self, sp, live,
                                         find_adaptive(self.plan))

        if self._sharded_inputs is None:
            t0 = time.time()
            self._sharded_inputs = self._shard_inputs()
            self.metrics.upload_s += time.time() - t0   # host split + upload
        labels, leaf_cols, leaf_rows, schemas, multiproc = self._sharded_inputs

        root_sort = self._root_local_sort()
        local_ids = (frozenset({id(root_sort)}) if root_sort is not None
                     else frozenset())
        joins = find_joins(self.plan)
        if self._use_staged(joins, leaf_cols):
            return self._collect_staged(labels, leaf_cols, leaf_rows, schemas,
                                        multiproc, joins, root_sort, local_ids)
        # per join: candidate total + build/probe shuffle dropped-row counts;
        # per aggregate: the per-device group-count total (adaptive capacity)
        keys = []
        for j in joins:
            keys += [j.join_id, (j.join_id, "bs"), (j.join_id, "ps"),
                     (j.join_id, "hv")]
        # global (no-group-key) aggregates have a fixed 1-row total; listing
        # them would deferred-shrink their seeded capacity 64x per collect
        # and force needless warm recompiles (cache keys on _caps)
        keys += [n.node_id for n in self.plan.walk()
                 if isinstance(n, PAggregate) and n.group_keys]
        jids = [j.join_id for j in joins]
        plan, axis = self.plan, self.axis

        def cache_key():
            return (tuple(sorted(self._caps.items(), key=repr)),
                    tuple(sv.holder[0] for sv, _ in self.scalar_subqueries))

        while True:
            # compiled-step cache: repeat collect() calls (bench iterations)
            # must compile ZERO programs — key on capacities + baked-in
            # scalar subquery values, like _run_resident (VERDICT weak #3)
            if self._compiled is None or self._compiled_key != cache_key():
                caps = dict(self._caps)

                @fpartial(jax.shard_map, mesh=self.mesh,
                          in_specs=(P(axis), P(axis)),
                          out_specs=(P(axis), P(axis), P(), P(axis)))
                def step(leaf_cols, leaf_rows, _caps=caps):
                    tables = {l: local_table(schemas[l], c, r)
                              for l, c, r in zip(labels, leaf_cols, leaf_rows)}
                    ctx = ExecContext(_caps)
                    ctx.local_sort_ids = local_ids
                    out = execute_dist(plan, tables, ctx, axis)
                    totals = jnp.stack(
                        [jnp.asarray(ctx.join_totals.get(k, 0), jnp.int32)
                         for k in keys]) if keys else jnp.zeros((0,), jnp.int32)
                    # [1, n_joins] local candidate totals -> [P, n_joins]
                    balance = jnp.stack(
                        [jnp.asarray(ctx.join_balance.get(k, 0), jnp.int32)
                         for k in jids])[None, :] if jids \
                        else jnp.zeros((1, 0), jnp.int32)
                    ocols, onum = unlocal_table(out)
                    return ocols, onum, totals, balance

                from ..parallel.shuffle import (get_comm_bytes,
                                                reset_comm_bytes)
                t0 = time.time()
                reset_comm_bytes()
                self._compiled = jax.jit(step).lower(
                    leaf_cols, leaf_rows).compile()
                # collective volume is exact at trace time (static shapes)
                self.metrics.comm_bytes = get_comm_bytes()
                # capacity defaults chosen at trace time are recorded in caps;
                # key under POST-trace caps so the next call's lookup hits
                self._caps.update(caps)
                self._compiled_key = cache_key()
                self.metrics.compile_count += 1
                self.metrics.compile_time_s += time.time() - t0
            t0 = time.time()
            self.metrics.launches += 1
            ocols, onum, totals, balance = self._compiled(leaf_cols, leaf_rows)
            if multiproc:
                from ..parallel.multihost import allgather_tree
                ocols = allgather_tree(ocols)
                onum = allgather_tree(onum)
                balance = allgather_tree(balance)
            totals = [int(t) for t in totals]  # host fetch = true sync
            self.metrics.run_time_s += time.time() - t0
            import numpy as np
            b = np.asarray(balance)            # [P, n_joins]
            self.metrics.balance = {
                jid: [int(x) for x in b[:, i]] for i, jid in enumerate(jids)}

            if not self._check_overflow(keys, totals):
                return self._finish(ocols, onum, root_sort)
            self.metrics.retries += 1
            self._compiled = None

    def _collect_staged(self, labels, leaf_cols, leaf_rows, schemas,
                        multiproc, joins, root_sort, local_ids) -> HostTable:
        """Staged distributed execution: each join subtree runs as its OWN
        shard_map program, its result staying on the devices as sharded
        arguments to later stages (the distributed port of
        QueryHandle._run_staged). This bounds every launch's per-device
        working set to one join's packs/gathers instead of the whole plan's
        — the memory discipline the reference gets from streaming probe
        batches against a frozen build (inner.rs:48-75) with bounded queues
        upstream (work_stealing_repartition_exec.rs:308-329)."""
        plan, axis = self.plan, self.axis
        order: list = []
        seen = set()
        join_ids = {id(j) for j in joins}

        def post(n):
            for c in n.children():
                post(c)
            if id(n) in join_ids and id(n) not in seen:
                seen.add(id(n))
                order.append(n)

        post(plan)
        stages = [(True, j) for j in order if j is not plan]
        stages.append((False, plan))
        mats: Dict[int, Tuple] = {}      # join_id -> (ocols, onum) sharded
        mat_schemas: Dict[int, object] = {}
        self.metrics.stage_bytes = []
        from ..parallel.shuffle import get_comm_bytes, reset_comm_bytes
        # per-stage comm bytes keyed by stage: comm is traced at COMPILE time
        # only, so cache hits must replay the value recorded with the
        # executable or every warm collect() would report comm_bytes = 0
        stage_comm: Dict[int, int] = {}

        for stage_idx, (materialize, node) in enumerate(stages):
            sub_joins = [j for j in joins
                         if any(m is j for m in node.walk())
                         and j.join_id not in mats]
            keys = []
            for j in sub_joins:
                keys += [j.join_id, (j.join_id, "bs"), (j.join_id, "ps"),
                     (j.join_id, "hv")]
            keys += [m.node_id for m in node.walk()
                     if isinstance(m, PAggregate) and m.group_keys]
            jids = [j.join_id for j in sub_joins]
            sub_ids = {k for k in keys}
            is_root = not materialize

            while True:
                caps = dict(self._caps)
                mat_keys = sorted(mats)
                mat_list = [mats[k] for k in mat_keys]

                def stage_key():
                    return (
                        tuple(sorted(((k, v) for k, v in self._caps.items()
                                      if k in sub_ids), key=repr)),
                        tuple((k, self._tree_bytes(mats[k]))
                              for k in mat_keys),
                        tuple(sv.holder[0]
                              for sv, _ in self.scalar_subqueries))

                cached = self._staged_compiled.get(stage_idx)
                if cached is not None and cached[0] == stage_key():
                    compiled = cached[1]
                    stage_comm[stage_idx] = cached[2]
                else:
                    @fpartial(jax.shard_map, mesh=self.mesh,
                              in_specs=(P(axis), P(axis), P(axis)),
                              out_specs=(P(axis), P(axis), P(), P(axis)))
                    def step(leaf_cols, leaf_rows, mat_list, _caps=caps,
                             _node=node, _keys=tuple(mat_keys)):
                        tables = {l: local_table(schemas[l], c, r)
                                  for l, c, r in zip(labels, leaf_cols,
                                                     leaf_rows)}
                        ctx = ExecContext(_caps)
                        ctx.local_sort_ids = local_ids if is_root else \
                            frozenset()
                        ctx.materialized = {
                            k: local_table(mat_schemas[k], mc, mr)
                            for k, (mc, mr) in zip(_keys, mat_list)}
                        out = execute_dist(_node, tables, ctx, axis)
                        totals = jnp.stack(
                            [jnp.asarray(ctx.join_totals.get(k, 0),
                                         jnp.int32) for k in keys]) \
                            if keys else jnp.zeros((0,), jnp.int32)
                        balance = jnp.stack(
                            [jnp.asarray(ctx.join_balance.get(k, 0),
                                         jnp.int32) for k in jids])[None, :] \
                            if jids else jnp.zeros((1, 0), jnp.int32)
                        ocols, onum = unlocal_table(out)
                        return ocols, onum, totals, balance

                    t0 = time.time()
                    reset_comm_bytes()
                    compiled = jax.jit(step).lower(
                        leaf_cols, leaf_rows, mat_list).compile()
                    stage_comm[stage_idx] = get_comm_bytes()
                    self._caps.update(caps)
                    self.metrics.compile_count += 1
                    self.metrics.compile_time_s += time.time() - t0
                    self._staged_compiled[stage_idx] = (
                        stage_key(), compiled, stage_comm[stage_idx])
                t0 = time.time()
                self.metrics.launches += 1
                ocols, onum, totals, balance = compiled(
                    leaf_cols, leaf_rows, mat_list)
                if multiproc:
                    from ..parallel.multihost import allgather_tree
                    balance = allgather_tree(balance)
                totals = [int(t) for t in totals]
                self.metrics.run_time_s += time.time() - t0
                import numpy as np
                b = np.asarray(balance)        # [P, n_joins]
                for i, jid in enumerate(jids):
                    self.metrics.balance[jid] = [int(x) for x in b[:, i]]
                if not self._check_overflow(keys, totals):
                    break
                self.metrics.retries += 1
                self._staged_compiled.pop(stage_idx, None)

            # per-device memory model: leaf shards + materialized inputs +
            # this stage's output, all exact from static shapes (tests
            # assert each stage fits the device budget)
            Pn = self.mesh.devices.size
            self.metrics.stage_bytes.append({
                "stage": stage_idx,
                "node": node.describe(),
                "leaf_bytes_per_device":
                    (self._tree_bytes(leaf_cols)
                     + self._tree_bytes(leaf_rows)) // Pn,
                "mat_bytes_per_device": self._tree_bytes(mat_list) // Pn,
                "out_bytes_per_device":
                    (self._tree_bytes(ocols)
                     + self._tree_bytes(onum)) // Pn,
            })
            if materialize:
                mats[node.join_id] = (ocols, onum)
                mat_schemas[node.join_id] = node.schema
        self.metrics.comm_bytes = sum(stage_comm.values())
        if multiproc:
            from ..parallel.multihost import allgather_tree
            ocols = allgather_tree(ocols)
            onum = allgather_tree(onum)
        return self._finish(ocols, onum, root_sort)
