"""Grace-partitioned out-of-core execution (key-hash partitioned streaming).

Row-range morsel streaming (runtime/streaming.py) requires the out-of-core
table to be scanned ONCE and to sit on the probe side of every join on its
path. Plans that self-join the big table (TPC-H Q2/Q17/Q18/Q21) or join two
huge tables (Q7's 600M-row lineitem against unfiltered 150M-row orders)
have no such decomposition: a row-range chunk of one scan says nothing
about which rows of the other scan it matches.

Key-hash partitioning restores independence. Every over-threshold scan is
partitioned on the host by the HASH OF ITS JOIN COLUMN — the reference's
dashmap shard function (src/utils/
partitioned_concurrent_self_hash_join_map.rs:13-16) lifted from memory
shards to the host/HBM boundary — so rows with equal key values land in the
same partition index across ALL scans. Each partition then runs the
complete sub-plan under the merge point EXACTLY: self-joins and meet joins
keyed by the partition column see every row of a key within one partition;
nested aggregates grouping by the partition column are exact per partition
(this is what row-range chunking can never do — Q18's 150M-group inner
aggregate becomes K exact ~1M-group aggregates); joins against small
resident tables see the whole (replicated) build. Per-partition results
fold into the same partial-aggregate accumulator morsel streaming uses, or
append into a row-union accumulator when no aggregate dominates the big
scans (Q2).

Eligibility (`plan_grace`) is requirement propagation: the merge subtree is
walked top-down carrying the column each subtree's output must be
partitioned by. Meet joins (both children hold big scans) must carry the
requirement in their join keys and hand the paired key to the other side;
resident joins pass the requirement through their big side (or transfer it
across an INNER equi-pair when it names a resident column — Q2's
p_partkey = ps_partkey chain); nested aggregates must group by it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.physical import (ExecContext, PAggregate, PFilter, PHashJoin,
                               PLimit, PProject, PScan, PSort, PhysicalPlan)
from ..ops.aggregate import (agg_output_schema, decompose_for_partial,
                             finish_partial, hash_aggregate_counted)
from ..ops.expressions import Col
from ..ops.join import JoinType, prepare_build
from ..utils.columnar import (DeviceTable, Kind, PackedTable, Schema,
                              concat_tables, pack_host_slice, packed_layout,
                              round_capacity, unpack_table)
from .budget import memory_budget
from .streaming import _contains, _path_to

_DECOMPOSABLE = ("sum", "count", "count_star", "min", "max", "avg")
# join types that are correct per-partition when only ONE side carries the
# partitioned flow (the other side is a small table replicated into every
# partition): the partitioned side's rows appear in exactly one partition,
# so emissions driven by THAT side are emitted exactly once; emissions
# driven by the replicated side would repeat per partition and are rejected
_BIG_PROBE_OK = (JoinType.INNER, JoinType.RIGHT, JoinType.RIGHT_SEMI,
                 JoinType.RIGHT_ANTI)
_BIG_BUILD_OK = (JoinType.INNER, JoinType.LEFT, JoinType.LEFT_SEMI,
                 JoinType.LEFT_ANTI)
_PART_KINDS = (Kind.INT32, Kind.INT64, Kind.DATE32, Kind.DECIMAL)


@dataclass
class GracePlan:
    root: PhysicalPlan
    # merge point: PAggregate (kind "agg" — partial fold), PHashJoin (kind
    # "union" — row append), or a semi/anti PHashJoin with a RESIDENT build
    # (kind "mask" — the build's visited mask ORs across partitions and the
    # deferred emission runs once at finish, the streaming flush re-used)
    merge: PhysicalPlan
    kind: str

    @property
    def merge_is_agg(self) -> bool:
        return self.kind == "agg"
    # scan label -> (scan node, BASE column name it is hash-partitioned by);
    # labels shared by several scans of the same table appear once
    parts: Dict[str, Tuple[PScan, str]]


def _hash_mod(v: np.ndarray, K: int) -> np.ndarray:
    """splitmix64 finalizer mod K — a pure function of the VALUE, so equal
    join-key values land in the same partition across different tables and
    integer widths."""
    x = np.asarray(v).astype(np.int64).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(K)).astype(np.int32)


def plan_grace(plan: PhysicalPlan, catalog, row_threshold: int):
    """-> (GracePlan | None, rejection_reason | None).

    When the full big-scan set cannot agree on one partitioning (Q9:
    lineitem meets partsupp on partkey+suppkey but orders on orderkey),
    DEMOTE the smallest big tables back to residency — up to a ceiling a
    chip can actually hold — and retry with the rest. A demoted table pays
    its resident build once; the partitioning constraint set shrinks."""
    all_big = sorted(
        {n.table_name for n in plan.walk() if isinstance(n, PScan)
         and catalog.get(n.table_name).host.num_rows > row_threshold},
        key=lambda t: catalog.get(t).host.num_rows)
    if not all_big:
        return None, "no scan above the residency threshold"
    ceiling = memory_budget().grace_resident_rows
    first_reason = None
    for demote in range(len(all_big)):
        if demote and catalog.get(all_big[demote - 1]).host.num_rows \
                > ceiling:
            break      # too big to sit resident; no point demoting further
        gp, reason = _plan_grace_one(plan, catalog,
                                     set(all_big[demote:]))
        if gp is not None:
            return gp, None
        first_reason = first_reason or reason
    return None, first_reason


def _plan_grace_one(plan: PhysicalPlan, catalog, big_tables):
    big_scans = [n for n in plan.walk() if isinstance(n, PScan)
                 and n.table_name in big_tables]
    if not big_scans:
        return None, "no scan above the residency threshold"
    big_ids = {id(s) for s in big_scans}

    # merge point: the LOWEST decomposable aggregate dominating all big
    # scans; failing that, the root join under the Sort/Limit/Project head
    # (row-union merge, Q2's shape)
    path0 = _path_to(plan, big_scans[0])
    cand = [n for n in path0 if isinstance(n, PAggregate)
            and all(_contains(n, s) for s in big_scans)]
    merge = kind = walk_root = None
    if cand:
        merge = cand[-1]
        bad = [x.func for x in merge.aggs if x.func not in _DECOMPOSABLE]
        if bad:
            return None, f"non-decomposable aggregates at merge point: {bad}"
        kind, walk_root = "agg", merge.child
    else:
        node = plan
        while isinstance(node, (PSort, PLimit, PProject)):
            node = node.child
        if isinstance(node, PHashJoin) \
                and all(_contains(node, s) for s in big_scans):
            merge, kind, walk_root = node, "union", node

    def try_walk(root_node):
        parts: Dict[str, Tuple[PScan, str]] = {}
        covered: set = set()
        reason = _walk(root_node, None, big_ids, parts, catalog, covered)
        if reason is not None:
            return None, reason
        if covered != big_ids:
            return None, ("a big scan has no keyed meet join above it "
                          "(row-range streaming applies, not grace)")
        return parts, None

    parts = reason = None
    if merge is not None:
        parts, reason = try_walk(walk_root)
    else:
        reason = ("no aggregate dominates every big scan and the plan root "
                  "is not Sort/Limit/Project over a single join: no bounded "
                  "merge point")
    if parts is None:
        # MASK merge fallback (Q20's shape): a semi/anti join whose BUILD is
        # resident and whose PROBE subtree holds every big scan selects
        # resident rows — its visited mask is the bounded cross-partition
        # state, the streaming flush machinery emits once at the end
        for j in plan.walk():
            if isinstance(j, PHashJoin) \
                    and j.join_type in (JoinType.LEFT_SEMI,
                                        JoinType.LEFT_ANTI) \
                    and not any(id(m) in big_ids for m in j.build.walk()) \
                    and all(_contains(j.probe, s) for s in big_scans):
                mparts, mreason = try_walk(j.probe)
                if mparts is not None:
                    merge, kind, parts = j, "mask", mparts
                    break
        if parts is None:
            return None, reason
    # partition-column dtypes must hash consistently across tables: require
    # integer-family kinds (dictionary codes are table-local)
    for label, (scan, col) in parts.items():
        f = catalog.get(scan.table_name).host.schema.field(col)
        if f.dtype.kind not in _PART_KINDS:
            return None, (f"partition column {label}.{col} has kind "
                          f"{f.dtype.kind}: codes are table-local and do "
                          "not hash consistently across scans")
    # one partitioning per table
    by_table: Dict[str, set] = {}
    for label, (scan, col) in parts.items():
        by_table.setdefault(scan.table_name, set()).add(col)
    for t, cols in by_table.items():
        if len(cols) > 1:
            return None, (f"{t} would need two different partitionings "
                          f"({sorted(cols)})")
    return GracePlan(plan, merge, kind, parts), None


def _walk(node, req: Optional[str], big_ids, parts, catalog,
          covered: set) -> Optional[str]:
    """Validate `node`'s subtree for per-partition execution; its output
    must be key-partitioned by column `req` (None = unconstrained).
    Returns a rejection reason, or None and fills `parts`."""
    if isinstance(node, PScan):
        if id(node) not in big_ids:
            return None                      # resident leaf on the flow
        if req is None:
            return (f"big scan {node.label} reached with no key requirement "
                    "(row-range streaming applies)")
        if req not in node.schema.names:
            return f"partition column {req} not produced by scan {node.label}"
        base = req.split(".", 1)[1] if "." in req else req
        prev = parts.get(node.label)
        if prev is not None and prev[1] != base:
            return (f"label {node.label} needs two partition columns "
                    f"({prev[1]}, {base})")
        parts[node.label] = (node, base)
        covered.add(id(node))
        return None
    if isinstance(node, PFilter):
        return _walk(node.child, req, big_ids, parts, catalog, covered)
    if isinstance(node, PProject):
        if req is not None:
            e = next((e for e, nm in node.exprs if nm == req), None)
            if not isinstance(e, Col):
                return (f"partition column {req} is computed (not a rename) "
                        "at a projection")
            req = e.name
        return _walk(node.child, req, big_ids, parts, catalog, covered)
    if isinstance(node, PAggregate):
        if req is None:
            return ("an aggregate sits on the partition flow with no key "
                    "requirement")
        if req not in node.group_keys:
            return (f"nested aggregate does not group by partition column "
                    f"{req} — its groups would straddle partitions")
        # group-key output columns keep the child column name; any agg
        # function is fine (the aggregate is EXACT per partition)
        return _walk(node.child, req, big_ids, parts, catalog, covered)
    if isinstance(node, PHashJoin):
        bbig = any(id(m) in big_ids for m in node.build.walk())
        pbig = any(id(m) in big_ids for m in node.probe.walk())
        pairs = list(zip(node.build_keys, node.probe_keys))
        if bbig and pbig:
            # MEET join: both inputs must be partitioned by a key pair —
            # then every key's rows are fully within one partition and ALL
            # 8 join types (+ residual filters) are exact per partition
            if req is None:
                reasons = []
                for bk, pk in pairs:
                    trial: Dict[str, Tuple[PScan, str]] = dict(parts)
                    r = (_walk(node.build, bk, big_ids, trial, catalog, covered)
                         or _walk(node.probe, pk, big_ids, trial, catalog, covered))
                    if r is None:
                        parts.clear()
                        parts.update(trial)
                        return None
                    reasons.append(r)
                return ("no key pair of the meet join supports "
                        f"partitioning: {reasons[0]}")
            if req in node.build.schema.names:
                for bk, pk in pairs:
                    if bk == req:
                        return (_walk(node.build, req, big_ids, parts,
                                      catalog, covered)
                                or _walk(node.probe, pk, big_ids, parts,
                                         catalog, covered))
                return f"meet join not keyed by required column {req}"
            for bk, pk in pairs:
                if pk == req:
                    return (_walk(node.probe, req, big_ids, parts, catalog, covered)
                            or _walk(node.build, bk, big_ids, parts,
                                     catalog, covered))
            return f"meet join not keyed by required column {req}"
        if not (bbig or pbig):
            return None                       # fully resident subtree
        big_side, ok = ((node.build, _BIG_BUILD_OK) if bbig
                        else (node.probe, _BIG_PROBE_OK))
        if node.join_type not in ok:
            side = "build" if bbig else "probe"
            return (f"{node.join_type.value} join with the partitioned flow "
                    f"on the {side} side would emit replicated-side rows "
                    "once per partition")
        if req is not None and req not in big_side.schema.names:
            # the requirement names a resident column: transfer it across an
            # INNER equi-pair (output rows have equal values on both sides)
            if node.join_type is not JoinType.INNER:
                return (f"partition column {req} lives on the resident side "
                        "of a non-inner join")
            for bk, pk in pairs:
                if bbig and pk == req:
                    req = bk
                    break
                if pbig and bk == req:
                    req = pk
                    break
            else:
                return (f"partition column {req} is not equi-joined to the "
                        "partitioned side")
        return _walk(big_side, req, big_ids, parts, catalog, covered)
    return (f"{type(node).__name__} on the partition flow is not "
            "partition-decomposable")


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def run_grace(handle, gp: GracePlan, adaptive) -> DeviceTable:
    """Drive the partition loop. Mirrors runtime/streaming.run_streamed's
    double-buffered dispatch/validate structure, with row-range chunks
    replaced by key-hash partitions of EVERY big scan and no cross-chunk
    visited machinery (partition-locality makes the joins exact)."""
    catalog = handle.catalog
    root = gp.root
    debug = bool(os.environ.get("DFP_STREAM_DEBUG"))
    from ..models.optimizer import required_leaf_columns
    live = required_leaf_columns(root)

    chunk_rows = int(os.environ.get("DFP_STREAM_CHUNK_ROWS", 1 << 22))
    K = 1
    for label, (scan, col) in gp.parts.items():
        n = catalog.get(scan.table_name).host.num_rows
        K = max(K, -(-n // chunk_rows))

    # host partition pass, once per TABLE: hash(col) % K, a stable argsort
    # (indices stay ascending within each partition — sequential-ish memmap
    # reads at pack time), exact per-partition counts (static capacities
    # need no overflow headroom: the sizes are known)
    partinfo: Dict[str, tuple] = {}
    for label, (scan, col) in gp.parts.items():
        t = scan.table_name
        if t in partinfo:
            continue
        reg = catalog.get(t)
        # cached per (column, K) on the registration: consecutive queries
        # partitioning the same table the same way (lineitem by l_orderkey
        # for Q7/8/9/12/18/21) skip the 600M-row hash + stable argsort
        cache = getattr(reg, "_grace_parts", None)
        if cache is None:
            cache = reg._grace_parts = {}
        if (col, K) in cache:
            partinfo[t] = cache[(col, K)]
            continue
        t0 = time.time()
        v, _ = reg.host.columns[col]
        part = _hash_mod(v, K)
        order = np.argsort(part, kind="stable")
        counts = np.bincount(part, minlength=K)
        bounds = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
        partinfo[t] = cache[(col, K)] = (order, bounds, int(counts.max()))
        if debug:
            print(f"[grace] partitioned {t} by {col} into {K} "
                  f"(max {int(counts.max())} rows) in {time.time()-t0:.1f}s",
                  flush=True)

    caps = {}
    layouts, schemas_p = {}, {}
    for label, (scan, _) in gp.parts.items():
        reg = catalog.get(scan.table_name)
        caps[label] = round_capacity(max(1024, partinfo[scan.table_name][2]))
        cols = (live.get(label) or set()) & set(reg.host.schema.names)
        if not cols:
            cols = {reg.host.schema.names[0]}
        fields = [f.with_name(f"{label}.{f.name}")
                  for f in reg.host.schema.fields if f.name in cols]
        schemas_p[label] = Schema(fields)
        layouts[label] = packed_layout(schemas_p[label])
    labels = sorted(gp.parts)

    resident = handle._leaf_tables(skip_labels=tuple(gp.parts))
    # EVERY scan of a partitioned label is big (parts keeps one
    # representative node per label, but a self-join without aliases scans
    # the same label twice — Q18/Q2)
    big_ids = {id(n) for n in root.walk()
               if isinstance(n, PScan) and n.label in gp.parts}

    def has_big(n) -> bool:
        return any(id(m) in big_ids for m in n.walk())

    merge = gp.merge
    merge_sub = {"agg": getattr(merge, "child", None), "union": merge,
                 "mask": getattr(merge, "probe", None)}[gp.kind]

    # frozen builds: joins on the partition flow whose build subtree is
    # fully resident are prepared ONCE outside the loop (reference's
    # build-once / probe-stream split, inner.rs:48-75)
    path_joins = [j for j in merge_sub.walk() if isinstance(j, PHashJoin)
                  and not has_big(j.build) and has_big(j.probe)]
    if gp.kind == "mask":
        # the mask-merge join's own resident build is frozen once too; its
        # visited mask IS the cross-partition accumulator
        path_joins.append(merge)
    prep_nodes = {id(m) for j in path_joins for m in j.build.walk()}
    prep_adaptive = [(k, n) for k, n in adaptive if id(n) in prep_nodes]
    # the union-merge JOIN stays adaptive (its output truncation must grow
    # its join cap); only the agg merge point is excluded (acc_cap owns it)
    sub_adaptive = [(k, n) for k, n in adaptive
                    if not (gp.merge_is_agg and n is merge)
                    and id(n) not in prep_nodes
                    and (any(m is n for m in merge_sub.walk())
                         # the mask-merge join runs inside the partition
                         # program: its candidate capacity stays adaptive
                         or (gp.kind == "mask" and n is merge))]
    head_adaptive = [(k, n) for k, n in adaptive
                     if not any(m is n for m in merge.walk())]

    # seed in-program capacities at est/K: the planner's full-table
    # estimates are K times too big inside one partition (Q18's inner
    # aggregate estimate is ~150M groups; per partition it is ~1M)
    for k, n in sub_adaptive:
        if k in handle._caps:
            continue
        est = 0.0
        if isinstance(n, (PFilter, PHashJoin)):
            est = n.est_rows
        elif isinstance(n, PAggregate):
            est = n.est_groups
        if est > 0:
            handle._caps[k] = round_capacity(int(2 * est / K), minimum=1024)

    prepared = {}
    if path_joins:
        while True:
            pcaps = dict(handle._caps)

            def prep_fn(resident, _caps=pcaps):
                ctx = ExecContext(_caps)
                out = {}
                for j in path_joins:
                    b = j.build.execute(resident, ctx)
                    out[j.join_id] = prepare_build(b, j.build_keys,
                                                   j.strategy)
                totals = [ctx.join_totals.get(kk, jnp.int32(0))
                          for kk, _ in prep_adaptive]
                return out, totals

            t0 = time.time()
            compiled_prep = jax.jit(prep_fn).lower(resident).compile()
            handle._caps.update(pcaps)
            handle.metrics.compile_count += 1
            handle.metrics.compile_time_s += time.time() - t0
            handle.metrics.launches += 1
            prepared, totals = compiled_prep(resident)
            totals = [int(t) for t in totals]
            overflow = False
            for (kk, _), total in zip(prep_adaptive, totals):
                cap = handle._caps.get(kk, total)
                if total > cap:
                    handle._caps[kk] = round_capacity(max(total, 1),
                                                      minimum=1024)
                    overflow = True
            if not overflow:
                break
            handle.metrics.retries += 1

    if gp.kind == "agg":
        partial_specs, merge_specs, finishers = \
            decompose_for_partial(merge.aggs)
        acc_schema = agg_output_schema(merge.child.schema, merge.group_keys,
                                       partial_specs)
        acc_key = merge.node_id
    else:
        partial_specs = merge_specs = finishers = None
        acc_schema = merge.schema
        acc_key = ("gu", merge.join_id)

    def pack_partition(k: int):
        packs, f64s, ns = {}, {}, {}
        for label in labels:
            scan, _ = gp.parts[label]
            reg = catalog.get(scan.table_name)
            order, bounds, _mx = partinfo[scan.table_name]
            rows = order[bounds[k]:bounds[k + 1]]
            cols = {f.name.split(".", 1)[1] for f in schemas_p[label].fields}
            _, _, packed, f64 = pack_host_slice(
                reg.host, cols, 0, len(rows), caps[label],
                rename_prefix=f"{label}.", rows=rows)
            packs[label], f64s[label] = packed, f64
            ns[label] = jnp.int32(len(rows))
        return packs, f64s, ns

    while True:   # accumulator-capacity restarts
        acc_cap = handle._caps.get(acc_key)
        if acc_cap is None:
            if gp.kind == "agg":
                est = (round_capacity(int(2 * merge.est_groups))
                       if merge.est_groups > 0 else 1 << 16)
                acc_cap = max(128, min(est, 1 << 24))
            elif gp.kind == "union":
                est = (round_capacity(int(2 * merge.est_rows))
                       if merge.est_rows > 0 else 1 << 20)
                acc_cap = max(1024, min(est, 1 << 24))
            else:     # mask: the accumulator is the build-sized bool mask
                acc_cap = prepared[merge.join_id].build.capacity
            handle._caps[acc_key] = acc_cap
        acc_real_cap = acc_cap if (gp.kind != "agg"
                                   or merge.group_keys) else 1

        def make_step():
            scaps = dict(handle._caps)

            def step(resident, packs, f64s, ns, acc_cols, acc_rows,
                     prepared, _caps=scaps):
                ctx = ExecContext(_caps, prepared=prepared)
                tables = dict(resident)
                for label in labels:
                    tables[label] = unpack_table(
                        PackedTable(packs[label], f64s[label],
                                    layouts[label]),
                        schemas_p[label], ns[label])
                if gp.kind == "agg":
                    child, row_filter = merge.fused_child(tables, ctx)
                    partial, _ = hash_aggregate_counted(
                        child, merge.group_keys, partial_specs, acc_cap,
                        row_filter)
                    acc = DeviceTable(acc_schema, acc_cols, acc_rows)
                    merged, mtotal = hash_aggregate_counted(
                        concat_tables([acc, partial]), merge.group_keys,
                        merge_specs, acc_cap)
                    out_cols, out_rows = merged.columns, merged.num_rows
                elif gp.kind == "mask":
                    # chunk-wise semi/anti against the frozen resident
                    # build: emission is deferred, only the visited mask
                    # folds (PHashJoin._execute_stream_chunk)
                    ctx.stream_visited = {merge.join_id: acc_cols}
                    merge.execute(tables, ctx)
                    out_cols = ctx.visited_out[merge.join_id]
                    out_rows, mtotal = acc_rows, jnp.int32(0)
                else:
                    out = merge.execute(tables, ctx)
                    # row-union append: scatter this partition's rows after
                    # the accumulated ones (out-of-range drops are pad rows)
                    idx = jnp.arange(out.capacity, dtype=jnp.int32) \
                        + acc_rows
                    valid_row = jnp.arange(out.capacity) < out.num_rows
                    idx = jnp.where(valid_row, idx, acc_cap)
                    out_cols = {}
                    for name, (av, avalid) in acc_cols.items():
                        v, vv = out.columns[name]
                        out_cols[name] = (
                            av.at[idx].set(v, mode="drop"),
                            avalid.at[idx].set(vv & valid_row, mode="drop"))
                    out_rows = acc_rows + out.num_rows
                    mtotal = out_rows
                totals = [ctx.join_totals.get(kk, jnp.int32(0))
                          for kk, _ in sub_adaptive]
                return out_cols, out_rows, mtotal, totals

            return scaps, jax.jit(step)

        scaps, step = make_step()
        compiled = None
        if gp.kind == "mask":
            acc_cols = jnp.zeros(
                (prepared[merge.join_id].build.capacity,), jnp.bool_)
        else:
            acc_cols = {f.name: (jnp.zeros((acc_real_cap,),
                                           f.dtype.device_dtype),
                                 jnp.zeros((acc_real_cap,), jnp.bool_))
                        for f in acc_schema.fields}
        acc_rows = jnp.int32(0)
        restart = False
        handle.metrics.streamed_chunks = 0
        mtotal = 0
        pending = None   # (k, acc_in, outs)

        def validate(pending):
            nonlocal restart, compiled, scaps, step
            k, _, (oc, orr, mt, tot) = pending
            t0 = time.time()
            mt = int(mt)
            tot = [int(x) for x in tot]
            handle.metrics.run_time_s += time.time() - t0
            if debug:
                print(f"[grace] partition {k} mtotal={mt} totals={tot}",
                      flush=True)
            overflow = False
            for (kk, _), total in zip(sub_adaptive, tot):
                cap = handle._caps.get(kk, total)
                if total > cap:
                    handle._caps[kk] = round_capacity(max(total, 1),
                                                      minimum=1024)
                    overflow = True
            if overflow:
                handle.metrics.retries += 1
                scaps, step = make_step()
                compiled = None
                return False, mt
            if mt > acc_cap:
                handle._caps[acc_key] = round_capacity(
                    max(mt, 2 * acc_cap), minimum=1024)
                handle.metrics.retries += 1
                restart = True
                return False, mt
            handle.metrics.streamed_chunks += 1
            return True, mt

        def dispatch(k, acc_cols, acc_rows, packs, f64s, ns):
            nonlocal compiled
            if compiled is None:
                t0 = time.time()
                compiled = step.lower(resident, packs, f64s, ns, acc_cols,
                                      acc_rows, prepared).compile()
                handle._caps.update(scaps)
                handle.metrics.compile_count += 1
                handle.metrics.compile_time_s += time.time() - t0
            handle.metrics.launches += 1
            return compiled(resident, packs, f64s, ns, acc_cols, acc_rows,
                            prepared)

        k = 0
        while k < K and not restart:
            t0 = time.time()
            packs, f64s, ns = pack_partition(k)
            handle.metrics.host_pack_s += time.time() - t0
            # async upload before blocking on the pending partition's
            # scalars: the transfer overlaps partition k-1's compute
            t0 = time.time()
            packs, f64s = jax.device_put((packs, f64s))
            handle.metrics.upload_s += time.time() - t0
            if debug:
                print(f"[grace] partition {k} packed in "
                      f"{time.time()-t0:.2f}s", flush=True)
            if pending is not None:
                ok, mtotal = validate(pending)
                if not ok:
                    if restart:
                        break
                    k, (acc_cols, acc_rows) = pending[0], pending[1]
                    pending = None
                    continue
                acc_cols, acc_rows = pending[2][0], pending[2][1]
                pending = None
            outs = dispatch(k, acc_cols, acc_rows, packs, f64s, ns)
            pending = (k, (acc_cols, acc_rows), outs)
            k += 1
        while pending is not None and not restart:
            ok, mtotal = validate(pending)
            if not ok:
                if restart:
                    break
                kk, (acc_cols, acc_rows) = pending[0], pending[1]
                pending = None
                packs, f64s, ns = pack_partition(kk)
                packs, f64s = jax.device_put((packs, f64s))
                outs = dispatch(kk, acc_cols, acc_rows, packs, f64s, ns)
                pending = (kk, (acc_cols, acc_rows), outs)
                continue
            acc_cols, acc_rows = pending[2][0], pending[2][1]
            pending = None
        if restart:
            continue

        # persist settled capacities (accumulator shrunk to its true size;
        # the mask accumulator is build-sized and never shrinks)
        fit = round_capacity(max(mtotal, 1), minimum=1024)
        if gp.kind != "mask" and acc_cap > 4 * fit:
            handle._caps[acc_key] = fit
        handle.metrics.join_caps = dict(handle._caps)
        handle._save_caps(adaptive)

        # finish: complete the merge point, then run the head above it
        while True:
            hcaps = dict(handle._caps)

            def finish_fn(acc_cols, acc_rows, resident, prepared,
                          _caps=hcaps):
                ctx = ExecContext(_caps)
                if gp.kind == "agg":
                    acc = DeviceTable(acc_schema, acc_cols, acc_rows)
                    out = finish_partial(acc, merge.group_keys, merge.aggs,
                                         finishers, merge.child.schema)
                    if root is merge:
                        return out, []
                    ctx.materialized = {merge.node_id: out}
                elif gp.kind == "mask":
                    from .streaming import _flush_input
                    X = _flush_input(merge, prepared[merge.join_id].build,
                                     acc_cols)
                    ctx.materialized = {merge.join_id: X}
                else:
                    acc = DeviceTable(acc_schema, acc_cols, acc_rows)
                    ctx.materialized = {merge.join_id: acc}
                res = root.execute(resident, ctx)
                totals = [ctx.join_totals.get(kk, jnp.int32(0))
                          for kk, _ in head_adaptive]
                return res, totals

            t0 = time.time()
            compiled_fin = jax.jit(finish_fn).lower(acc_cols, acc_rows,
                                                    resident,
                                                    prepared).compile()
            handle._caps.update(hcaps)
            handle.metrics.compile_count += 1
            handle.metrics.compile_time_s += time.time() - t0
            handle.metrics.launches += 1
            out, totals = compiled_fin(acc_cols, acc_rows, resident,
                                       prepared)
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
