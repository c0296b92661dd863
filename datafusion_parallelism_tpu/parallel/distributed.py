"""Distributed hash join over a device mesh (the reference's headline
operator, re-expressed as SPMD dataflow).

The reference shares ONE concurrent hash map between N tokio partition
streams, with a cooperative compaction barrier at the end of the build
(reference src/operator/parallel_hash_join.rs:140-152,
src/operator/build_implementation.rs:50-112). Across devices "shared memory
across partitions" does not exist: each device owns a hash range instead.

Three modes (the planner picks by statistics + join type):

  * PARTITIONED — both sides hash-shuffled (all-to-all), then each
    chip runs the single-chip vectorized join on its range. Correct for all
    eight join types: every key lives on exactly one chip, so visited-row
    bookkeeping stays local.
  * BROADCAST — build side all-gathered to every chip, probe side stays put
    (no shuffle at all). The analog of a broadcast join under the reference's
    optimizer threshold (reference benches/my_benchmark.rs:159). Only for
    probe-driven join types (INNER/RIGHT/RIGHT_SEMI/RIGHT_ANTI): replicated
    build rows would double-count LEFT*/FULL unmatched output.
  * SKEW_SALTED — histogram pass finds heavy key buckets; heavy build rows
    replicate everywhere, heavy probe rows stay local, the rest hash-shuffle
    (parallel/skew.py). Replaces work stealing, which one SPMD program
    cannot do.

Every mode returns (result shard, diagnostics) and the host wrapper owns the
grow-and-retry loop for send/out capacity overflows, mirroring the join
executor's capacity discipline.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.hash_table import JoinStrategy
from ..ops.join import JoinType, hash_join, join_output_schema
from ..utils.columnar import (DeviceTable, HostTable, PackedTable, Schema,
                              pack_table, round_capacity, compact_rows,
                              unpack_table)
from .mesh import PARTITION_AXIS
from .shuffle import (gather_shards, local_table, partition_table,
                      replicating_shuffle, shuffle_by_hash, unlocal_table)
from .skew import (build_replication_mask, heavy_buckets, key_histogram,
                   salted_route)


@dataclass(frozen=True)
class DistJoinConfig:
    mode: str = "partitioned"            # partitioned | broadcast | skew_salted
    join_type: JoinType = JoinType.INNER
    strategy: JoinStrategy = JoinStrategy.CSR
    build_send_cap: int = 1024           # per-destination send block (rows)
    probe_send_cap: int = 1024
    out_cap: int = 4096                  # per-chip join candidate capacity
    skew_factor: float = 8.0

    def probe_driven(self) -> bool:
        return self.join_type in (JoinType.INNER, JoinType.RIGHT,
                                  JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI)


def _all_gather_table(t: DeviceTable, axis: str) -> DeviceTable:
    """Replicate a sharded table to every device, compacting shard padding.

    Packed form: ONE tiled all_gather moves every int32 column + validity
    word (f64 sidecars ride their own, as in every packed layout), and
    ONE fused row-gather compacts the shards' valid prefixes (compact_rows)
    — vs two collectives + two gathers per column unpacked."""
    from .shuffle import _nbytes, record_comm_bytes
    P_ = lax.psum(1, axis)
    nr = lax.all_gather(t.num_rows, axis)                      # [P]
    cap = t.capacity
    mask = (jnp.arange(cap, dtype=jnp.int32)[None, :]
            < nr[:, None]).reshape(P_ * cap)
    pt = pack_table(t)
    g = lax.all_gather(pt.packed, axis, axis=1, tiled=True)    # [W, P*cap]
    f64s = {k: lax.all_gather(v, axis, tiled=True)
            for k, v in pt.f64s.items()}
    record_comm_bytes(_nbytes(g) + sum(_nbytes(v) for v in f64s.values()))
    (cpt,), n = compact_rows([PackedTable(g, f64s, pt.layout)],
                                mask, P_ * cap)
    return unpack_table(cpt, t.schema, n)


def dist_join_shard(build: DeviceTable, probe: DeviceTable,
                    build_keys: List[str], probe_keys: List[str],
                    cfg: DistJoinConfig, axis: str = PARTITION_AXIS,
                    ) -> Tuple[DeviceTable, jnp.ndarray, jnp.ndarray]:
    """Per-device distributed join step. Call INSIDE shard_map.

    Returns (local result shard, global max candidate total, global dropped
    row count). total > out_cap or dropped > 0 means the caller must grow
    capacities and retry.
    """
    dropped = jnp.int32(0)
    if cfg.mode == "broadcast":
        if not cfg.probe_driven():
            raise ValueError(f"broadcast join invalid for {cfg.join_type}")
        b, p = _all_gather_table(build, axis), probe
    elif cfg.mode == "skew_salted":
        if not cfg.probe_driven():
            raise ValueError(f"salted join invalid for {cfg.join_type}")
        hist = key_histogram(probe, probe_keys, axis)
        heavy = heavy_buckets(hist, cfg.skew_factor)
        rep = build_replication_mask(build, build_keys, heavy)
        b, d1 = replicating_shuffle(build, build_keys, cfg.build_send_cap,
                                    rep, axis)
        dest, _ = salted_route(probe, probe_keys, heavy, axis)
        p, d2 = shuffle_by_hash(probe, probe_keys, cfg.probe_send_cap, axis,
                                dest_override=dest)
        dropped = d1 + d2
    else:  # partitioned
        b, d1 = shuffle_by_hash(build, build_keys, cfg.build_send_cap, axis)
        p, d2 = shuffle_by_hash(probe, probe_keys, cfg.probe_send_cap, axis)
        dropped = d1 + d2
    out, total = hash_join(b, p, build_keys, probe_keys, cfg.join_type,
                           cfg.out_cap, strategy=cfg.strategy)
    return out, lax.pmax(total, axis), dropped


def distributed_hash_join(mesh: Mesh, build: HostTable, probe: HostTable,
                          build_keys: List[str], probe_keys: List[str],
                          cfg: Optional[DistJoinConfig] = None,
                          ) -> Tuple[HostTable, DistJoinConfig]:
    """Host entry point: partition, jit the SPMD join, retry on overflow.

    Returns the collected result and the (possibly grown) config actually
    used — callers re-running the same shapes should reuse it.
    """
    cfg = cfg or DistJoinConfig()
    P_ = mesh.devices.size
    axis = mesh.axis_names[0]
    out_schema = join_output_schema(build.schema, probe.schema, cfg.join_type)

    bcols, bnum, bschema, bcap = partition_table(build, P_)
    pcols, pnum, pschema, pcap = partition_table(probe, P_)
    # sane default capacities from the actual shard sizes
    if cfg.build_send_cap < bcap:
        cfg = replace(cfg, build_send_cap=bcap)
    if cfg.probe_send_cap < pcap:
        cfg = replace(cfg, probe_send_cap=pcap)

    spec_tree = P(axis)

    while True:
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(spec_tree,) * 4, out_specs=(spec_tree, P(), P()))
        def step(bcols, bnum, pcols, pnum):
            b = local_table(bschema, bcols, bnum)
            p = local_table(pschema, pcols, pnum)
            out, total, dropped = dist_join_shard(
                b, p, build_keys, probe_keys, cfg, axis)
            ocols, onum = unlocal_table(out)
            return (ocols, onum), total, dropped

        (ocols, onum), total, dropped = jax.jit(step)(bcols, bnum, pcols, pnum)
        total, dropped = int(total), int(dropped)
        if dropped > 0:
            cfg = replace(cfg,
                          build_send_cap=2 * cfg.build_send_cap,
                          probe_send_cap=2 * cfg.probe_send_cap)
            continue
        if total > cfg.out_cap:
            cfg = replace(cfg, out_cap=round_capacity(total))
            continue
        return gather_shards(out_schema, ocols, onum), cfg
