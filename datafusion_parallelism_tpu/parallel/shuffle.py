"""Hash-partition shuffle over the device mesh.

The reference moves rows between its N partition streams with in-process
flume channels and work stealing (reference
src/operator/work_stealing_repartition_exec.rs:50-115,331-365). Across a
device mesh the equivalent is a static all-to-all: every device packs, per
destination, the rows whose key hash routes there, exchanges the fixed-size
blocks with `lax.all_to_all`, and compacts what it received. Static shapes
throughout — a per-destination send capacity replaces dynamic queues, with a
dropped-row counter so the driver can grow the capacity and retry (the same
run -> check -> grow -> recompile discipline as join output capacities).

Routing uses the HIGH bits of the same deterministic row hash whose LOW bits
pick local hash-table slots (ops/hashing.py) — both join sides co-partition by
construction, and routing stays independent of slot choice.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.hashing import hash_rows
from ..utils.columnar import (DeviceTable, HostTable, PackedTable, Schema,
                              pack_table, round_capacity, compact_rows,
                              unpack_table)
from .mesh import PARTITION_AXIS


# ---------------------------------------------------------------------------
# Collective-volume accounting: per-query COMM BYTES, computable exactly at
# trace time from the static shapes every collective moves, reported beside
# per-device work balance. Reset before tracing a step, read after: shapes
# are static, so one trace accounts the whole program.
# Convention: bytes RECEIVED per device per execution of the traced program.
# ---------------------------------------------------------------------------

_COMM_BYTES = [0]


def reset_comm_bytes() -> None:
    _COMM_BYTES[0] = 0


def record_comm_bytes(n: int) -> None:
    _COMM_BYTES[0] += int(n)


def get_comm_bytes() -> int:
    return _COMM_BYTES[0]


def _nbytes(a) -> int:
    import numpy as np
    return int(np.prod(a.shape)) * a.dtype.itemsize


def route_of(hashes: jnp.ndarray, num_partitions: int) -> jnp.ndarray:
    """Destination partition of each row: high hash bits, unbiased for any P."""
    # multiply-shift map of the top 16 bits onto [0, P)
    top = (hashes >> jnp.uint32(16)).astype(jnp.uint32)
    return ((top * jnp.uint32(num_partitions)) >> jnp.uint32(16)).astype(jnp.int32)


def _pack_by_dest(t: DeviceTable, dest: jnp.ndarray, P: int, send_cap: int):
    """Pack rows into per-destination blocks of PACKED rows.

    One fused row-gather moves every column + validity word at once
    (gathers cost per index, not per byte — see utils.columnar.pack_table);
    junk rows at clipped positions are dropped later by send_valid, so no
    per-column validity masking happens here at all.

    Returns (layout, send_packed[W, P, send_cap], f64_send, send_valid,
    dropped)."""
    cap = t.capacity
    order = jnp.argsort(dest, stable=True).astype(jnp.int32)
    sorted_dest = jnp.take(dest, order)
    seg = jnp.searchsorted(sorted_dest, jnp.arange(P + 1, dtype=jnp.int32),
                           side="left").astype(jnp.int32)
    counts = seg[1:] - seg[:-1]                      # [P]
    j = jnp.arange(send_cap, dtype=jnp.int32)
    pos = seg[:-1, None] + j[None, :]                # [P, send_cap]
    idx = jnp.take(order, jnp.minimum(pos, cap - 1))
    send_valid = j[None, :] < counts[:, None]
    pt = pack_table(t)
    send_packed = jnp.take(pt.packed, idx, axis=1)   # [W, P, send_cap]
    f64_send = {k: jnp.take(v, idx) for k, v in pt.f64s.items()}
    dropped = jnp.sum(jnp.maximum(counts - send_cap, 0), dtype=jnp.int32)
    return pt.layout, send_packed, f64_send, send_valid, dropped


def _exchange_and_compact(schema: Schema, layout, send_packed, f64_send,
                          send_valid, P: int, send_cap: int,
                          axis: str) -> DeviceTable:
    """all_to_all the packed blocks and compact received rows to the front.

    ONE collective moves every int32 column (f64 sidecars ride their own,
    as in every packed layout), and
    ONE fused row-gather compacts arrivals (compact_rows) — vs two gathers
    per column in the unpacked form."""
    recv_valid = lax.all_to_all(send_valid, axis, 0, 0)      # [P, send_cap]
    flat_valid = recv_valid.reshape(P * send_cap)
    recv = lax.all_to_all(send_packed, axis, 1, 1)           # [W, P, send_cap]
    recv = recv.reshape(recv.shape[0], P * send_cap)
    f64s = {k: lax.all_to_all(v, axis, 0, 0).reshape(P * send_cap)
            for k, v in f64_send.items()}
    record_comm_bytes(_nbytes(send_valid) + _nbytes(send_packed)
                      + sum(_nbytes(v) for v in f64_send.values()))
    (cpt,), n = compact_rows([PackedTable(recv, f64s, layout)],
                                flat_valid, P * send_cap)
    return unpack_table(cpt, schema, n)


def shuffle_by_hash(t: DeviceTable, keys: List[str], send_cap: int,
                    axis: str = PARTITION_AXIS,
                    dest_override: Optional[jnp.ndarray] = None,
                    valid: Optional[jnp.ndarray] = None,
                    ) -> Tuple[DeviceTable, jnp.ndarray]:
    """Repartition a local shard by key hash. Call INSIDE shard_map.

    Returns (received shard of capacity P*send_cap, globally-summed dropped
    row count). dest_override lets skew handling supply a salted routing.
    valid: LATE MATERIALIZATION — an uncompacted upstream result (e.g. an
    expanded join, see ops/join.py) shuffles directly: rows with valid=False
    are simply never sent, so the child's compaction disappears into the
    shuffle's own routing.
    """
    P = lax.psum(1, axis)
    if dest_override is None:
        h = hash_rows([t.column(k) for k in keys])
        dest = route_of(h, P)
    else:
        dest = dest_override
    # padding rows route to an out-of-range destination and are dropped
    mask = t.row_mask()
    if valid is not None:
        mask = mask & valid
    dest = jnp.where(mask, dest, P)
    layout, send_packed, f64_send, send_valid, dropped = _pack_by_dest(
        t, dest, P, send_cap)
    out = _exchange_and_compact(t.schema, layout, send_packed, f64_send,
                                send_valid, P, send_cap, axis)
    return out, lax.psum(dropped, axis)


def replicating_shuffle(t: DeviceTable, keys: List[str], send_cap: int,
                        replicate: jnp.ndarray, axis: str = PARTITION_AXIS,
                        valid: Optional[jnp.ndarray] = None,
                        ) -> Tuple[DeviceTable, jnp.ndarray]:
    """Shuffle where rows flagged `replicate` are sent to EVERY partition
    (skewed-key build-side broadcast); others route by hash as usual.

    Membership-matrix packing: member[d, i] = routes-to-d OR replicated.
    valid: late-materialization mask, as in shuffle_by_hash.
    """
    P = lax.psum(1, axis)
    h = hash_rows([t.column(k) for k in keys])
    dest = route_of(h, P)
    in_row = t.row_mask()
    if valid is not None:
        in_row = in_row & valid
    cap = t.capacity
    d_ids = jnp.arange(P, dtype=jnp.int32)[:, None]            # [P, 1]
    member = in_row[None, :] & ((dest[None, :] == d_ids) | replicate[None, :])
    csum = jnp.cumsum(member, axis=1, dtype=jnp.int32)         # [P, cap]
    counts = csum[:, -1]                                       # [P]
    j = jnp.arange(send_cap, dtype=jnp.int32)

    def pick(row_csum):  # positions of the 1st..send_cap-th member
        return jnp.searchsorted(row_csum, j + 1, side="left").astype(jnp.int32)

    idx = jnp.minimum(jax.vmap(pick)(csum), cap - 1)           # [P, send_cap]
    send_valid = j[None, :] < counts[:, None]
    pt = pack_table(t)
    send_packed = jnp.take(pt.packed, idx, axis=1)             # one row-gather
    f64_send = {k: jnp.take(v, idx) for k, v in pt.f64s.items()}
    dropped = jnp.sum(jnp.maximum(counts - send_cap, 0), dtype=jnp.int32)
    out = _exchange_and_compact(t.schema, pt.layout, send_packed, f64_send,
                                send_valid, P, send_cap, axis)
    return out, lax.psum(dropped, axis)


# ---------------------------------------------------------------------------
# Host-side shard construction / collection
# ---------------------------------------------------------------------------

def partition_table(t: HostTable, P: int, shard_cap: Optional[int] = None,
                    ) -> Tuple[Dict[str, Tuple[jnp.ndarray, jnp.ndarray]],
                               jnp.ndarray, Schema, int]:
    """Split a host table into P contiguous row shards as stacked arrays.

    Returns (columns of [P, shard_cap] arrays, num_rows[P], schema, shard_cap).
    Feed through shard_map with PartitionSpec('p') on the leading axis.
    """
    import numpy as np
    n = t.num_rows
    per = -(-n // P) if n else 0
    cap = shard_cap or round_capacity(max(per, 1))
    num_rows = np.zeros((P,), dtype=np.int32)
    cols = {}
    for f in t.schema.fields:
        v, valid = t.columns[f.name]
        sv = np.zeros((P, cap), dtype=v.dtype)
        svalid = np.zeros((P, cap), dtype=np.bool_)
        for p in range(P):
            lo, hi = p * per, min((p + 1) * per, n)
            k = max(hi - lo, 0)
            num_rows[p] = k
            if k:
                sv[p, :k] = v[lo:hi]
                svalid[p, :k] = valid[lo:hi]
        cols[f.name] = (jnp.asarray(sv), jnp.asarray(svalid))
    return cols, jnp.asarray(num_rows), t.schema, cap


def local_table(schema: Schema, cols, num_rows) -> DeviceTable:
    """Rebuild a per-device DeviceTable inside shard_map from sharded leaves.

    Sharded leaves arrive with a leading length-1 shard axis; strip it.
    """
    local = {n: (v[0], valid[0]) for n, (v, valid) in cols.items()}
    return DeviceTable(schema, local, num_rows[0])


def unlocal_table(t: DeviceTable):
    """Inverse of local_table: re-add the length-1 shard axis for out_specs."""
    cols = {n: (v[None], valid[None]) for n, (v, valid) in t.columns.items()}
    return cols, t.num_rows[None]


def gather_shards(schema: Schema, cols, num_rows) -> HostTable:
    """Collect sharded results ([P, cap] leaves + num_rows[P]) to one host
    table. Valid rows of every shard are compacted ON DEVICE into one table
    first, so shard padding never crosses the device->host link."""
    return _compact_shards(schema, cols, num_rows).to_host()


@partial(jax.jit, static_argnums=0)
def _compact_shards(schema: Schema, cols, num_rows) -> DeviceTable:
    # one jitted function, so a repeated collect of the same output shape
    # reuses its compiled program instead of tracing and compiling anew
    from ..utils.columnar import concat_tables
    parts = []
    for p in range(num_rows.shape[0]):
        pcols = {n: (v[p], valid[p]) for n, (v, valid) in cols.items()}
        parts.append(DeviceTable(schema, pcols, num_rows[p]))
    return concat_tables(parts)
