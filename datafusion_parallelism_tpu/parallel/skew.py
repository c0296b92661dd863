"""Skewed-key handling: histogram + salted repartition.

The reference mitigates probe-side skew dynamically with
WorkStealingRepartitionExec (reference
src/operator/work_stealing_repartition_exec.rs:50-115) and benchmarks it with
an exponential key distribution (reference src/api_utils.rs:15-23,
benches/exponential_distribution.rs:183). One SPMD program cannot steal work
at runtime —
skew must be resolved at shuffle time (SURVEY.md §2.9):

  1. a coarse histogram of probe-key hash buckets, psum'd across the mesh;
  2. buckets above `factor x` the mean are HEAVY;
  3. build rows in heavy buckets are replicated to every partition
     (replicating_shuffle), probe rows in heavy buckets stay LOCAL —
     so a hot key's probe work spreads over all chips while its build rows
     are available everywhere.

Probe-driven types (INNER, RIGHT, RIGHT_SEMI, RIGHT_ANTI) need nothing
more: their output is a function of each probe row, and every probe row is
processed on exactly one device. Build-side-emitting types (LEFT*/FULL)
would double-count replicated unmatched build rows; they run through
distributed_executor._salted_build_emitting, which keeps heavy build rows
in an identical all-gathered block on every device so their visited masks
OR-reduce positionally and each deferred row is emitted by one owner.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
from jax import lax

from ..ops.hashing import hash_rows
from ..utils.columnar import DeviceTable
from .mesh import PARTITION_AXIS
from .shuffle import route_of

HIST_BITS = 8
HIST_SIZE = 1 << HIST_BITS


def bucket_of(hashes: jnp.ndarray) -> jnp.ndarray:
    """Coarse histogram bucket: top HIST_BITS of the row hash. Aligned with
    route_of (both read the high bits) so a heavy bucket maps onto a stable
    set of destinations."""
    return (hashes >> jnp.uint32(32 - HIST_BITS)).astype(jnp.int32)


def key_histogram(t: DeviceTable, keys: List[str],
                  axis: str = PARTITION_AXIS,
                  valid=None) -> jnp.ndarray:
    """Global HIST_SIZE-bucket histogram of this table's key hashes.
    valid: late-materialization mask (see shuffle_by_hash)."""
    h = hash_rows([t.column(k) for k in keys])
    mask = t.row_mask() if valid is None else (t.row_mask() & valid)
    b = jnp.where(mask, bucket_of(h), HIST_SIZE)
    local = jnp.zeros((HIST_SIZE,), jnp.int32).at[b].add(1, mode="drop")
    return lax.psum(local, axis)


def heavy_buckets(hist: jnp.ndarray, factor: float = 8.0) -> jnp.ndarray:
    """bool[HIST_SIZE]: buckets holding > factor x the mean row count."""
    total = jnp.sum(hist)
    mean = total.astype(jnp.float32) / HIST_SIZE
    return hist.astype(jnp.float32) > (factor * mean)


def salted_route(t: DeviceTable, keys: List[str], heavy: jnp.ndarray,
                 axis: str = PARTITION_AXIS) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row (dest override, is_heavy) for the PROBE side: heavy rows keep
    their current partition (their work is already spread across the mesh by
    the scan partitioning), others route by hash."""
    P = lax.psum(1, axis)
    me = lax.axis_index(axis)
    h = hash_rows([t.column(k) for k in keys])
    is_heavy = jnp.take(heavy, bucket_of(h), mode="clip")
    dest = jnp.where(is_heavy, me, route_of(h, P))
    return dest, is_heavy


def build_replication_mask(t: DeviceTable, keys: List[str],
                           heavy: jnp.ndarray, valid=None) -> jnp.ndarray:
    """bool[cap] for the BUILD side: rows whose key bucket is heavy get
    replicated to every partition by replicating_shuffle."""
    h = hash_rows([t.column(k) for k in keys])
    mask = t.row_mask() if valid is None else (t.row_mask() & valid)
    return jnp.take(heavy, bucket_of(h), mode="clip") & mask
