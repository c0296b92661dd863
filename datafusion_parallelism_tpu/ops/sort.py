"""ORDER BY: one multi-key lexicographic XLA sort.

Redesign of the reference's batch-ordering study (reference benches/sort.rs —
k-way merge vs concat+sort): under XLA a single `jax.lax.sort` with multiple
key operands replaces any merge strategy; all keys sort in one fused pass.

Key transforms: DESC negates; NULLs follow postgres semantics (larger than
any value: last under ASC, first under DESC); padding rows always sort last
via a leading in-row key. String columns sort by dictionary code, which is
lexicographic because ingest keeps dictionaries sorted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp

from ..utils.columnar import DeviceTable, Kind, gather_table


@dataclass(frozen=True)
class SortKey:
    column: str
    ascending: bool = True
    nulls_first: bool = False  # postgres default: nulls last for ASC


def sort_table(t: DeviceTable, keys: List[SortKey]) -> DeviceTable:
    cap = t.capacity
    in_row = t.row_mask()
    operands = [(~in_row).astype(jnp.int32)]  # padding rows last, always
    for k in keys:
        v, valid = t.column(k.column)
        dt = t.schema.field(k.column).dtype
        if dt.kind in (Kind.FLOAT32, Kind.FLOAT64):
            kv = v.astype(jnp.float64)
            if not k.ascending:
                kv = -kv
            big = jnp.array(jnp.inf, jnp.float64)
        else:
            kv = v.astype(jnp.int64)
            if not k.ascending:
                kv = -kv
            big = jnp.int64(1 << 62)
        # the sort itself is always ascending on the transformed key, so null
        # placement depends only on nulls_first
        kv = jnp.where(valid, kv, -big if k.nulls_first else big)
        operands.append(kv)
    iota = jnp.arange(cap, dtype=jnp.int32)
    res = jax.lax.sort(tuple(operands) + (iota,), dimension=0,
                       is_stable=True, num_keys=len(operands))
    perm = res[-1]
    return gather_table(t, perm, t.num_rows, in_row)


def limit_table(t: DeviceTable, n: int) -> DeviceTable:
    return DeviceTable(t.schema, t.columns,
                       jnp.minimum(t.num_rows, jnp.int32(n)))


def host_sort_table(t, keys: List[SortKey]):
    """Stable host-side sort of a HostTable by the same key semantics as
    sort_table (DESC negates, NULLs per nulls_first, strings by sorted
    dictionary code).

    Used by the distributed executor's ORDER-BY-without-LIMIT path: shards
    pre-sort on their own device and the total order is restored here at
    collection, so NO collective moves the full result (the analog of
    DataFusion's SortPreservingMerge running on the collecting node; the old
    path all-gathered the entire table to every device)."""
    import numpy as np
    n = t.num_rows
    operands = []
    for k in keys:
        v, valid = t.columns[k.column]
        v = np.asarray(v)
        valid = np.asarray(valid)
        if v.dtype.kind == "f":
            kv = v.astype(np.float64)
            big = np.inf
        else:
            kv = v.astype(np.int64)
            big = np.int64(1) << 62
        if not k.ascending:
            kv = -kv
        kv = np.where(valid, kv, -big if k.nulls_first else big)
        operands.append(kv)
    # np.lexsort keys: last key is primary -> reverse; stability preserves
    # the shard-local pre-sort order for equal keys
    perm = np.lexsort(tuple(reversed(operands))) if operands else np.arange(n)
    cols = {name: (v[perm], valid[perm])
            for name, (v, valid) in t.columns.items()}
    return type(t)(t.schema, cols, n)
