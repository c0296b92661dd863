"""Hash aggregate: sort-based grouping + segment reductions.

Vectorized design: instead of a concurrent grouping hash table, rows are
sorted by group-key hash (one XLA sort), group boundaries come from adjacent
comparison (including validity — SQL GROUP BY treats NULLs as one group), and
every aggregate is a `jax.ops.segment_*` reduction with a static segment
capacity. Hash collisions across distinct keys are handled exactly: the
boundary test compares the actual key values, not just hashes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.columnar import (DeviceTable, DType, Field, Kind, Schema,
                              FLOAT64, INT64, compaction_indices, filter_rows)
from .hashing import hash_rows


@dataclass(frozen=True)
class AggSpec:
    func: str                 # 'sum' | 'count' | 'count_star' | 'min' | 'max' | 'avg'
    input: Optional[str]      # input column name (None for count_star)
    output: str               # output column name


def _agg_output_dtype(func: str, in_dtype: Optional[DType]) -> DType:
    if func in ("count", "count_star"):
        return INT64
    if func == "avg":
        return FLOAT64
    if func == "sum":
        if in_dtype.kind in (Kind.INT32, Kind.INT64):
            return INT64
        if in_dtype.kind is Kind.DECIMAL:
            return in_dtype
        return FLOAT64 if in_dtype.kind is Kind.FLOAT64 else in_dtype
    return in_dtype  # min/max


def agg_output_schema(t_schema: Schema, group_keys: List[str],
                      aggs: List[AggSpec]) -> Schema:
    fields = [t_schema.field(k) for k in group_keys]
    for a in aggs:
        in_dt = t_schema.field(a.input).dtype if a.input else None
        nullable = a.func not in ("count", "count_star")
        fields.append(Field(a.output, _agg_output_dtype(a.func, in_dt), nullable))
    return Schema(fields)


def hash_aggregate(t: DeviceTable, group_keys: List[str],
                   aggs: List[AggSpec],
                   out_cap: Optional[int] = None) -> DeviceTable:
    """Group + aggregate; output capacity defaults to the input capacity
    (worst case all rows distinct) — `out_cap` shrinks it adaptively (the
    caller checks returned num_rows for overflow). Fully jit-traceable."""
    result = hash_aggregate_counted(t, group_keys, aggs, out_cap)
    return result[0]


# Direct (sort-free) aggregation kicks in when the product of the group-key
# code domains is at most this. The masked [G, cap] reductions read each agg
# column G times, so the threshold bounds bandwidth, and XLA fuses the
# broadcast-compare-select into the reduction (no [G, cap] materialization).
_DIRECT_MAX_GROUPS = 64


def _direct_domains(schema: Schema, group_keys: List[str]) -> Optional[List[int]]:
    """Per-key static code domains when EVERY group key is dictionary- or
    bool-encoded and the group-id space stays tiny; None otherwise. Domain d
    means codes in [0, d); slot d encodes NULL (SQL groups NULLs together)."""
    doms = []
    total = 1
    for k in group_keys:
        f = schema.field(k)
        if f.dtype.kind is Kind.STRING and f.dictionary is not None:
            doms.append(len(f.dictionary.values))
        elif f.dtype.kind is Kind.BOOL:
            doms.append(2)
        else:
            return None
        total *= doms[-1] + 1
        if total > _DIRECT_MAX_GROUPS:
            return None
    return doms


def _resize_cols(cols, out_schema: Schema, G: int, out_cap: int):
    """Pad or slice [G] columns to the caller's static out_cap capacity."""
    out = {}
    for f in out_schema.fields:
        v, valid = cols[f.name]
        if out_cap > G:
            v = jnp.concatenate(
                [v, jnp.zeros((out_cap - G,), v.dtype)])
            valid = jnp.concatenate(
                [valid, jnp.zeros((out_cap - G,), jnp.bool_)])
        elif out_cap < G:
            v, valid = v[:out_cap], valid[:out_cap]
        out[f.name] = (v, valid)
    return out


def _direct_aggregate(t: DeviceTable, group_keys: List[str],
                      aggs: List[AggSpec], doms: List[int], out_cap: int,
                      out_schema: Schema, row_filter):
    """Perfect (sort-free, hash-free) grouping over static code domains.

    The reference's grouping always walks a hash table; ours normally sorts
    by hash (see hash_aggregate_counted below). When every group key is a
    dictionary code (TPC-H Q1's returnflag x linestatus) the group id is
    arithmetic on the codes, and each aggregate is a fused masked reduction
    over [G, cap] — no argsort, no row gather, no scatter. Group output
    order is gid order == dictionary code order (dictionaries are sorted,
    so this is deterministic and sorted by key).
    """
    cap = t.capacity
    in_row = t.row_mask()
    if row_filter is not None:
        in_row = in_row & row_filter
    G = 1
    for d in doms:
        G *= d + 1
    gid = jnp.zeros((cap,), jnp.int32)
    for k, d in zip(group_keys, doms):
        v, valid = t.column(k)
        code = jnp.where(valid, v.astype(jnp.int32), d)
        gid = gid * (d + 1) + code
    # rows outside the filter match no group slot
    gid = jnp.where(in_row, gid, G)
    onehot = gid[None, :] == jnp.arange(G, dtype=jnp.int32)[:, None]  # [G,cap]

    def gsum(data, mask):
        sel = jnp.where(onehot & mask[None, :], data[None, :],
                        jnp.zeros((), data.dtype))
        return jnp.sum(sel, axis=1)

    rowcount = jnp.sum(onehot, axis=1, dtype=jnp.int64)
    exists = rowcount > 0
    n_groups = jnp.sum(exists, dtype=jnp.int32)

    cols = {}
    # group key values decode arithmetically from the group id
    rem = jnp.arange(G, dtype=jnp.int32)
    for k, d in zip(reversed(group_keys), reversed(doms)):
        code = rem % (d + 1)
        rem = rem // (d + 1)
        kvalid = exists & (code != d)
        f = t.schema.field(k)
        if f.dtype.kind is Kind.BOOL:
            cols[k] = (code == 1, kvalid)
        else:  # dictionary codes; clamp the NULL slot so host decode is safe
            cols[k] = (jnp.clip(code, 0, max(d - 1, 0)), kvalid)

    for a in aggs:
        if a.func == "count_star":
            cols[a.output] = (rowcount, exists)
            continue
        sv, svalid = t.column(a.input)
        cnt = gsum(jnp.ones((cap,), jnp.int64), svalid)
        if a.func == "count":
            cols[a.output] = (cnt, exists)
            continue
        out_dt = out_schema.field(a.output).dtype
        if a.func in ("sum", "avg"):
            acc_dtype = jnp.float64 if out_dt.kind is Kind.FLOAT64 else jnp.int64
            if sv.dtype in (jnp.float32, jnp.float64):
                acc_dtype = jnp.float64
            s = gsum(sv.astype(acc_dtype), svalid)
            if a.func == "avg":
                c = jnp.maximum(cnt, 1)
                v = s.astype(jnp.float64) / c
                if t.schema.field(a.input).dtype.kind is Kind.DECIMAL:
                    v = v / (10.0 ** t.schema.field(a.input).dtype.scale)
                cols[a.output] = (v, exists & (cnt > 0))
            else:
                cols[a.output] = (s.astype(out_dt.device_dtype),
                                  exists & (cnt > 0))
        elif a.func in ("min", "max"):
            fill = _dtype_max(sv.dtype) if a.func == "min" else _dtype_min(sv.dtype)
            sel = jnp.where(onehot & svalid[None, :], sv[None, :], fill)
            v = (jnp.min(sel, axis=1) if a.func == "min"
                 else jnp.max(sel, axis=1))
            cols[a.output] = (v.astype(out_dt.device_dtype), exists & (cnt > 0))
        else:
            raise ValueError(a.func)

    # compact existing groups to the front (G is tiny), then match the
    # caller's static output capacity
    out = filter_rows(DeviceTable(out_schema, cols, jnp.int32(G)), exists)
    kept = jnp.minimum(n_groups, out_cap)
    cols = _resize_cols(out.columns, out_schema, G, out_cap)
    return DeviceTable(out_schema, cols, kept), n_groups


def _single_word_key(t: DeviceTable, group_keys: List[str]):
    """(int32 word, validity) when the whole group key is ONE int32 word
    (int32/date32/dictionary code/bool), else None. Such keys are grouped by
    sorting the VALUE directly — exact by definition, no hash involved.

    This replaced a hash-only fast path that claimed fmix32 injectivity: the
    0xFFFFFFFE clamp in hash_aggregate_counted merges two hash values, and
    NULL keys take the fixed NULL_HASH which collides with the one value v
    where combine(SEED, fmix32(v)) == that hash — either could interleave two
    distinct groups and silently split their aggregates."""
    if len(group_keys) != 1:
        return None
    kind = t.schema.field(group_keys[0]).dtype.kind
    if kind not in (Kind.INT32, Kind.DATE32, Kind.STRING, Kind.BOOL):
        return None
    v, valid = t.column(group_keys[0])
    return v.astype(jnp.int32), valid


def _exact_key_operands(t: DeviceTable, group_keys: List[str]):
    """Extra lax.sort operands that make the grouping sort exact under
    32-bit hash collisions (multi-column keys, int64/decimal, floats): the
    key's canonicalized value words plus ONE validity word over the key
    columns. Rows equal in (hash, words, validity) are exactly the rows of
    one SQL group (NULLs grouped together; -0.0 == 0.0 canonicalized like
    the hash does)."""
    cap = t.capacity
    ops = []
    kv_word = jnp.zeros((cap,), jnp.uint32)
    for i, k in enumerate(group_keys):
        v, valid = t.column(k)
        kind = t.schema.field(k).dtype.kind
        if kind is Kind.FLOAT32:
            words = [jnp.where(v == 0, jnp.float32(0), v).view(jnp.int32)]
        elif kind is Kind.FLOAT64:
            bits = jnp.where(v == 0, jnp.float64(0), v).view(jnp.int64)
            words = [(bits & jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
                     .view(jnp.int32), (bits >> jnp.int64(32))
                     .astype(jnp.int32)]
        elif kind in (Kind.INT64, Kind.DECIMAL):
            words = [(v & jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
                     .view(jnp.int32), (v >> jnp.int64(32))
                     .astype(jnp.int32)]
        elif kind is Kind.BOOL:
            words = [v.astype(jnp.int32)]
        else:
            words = [v.astype(jnp.int32)]
        ops += [jnp.where(valid, w, 0) for w in words]
        kv_word = kv_word | (valid.astype(jnp.uint32) << jnp.uint32(i % 32))
    ops.append(kv_word.view(jnp.int32))
    return ops


def hash_aggregate_counted(t: DeviceTable, group_keys: List[str],
                           aggs: List[AggSpec],
                           out_cap: Optional[int] = None,
                           row_filter=None):
    """-> (table, true group count) — count may exceed the output capacity.

    row_filter: optional bool[cap] mask fused into the aggregate (a filter
    feeding a GLOBAL aggregate needs no compaction at all)."""
    cap = t.capacity
    out_schema = agg_output_schema(t.schema, group_keys, aggs)

    if not group_keys:
        g = _global_aggregate(t, aggs, out_schema, row_filter)
        return g, g.num_rows
    if out_cap is None or out_cap > cap:
        out_cap = cap

    doms = _direct_domains(t.schema, group_keys)
    if doms is not None:
        return _direct_aggregate(t, group_keys, aggs, doms, out_cap,
                                 out_schema, row_filter)

    in_row = t.row_mask()
    if row_filter is not None:
        # fused filter: failing rows become padding — the grouping sort
        # pushes them past the valid prefix, so no separate compaction runs
        in_row = in_row & row_filter
    single = _single_word_key(t, group_keys)
    if single is not None:
        # ONE-int32-word key: sort by the VALUE, not the hash — grouping by
        # value is exact by definition. zone makes valid / NULL / padding
        # rows contiguous (padding strictly last, preserving the prefix
        # property); within the NULL zone the value word is garbage, but the
        # boundary test below treats NULL==NULL as equal so the run never
        # splits. Two int32 sort keys, still far from the 42 ms int64 cliff.
        word, kvalid = single
        zone = jnp.where(in_row, jnp.where(kvalid, 0, 1), 2)
        iota = jnp.arange(cap, dtype=jnp.int32)
        res = jax.lax.sort((zone.astype(jnp.int32), word, iota),
                           dimension=0, is_stable=True, num_keys=2)
        perm = res[-1]
    else:
        h = hash_rows([t.column(k) for k in group_keys])
        # INT32 sort keys: an int64 argsort (hash + 2^33 padding sentinel)
        # measured 42 ms at 4M rows vs ~2 ms for int32. Clamp hashes to
        # 0xFFFFFFFE so 0xFFFFFFFF (biased: INT32_MAX) is free for padding —
        # the prefix property (all valid rows sort before all padding) holds
        # exactly, and the clamp only MERGES the 0xFFFFFFFE/0xFFFFFFFF hash
        # segments: the value-compare sub-sort below still splits distinct
        # keys. EXACTNESS under 32-bit hash collisions: two distinct keys
        # with the same hash can INTERLEAVE inside the equal-hash run of a
        # stable hash-only sort, and adjacent value-comparison then splits
        # each key into multiple output groups (observed: 5 groups from 2
        # interleaved colliding keys). Sub-sorting the run by the key words
        # + key validity makes equal keys contiguous, which is all the
        # boundary test needs.
        h = jnp.minimum(h, jnp.uint32(0xFFFFFFFE))
        biased = jax.lax.bitcast_convert_type(h ^ jnp.uint32(0x80000000),
                                              jnp.int32)
        sort_key = jnp.where(in_row, biased, jnp.int32(0x7FFFFFFF))
        extra = _exact_key_operands(t, group_keys)
        iota = jnp.arange(cap, dtype=jnp.int32)
        res = jax.lax.sort(tuple([sort_key] + extra + [iota]), dimension=0,
                           is_stable=True, num_keys=1 + len(extra))
        perm = res[-1]
    # padding sorts past every valid row, so sorted validity is a PREFIX
    # mask — no gather of in_row through perm needed
    n_valid = jnp.sum(in_row, dtype=jnp.int32)
    sorted_in_row = jnp.arange(cap, dtype=jnp.int32) < n_valid

    # materialize the table in sorted order with ONE packed row-gather; all
    # per-column reads below are then elementwise/shift ops, not gathers.
    # The row hash does NOT ride the gather: boundary detection compares the
    # actual key VALUES below, which subsumes any hash comparison (equal
    # values => equal hashes; unequal values open a boundary regardless of
    # hash) — so the sidecar word would only widen every gathered row.
    from ..utils.columnar import PackedTable, pack_table, unpack_table
    pt = pack_table(t)
    g_ = pt.take_rows(perm)
    st = unpack_table(g_, t.schema, t.num_rows)

    def shift1(a):  # a[i-1] with a[-1] := a[0]
        return jnp.concatenate([a[:1], a[:-1]])

    # group boundary: first row, or any group-key column differs from previous
    boundary = jnp.zeros((cap,), jnp.bool_).at[0].set(True)
    for k in group_keys:
        cv, cvalid = st.column(k)
        pv, pvalid = shift1(cv), shift1(cvalid)
        same = (cvalid & pvalid & (cv == pv)) | (~cvalid & ~pvalid)
        boundary = boundary | ~same
    boundary = boundary & sorted_in_row
    # also open a boundary at the first padding row so padding lands in its own
    # trailing segment (group id >= n_groups, sliced away by num_rows)
    first_pad = (~sorted_in_row) & jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sorted_in_row[:-1]])
    seg = jnp.cumsum((boundary | first_pad).astype(jnp.int32)) - 1
    seg = jnp.maximum(seg, 0)
    n_groups = jnp.sum(boundary, dtype=jnp.int32)

    cols = {}
    kept = jnp.minimum(n_groups, out_cap)
    ok = jnp.arange(out_cap, dtype=jnp.int32) < kept
    # boundary POSITIONS: ONE compaction scatter serves both the group-key
    # row fetch and the prefix-sum reductions below (this and compact_rows
    # used to each pay their own cap-index scatter)
    bpos, _ = compaction_indices(boundary)
    # group key values: the first sorted row of each segment, fetched from
    # the already-packed sorted rows in ONE out_cap row-gather at bpos; XLA
    # dead-code-eliminates the gathered words no group key reads. Slots past
    # kept gather junk; their validity is masked by `ok` below and the key
    # validity words of junk rows are whatever row 0 holds — acceptable
    # because every consumer masks with row_mask()/num_rows.
    bt = g_.take_rows(bpos[:out_cap])
    rep = unpack_table(bt, t.schema, kept)
    for k in group_keys:
        v, valid = rep.columns[k]
        cols[k] = (v, valid & ok)

    # segments are SORTED (rows grouped contiguously), so SUM-family
    # reductions are a prefix sum + two boundary gathers at out_cap — far
    # cheaper than a scatter-add over the full capacity (segment_sum)
    starts = bpos[:out_cap]
    g = jnp.arange(out_cap, dtype=jnp.int32)
    ends = jnp.where(g + 1 < kept, jnp.take(bpos, g + 1, mode="clip") - 1,
                     jnp.maximum(n_valid - 1, 0))

    def seg_sum_sorted(data):
        p = jnp.cumsum(data)
        hi = jnp.take(p, ends, mode="clip")
        lo = jnp.where(starts > 0, jnp.take(p, starts - 1, mode="clip"), 0)
        return hi - lo

    for a in aggs:
        if a.func == "count_star":
            # segment sizes fall out of the boundary positions — no cumsum
            cols[a.output] = ((ends - starts + 1).astype(jnp.int64)
                              * ok.astype(jnp.int64), ok)
            continue
        sv, svalid = st.column(a.input)
        svalid = svalid & sorted_in_row
        cnt = seg_sum_sorted(svalid.astype(jnp.int64))
        if a.func == "count":
            cols[a.output] = (cnt, ok)
            continue
        out_dt = out_schema.field(a.output).dtype
        if a.func in ("sum", "avg"):
            acc_dtype = jnp.float64 if out_dt.kind is Kind.FLOAT64 else jnp.int64
            if sv.dtype in (jnp.float32, jnp.float64):
                acc_dtype = jnp.float64
            data = jnp.where(svalid, sv, 0).astype(acc_dtype)
            s = seg_sum_sorted(data)
            if a.func == "avg":
                c = jnp.maximum(cnt, 1)
                v = s.astype(jnp.float64) / c
                if t.schema.field(a.input).dtype.kind is Kind.DECIMAL:
                    v = v / (10.0 ** t.schema.field(a.input).dtype.scale)
                cols[a.output] = (v, ok & (cnt > 0))
            else:
                cols[a.output] = (s.astype(out_dt.device_dtype), ok & (cnt > 0))
        elif a.func in ("min", "max"):
            # segment ids are sorted (contiguous runs) and only out_cap
            # segments are kept: a bounded sorted-index scatter beats the
            # full-capacity segment_* (padding's trailing segment id can
            # exceed out_cap; mode='drop' discards it)
            if a.func == "min":
                fill = _dtype_max(sv.dtype)
                data = jnp.where(svalid, sv, fill)
                v = jnp.full((out_cap,), fill, sv.dtype).at[seg].min(
                    data, mode="drop", indices_are_sorted=True)
            else:
                fill = _dtype_min(sv.dtype)
                data = jnp.where(svalid, sv, fill)
                v = jnp.full((out_cap,), fill, sv.dtype).at[seg].max(
                    data, mode="drop", indices_are_sorted=True)
            cols[a.output] = (v.astype(out_dt.device_dtype), ok & (cnt > 0))
        else:
            raise ValueError(a.func)
    return DeviceTable(out_schema, cols, kept), n_groups


def decompose_for_partial(aggs: List[AggSpec]):
    """Two-phase (distributed) aggregation plan: AVG is not mergeable, so it
    decomposes into SUM + COUNT partials merged by SUM and finished by a
    divide. Returns (partial_specs, merge_specs, finishers) where finishers
    maps each original output to a callable over the merged columns."""
    partial: List[AggSpec] = []
    merge: List[AggSpec] = []
    finishers = []
    for i, a in enumerate(aggs):
        if a.func == "avg":
            s, c = f"__ps{i}", f"__pc{i}"
            partial += [AggSpec("sum", a.input, s), AggSpec("count", a.input, c)]
            merge += [AggSpec("sum", s, s), AggSpec("sum", c, c)]
            finishers.append((a, ("avg", s, c)))
        elif a.func in ("count", "count_star"):
            p = f"__p{i}"
            partial.append(AggSpec(a.func, a.input, p))
            merge.append(AggSpec("sum", p, p))
            finishers.append((a, ("col", p)))
        elif a.func in ("sum", "min", "max"):
            p = f"__p{i}"
            partial.append(AggSpec(a.func, a.input, p))
            merge.append(AggSpec(a.func, p, p))
            finishers.append((a, ("col", p)))
        else:
            raise ValueError(a.func)
    return partial, merge, finishers


def finish_partial(t: DeviceTable, group_keys: List[str], aggs: List[AggSpec],
                   finishers, in_schema: Schema) -> DeviceTable:
    """Apply finishers after the merge aggregate, restoring the exact
    single-chip output schema."""
    out_schema = agg_output_schema(in_schema, group_keys, aggs)
    cols = {k: t.columns[k] for k in group_keys}
    for a, fin in finishers:
        out_dt = out_schema.field(a.output).dtype
        if fin[0] == "col":
            v, valid = t.columns[fin[1]]
            cols[a.output] = (v.astype(out_dt.device_dtype), valid)
        else:  # avg = sum / count
            _, s_name, c_name = fin
            s, svalid = t.columns[s_name]
            c, _ = t.columns[c_name]
            v = s.astype(jnp.float64) / jnp.maximum(c, 1)
            if a.input is not None and \
                    in_schema.field(a.input).dtype.kind is Kind.DECIMAL:
                v = v / (10.0 ** in_schema.field(a.input).dtype.scale)
            cols[a.output] = (v, svalid & (c > 0))
    return DeviceTable(out_schema, cols, t.num_rows)


def _dtype_max(dt):
    if dt in (jnp.float32, jnp.float64):
        return jnp.array(jnp.inf, dt)
    return jnp.array(jnp.iinfo(dt).max, dt)


def _dtype_min(dt):
    if dt in (jnp.float32, jnp.float64):
        return jnp.array(-jnp.inf, dt)
    return jnp.array(jnp.iinfo(dt).min, dt)


def _global_aggregate(t: DeviceTable, aggs: List[AggSpec],
                      out_schema: Schema, row_filter=None) -> DeviceTable:
    in_row = t.row_mask()
    if row_filter is not None:
        in_row = in_row & row_filter
    cols = {}
    for a in aggs:
        if a.func == "count_star":
            v = jnp.sum(in_row, dtype=jnp.int64)
            cols[a.output] = (v[None], jnp.ones((1,), jnp.bool_))
            continue
        dv, dvalid = t.column(a.input)
        ok = dvalid & in_row
        cnt = jnp.sum(ok, dtype=jnp.int64)
        out_dt = out_schema.field(a.output).dtype
        if a.func == "count":
            cols[a.output] = (cnt[None], jnp.ones((1,), jnp.bool_))
        elif a.func in ("sum", "avg"):
            acc = jnp.float64 if (out_dt.kind is Kind.FLOAT64 or
                                  dv.dtype in (jnp.float32, jnp.float64)) else jnp.int64
            s = jnp.sum(jnp.where(ok, dv, 0).astype(acc))
            if a.func == "avg":
                v = s.astype(jnp.float64) / jnp.maximum(cnt, 1)
                if t.schema.field(a.input).dtype.kind is Kind.DECIMAL:
                    v = v / (10.0 ** t.schema.field(a.input).dtype.scale)
            else:
                v = s.astype(out_dt.device_dtype)
            cols[a.output] = (v[None], (cnt > 0)[None])
        elif a.func == "min":
            v = jnp.min(jnp.where(ok, dv, _dtype_max(dv.dtype)))
            cols[a.output] = (v[None].astype(out_dt.device_dtype), (cnt > 0)[None])
        elif a.func == "max":
            v = jnp.max(jnp.where(ok, dv, _dtype_min(dv.dtype)))
            cols[a.output] = (v[None].astype(out_dt.device_dtype), (cnt > 0)[None])
        else:
            raise ValueError(a.func)
    return DeviceTable(out_schema, cols, jnp.int32(1))
