"""Vectorized hash join: build + probe for all eight join types.

Vectorized redesign of reference src/operator/probe_lookup_implementation/
(inner/full/left_outer/left_semi/left_anti/right_outer/right_semi/right_anti)
and the shared match kernels (reference src/shared/shared.rs:29-92,
src/shared/datafusion_private.rs:40-328):

  * chain walking       -> cumsum/searchsorted candidate expansion (static shapes)
  * equal_rows_arr      -> vectorized per-key-column equality recheck with
                           validity (NULL keys never match; the reference rule
                           rejects null_equals_null, use_parallel_hash_join_rule.rs:87-89)
  * ConcurrentBitSet of visited build rows + last-stream finalizer
    (reference full.rs:77-201) -> scatter-OR into a visited mask + an
    unmatched-rows emit pass; XLA's phased dataflow replaces the barrier
  * apply_join_filter_to_indices -> residual predicate evaluated on gathered
    candidate pairs BEFORE match flags are folded into visited bits

Naming convention matches the reference: the LEFT side is the build side, so
LEFT/LEFT_SEMI/LEFT_ANTI are the types needing the visited-build tracking.
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional, Tuple

import jax.numpy as jnp

from ..utils.columnar import (DeviceTable, Kind, PackedTable, Schema,
                              compaction_indices, hstack_tables,
                              null_columns_like, concat_tables, pack_table,
                              packed_layout, unpack_table,
                              replicate_rows_exact, compact_rows,
                              filter_rows as _filter_rows)
from typing import NamedTuple

from .hashing import hash_rows
from .hash_table import (JoinStrategy, JoinTable, build_join_table,
                         probe_candidates)


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"            # build-side outer
    RIGHT = "right"          # probe-side outer
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"

    @property
    def emits_build(self) -> bool:
        return self in (JoinType.INNER, JoinType.LEFT, JoinType.RIGHT,
                        JoinType.FULL, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)

    @property
    def emits_probe(self) -> bool:
        return self in (JoinType.INNER, JoinType.LEFT, JoinType.RIGHT,
                        JoinType.FULL, JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI)


def join_output_schema(build: Schema, probe: Schema, join_type: JoinType) -> Schema:
    fields = []
    if join_type.emits_build:
        fields += list(build.fields)
    if join_type.emits_probe:
        fields += list(probe.fields)
    return Schema(fields)


def _keys_valid(t: DeviceTable, keys: List[str]) -> jnp.ndarray:
    v = None
    for k in keys:
        _, valid = t.column(k)
        v = valid if v is None else (v & valid)
    return v


def _null_side(schema: Schema, capacity: int, num_rows) -> DeviceTable:
    return DeviceTable(schema, null_columns_like(schema, capacity),
                       jnp.asarray(num_rows, jnp.int32))


class PreparedBuild(NamedTuple):
    """Frozen build side (a pytree): the lookup structure + the build rows.

    The analog of the reference's compacted `IndexLookupProvider` handed from
    build to probe (reference src/operator/lookup_consumers.rs:4-42): built
    ONCE, probed by any number of streamed probe batches. Streaming execution
    hoists these out of the per-chunk program so resident hash tables are not
    rebuilt every chunk (reference inner.rs:48-75 probes a frozen map).

    `perm_rows` stores the packed build rows PHYSICALLY in perm (bucket)
    order with the original row id appended as one extra int32 word: the
    probe then fetches candidate rows (and their ids, for the visited mask)
    directly at the candidate perm position with a single gather — the separate
    `perm[pos]` dereference gather disappears."""
    build: DeviceTable
    table: JoinTable
    perm_rows: PackedTable


def _field_info(layout):
    """name -> (kind, first word slot, word count, validity word row, bit)."""
    info = {}
    for j, (name, kind, slot, n) in enumerate(layout.fields):
        info[name] = (kind, slot, n, layout.valid_base + j // 32, j % 32)
    return info


def _defer_key_plan(blayout, playout, build_keys, probe_keys):
    """Word-row plan for the DEFERRED probe path: which packed rows to
    gather at candidate positions for the key recheck, and how to compare
    them. None when bit-equality of packed words is not equivalent to the
    value recheck (float keys: ±0.0; mixed-width keys: value promotion)."""
    binfo, pinfo = _field_info(blayout), _field_info(playout)
    brows, prows = [], []   # packed row ids to gather, de-duplicated

    def row_of(rows, r):
        if r not in rows:
            rows.append(r)
        return rows.index(r)

    compares = []   # (b word idxs, p word idxs, b vword/bit, p vword/bit)
    for bk, pk in zip(build_keys, probe_keys):
        kb, sb, nb, vwb, bb = binfo[bk]
        kp, sp, np_, vwp, bp = pinfo[pk]
        if (nb != np_ or nb == 0
                or kb in (Kind.FLOAT64, Kind.FLOAT32)
                or kp in (Kind.FLOAT64, Kind.FLOAT32)):
            return None
        bw = [row_of(brows, sb + i) for i in range(nb)]
        pw = [row_of(prows, sp + i) for i in range(nb)]
        compares.append((bw, pw, (row_of(brows, vwb), bb),
                         (row_of(prows, vwp), bp)))
    return brows, prows, compares


def _zero_validity_past(pt: PackedTable, ok) -> PackedTable:
    """Zero validity words of slots past the survivor count (compact_rows'
    contract) so unpacked validity reads False without a row mask."""
    vb = pt.layout.valid_base
    vw = jnp.where(ok[None, :], pt.packed[vb:], 0)
    return PackedTable(jnp.concatenate([pt.packed[:vb], vw], axis=0),
                       pt.f64s, pt.layout)


def _perm_rows(build: DeviceTable, table: JoinTable) -> PackedTable:
    bp = pack_table(build)
    ids = jnp.arange(build.capacity, dtype=jnp.int32)[None, :]
    aug = PackedTable(jnp.concatenate([bp.packed, ids], axis=0),
                      bp.f64s, bp.layout)
    return aug.take_rows(table.perm)


def prepare_build(build: DeviceTable, build_keys: List[str],
                  strategy: JoinStrategy = JoinStrategy.CSR) -> PreparedBuild:
    bh = hash_rows([build.column(k) for k in build_keys])
    bkv = _keys_valid(build, build_keys)
    table = build_join_table(bh, bkv, build.num_rows, strategy)
    return PreparedBuild(build, table, _perm_rows(build, table))


def hash_join(build: DeviceTable, probe: DeviceTable,
              build_keys: List[str], probe_keys: List[str],
              join_type: JoinType, out_cap: int,
              strategy: JoinStrategy = JoinStrategy.CSR,
              residual: Optional[Callable[[DeviceTable], Tuple[jnp.ndarray, jnp.ndarray]]] = None,
              prepared: Optional[PreparedBuild] = None,
              expanded: bool = False,
              build_valid: Optional[jnp.ndarray] = None,
              probe_valid: Optional[jnp.ndarray] = None,
              return_visited: bool = False):
    """Join two device tables. Fully jit-traceable, static shapes.

    residual: optional predicate over the candidate pair table returning
    (bool values, validity); NULL results reject the pair (SQL semantics).
    prepared: pre-built (frozen) build side; `build` is ignored then.

    Returns (result, candidate_total). The caller must check
    candidate_total <= out_cap and retry with a larger out_cap otherwise.

    expanded (INNER/semi/anti): LATE MATERIALIZATION — return
    (table, mask, candidate_total). For INNER the table is the UNCOMPACTED
    candidate slots (capacity == num_rows == out_cap) and mask flags the
    real pairs; callers that fuse the mask downstream (aggregate
    row_filter) skip the pair compaction — an index scatter plus an
    out_cap-index row gather — and the materialized intermediate. For
    semi/anti the table is the surviving INPUT side itself (build for
    LEFT_*, probe for RIGHT_*) and the mask is its match/visited flag, so
    the join emits no gathers at all beyond the probe.

    return_visited: append the raw build-side visited mask (bool[build
    capacity], true where a build row matched THIS probe input, residual
    included) to the returned tuple. Streaming execution folds these masks
    across probe chunks (OR) — the cross-chunk analog of the reference's
    build-side ConcurrentBitSet that outlives every probe batch (reference
    src/operator/probe_lookup_implementation/full.rs:77-201) — and emits the
    deferred unmatched/matched build rows in a final flush pass.

    build_valid / probe_valid: CHAIN FUSION — an input side may itself be
    another join's expanded output: the same capacity of uncompacted rows
    plus this validity mask. Masked rows are excluded from the build table
    buckets / probe candidates / outer-unmatched sets; the child join's
    compaction (its only cost difference, since compaction preserves
    capacity) disappears. Incompatible with `prepared` on the build side.
    """
    assert len(build_keys) == len(probe_keys) >= 1
    if prepared is not None:
        build, table, bperm = (prepared.build, prepared.table,
                               prepared.perm_rows)
    assert not (set(build.schema.names) & set(probe.schema.names)), \
        "join inputs must have disjoint column names (planner qualifies them)"

    ph = hash_rows([probe.column(k) for k in probe_keys])
    pkv = _keys_valid(probe, probe_keys)
    if probe_valid is not None:
        pkv = pkv & probe_valid
    if prepared is None:
        bh = hash_rows([build.column(k) for k in build_keys])
        bkv = _keys_valid(build, build_keys)
        if build_valid is not None:
            bkv = bkv & build_valid
        table = build_join_table(bh, bkv, build.num_rows, strategy)
        bperm = None
    else:
        assert build_valid is None, "prepared build cannot carry a mask"
    cr = probe_candidates(table, ph, pkv, probe.num_rows)

    # ALL join types fetch candidate rows through the same two ops:
    #  * the probe rows are REPLICATED into their candidate segments by ONE
    #    scatter + diff-cumsum (replicate_rows_exact) — no out_cap-size
    #    gather or expansion scatter on the probe side at all. The probe row
    #    id and the per-row `start - base` offset ride the replication as
    #    two sidecar words, so the per-slot perm position `pos` and
    #    `probe_idx` fall out arithmetically;
    #  * the packed build rows stored in perm order are fetched at `pos` in
    #    ONE gather that also carries the build row id (for the visited
    #    mask).
    #
    # DEFERRED MATERIALIZATION (the default when no residual filter needs
    # full candidate rows and the output is compacted anyway): the candidate
    # fetches carry ONLY the key words + validity + build id — per-index
    # gather cost rises with row width past ~8 words (rowgather13 measures
    # 22 ns/idx vs 6.6 narrow), so fetching full W-wide rows at out_cap
    # candidates AND again at the pair compaction paid the wide rate twice.
    # Full rows are gathered ONCE, at the compacted match positions.
    # Expanded (late-materialized) joins and residual-filtered joins still
    # take the full-fetch path: their consumers read whole candidate rows.
    mcap = probe.capacity
    ppacked = pack_table(probe)
    j = jnp.arange(out_cap, dtype=jnp.int32)

    plan = None
    playout = ppacked.layout
    blayout = bperm.layout if bperm is not None else packed_layout(build.schema)
    if residual is None and not (expanded and join_type is JoinType.INNER):
        plan = _defer_key_plan(blayout, playout, build_keys, probe_keys)

    bp_full = None
    if plan is not None:
        brows, prows, compares = plan
        import os
        full_perm = bperm is not None or bool(os.environ.get(
            "DFP_JOIN_FULL_PERM"))
        # the probe KEY words (+ validity word) RIDE THE REPLICATION as extra
        # sidecar rows: the replication's fill gather and the old separate
        # probe-row fetch used IDENTICAL indices, so bundling them turns two
        # out_cap-index gathers into one slightly wider one.
        # Row-slice + stack, NOT fancy indexing: stacked slices keep the
        # [W, cap] major layout the replication gathers.
        rep_src = jnp.stack([ppacked.packed[r] for r in prows]
                            + [jnp.arange(mcap, dtype=jnp.int32),
                               cr.start - cr.base])
        rep = replicate_rows_exact(rep_src, cr.base, cr.count, out_cap)
        pn = rep[:len(prows)]
        probe_idx = rep[-2]
        pos = rep[-1] + j
        cand = j < cr.total
        if full_perm:
            # prepared build: the full-width perm-ordered rows already exist
            # (hoisted out of the per-chunk program by streaming execution);
            # slice the narrow key rows from them
            if bperm is None:
                bperm = _perm_rows(build, table)
            id_row = bperm.packed.shape[0] - 1
            bnarrow = jnp.stack([bperm.packed[r] for r in brows + [id_row]])
        else:
            # permute ONLY the key words + validity word + row id into
            # bucket order — NOT the full packed table. The full-width perm
            # gather costs 22 ns/idx (W=14) per build row and the deferred
            # probe never reads the non-key words at candidate positions;
            # the narrow W<=4 permute costs ~5 ns/idx, and pairs_table
            # fetches full rows from the UNPERMUTED table at the compacted
            # build ids instead.
            bp_full = pack_table(build)
            narrow_src = jnp.stack(
                [bp_full.packed[r] for r in brows]
                + [jnp.arange(build.capacity, dtype=jnp.int32)])
            bnarrow = PackedTable(narrow_src, {},
                                  None).take_rows(table.perm).packed
        bn = PackedTable(bnarrow, {}, None).take_rows(pos).packed
        cand_build_idx = bn[-1]
        # key recheck on packed words: bit equality == value equality for
        # the non-float same-width keys _defer_key_plan admits
        eq = cand
        for bw, pw, (bvr, bbit), (pvr, pbit) in compares:
            for wb, wp in zip(bw, pw):
                eq = eq & (bn[wb] == pn[wp])
            bvalid = ((bn[bvr].view(jnp.uint32) >> jnp.uint32(bbit))
                      & jnp.uint32(1)).astype(jnp.bool_)
            pvalid = ((pn[pvr].view(jnp.uint32) >> jnp.uint32(pbit))
                      & jnp.uint32(1)).astype(jnp.bool_)
            eq = eq & bvalid & pvalid
        match = eq
        gbt = gpt = None
    else:
        if bperm is None:
            bperm = _perm_rows(build, table)
        sidecar = jnp.stack([jnp.arange(mcap, dtype=jnp.int32),
                             cr.start - cr.base], axis=0)
        rep = replicate_rows_exact(
            jnp.concatenate([ppacked.packed, sidecar], axis=0),
            cr.base, cr.count, out_cap)
        probe_idx = rep[-2]
        pos = rep[-1] + j
        cand = j < cr.total
        gp = PackedTable(rep[:-2],
                         {k: jnp.take(v, probe_idx, mode="clip")
                          for k, v in ppacked.f64s.items()},
                         ppacked.layout)
        gb_aug = bperm.take_rows(pos)
        cand_build_idx = gb_aug.packed[-1]
        gb = PackedTable(gb_aug.packed[:-1], gb_aug.f64s, gb_aug.layout)
        gbt = unpack_table(gb, build.schema, out_cap)
        gpt = unpack_table(gp, probe.schema, out_cap)

        # key-equality recheck by value (hash collisions, equal_rows_arr)
        eq = cand
        for bk, pk in zip(build_keys, probe_keys):
            bv, gbv = gbt.column(bk)
            pv, gpv = gpt.column(pk)
            if bv.dtype != pv.dtype:
                wide = jnp.promote_types(bv.dtype, pv.dtype)
                bv, pv = bv.astype(wide), pv.astype(wide)
            eq = eq & gbv & gpv & (bv == pv)
        match = eq

        if residual is not None:
            pair_tbl = hstack_tables(gbt, gpt, out_cap)
            rvals, rvalid = residual(pair_tbl)
            match = match & rvalid & rvals

    if expanded and join_type is JoinType.INNER:
        assert not return_visited
        return hstack_tables(gbt, gpt, out_cap), match, cr.total

    # visited/matched flags (reference ConcurrentBitSet analog)
    bcap, mcap = build.capacity, probe.capacity
    visited = jnp.zeros((bcap,), jnp.bool_).at[
        jnp.where(match, cand_build_idx, bcap)].set(True, mode="drop")
    probe_matched = jnp.zeros((mcap,), jnp.bool_).at[
        jnp.where(match, probe_idx, mcap)].set(True, mode="drop")

    build_in = build.row_mask()
    probe_in = probe.row_mask()
    if build_valid is not None:
        build_in = build_in & build_valid
    if probe_valid is not None:
        probe_in = probe_in & probe_valid

    if expanded:
        # semi/anti late materialization: the result IS one input table
        # masked — return it uncompacted with the mask, skipping
        # _filter_rows' scatter+gather entirely.
        if join_type is JoinType.LEFT_SEMI:
            out = (build, build_in & visited, cr.total)
        elif join_type is JoinType.LEFT_ANTI:
            out = (build, build_in & ~visited, cr.total)
        elif join_type is JoinType.RIGHT_SEMI:
            out = (probe, probe_in & probe_matched, cr.total)
        elif join_type is JoinType.RIGHT_ANTI:
            out = (probe, probe_in & ~probe_matched, cr.total)
        else:
            raise ValueError(f"expanded unsupported for {join_type}")
        return out + (visited,) if return_visited else out

    def pairs_table() -> DeviceTable:
        if gbt is None:
            # deferred path: compact the (build id, probe id) index pairs,
            # then fetch full rows ONCE at the surviving positions.
            cidx, n_match = compaction_indices(match)
            bfirst = pos if bp_full is None else cand_build_idx
            comp = PackedTable(jnp.stack([bfirst, probe_idx]), {},
                               None).take_rows(cidx).packed
            n = jnp.minimum(n_match, out_cap)
            ok = j < n
            if bp_full is None:   # perm-ordered full rows (prepared builds)
                gb_full = PackedTable(bperm.packed[:-1], bperm.f64s,
                                      bperm.layout).take_rows(comp[0])
            else:                 # unpermuted table, fetched at build ids
                gb_full = bp_full.take_rows(comp[0])
            gp_full = ppacked.take_rows(comp[1])
            bt = unpack_table(_zero_validity_past(gb_full, ok),
                              build.schema, n)
            pt = unpack_table(_zero_validity_past(gp_full, ok),
                              probe.schema, n)
            return hstack_tables(bt, pt, n)
        # both sides compact in ONE fused row-gather — see compact_rows
        (cb, cp), n = compact_rows([gb, gp], match, out_cap)
        bt = unpack_table(cb, build.schema, n)
        pt = unpack_table(cp, probe.schema, n)
        return hstack_tables(bt, pt, n)

    def unmatched_build() -> DeviceTable:
        ub = _filter_rows(build, build_in & ~visited)
        nulls = _null_side(probe.schema, ub.capacity, ub.num_rows)
        return hstack_tables(ub, nulls, ub.num_rows)

    def unmatched_probe() -> DeviceTable:
        up = _filter_rows(probe, probe_in & ~probe_matched)
        nulls = _null_side(build.schema, up.capacity, up.num_rows)
        return hstack_tables(nulls, up, up.num_rows)

    if join_type is JoinType.INNER:
        result = pairs_table()
    elif join_type is JoinType.LEFT:
        result = concat_tables([pairs_table(), unmatched_build()])
    elif join_type is JoinType.RIGHT:
        result = concat_tables([pairs_table(), unmatched_probe()])
    elif join_type is JoinType.FULL:
        result = concat_tables([pairs_table(), unmatched_build(),
                                unmatched_probe()])
    elif join_type is JoinType.LEFT_SEMI:
        result = _filter_rows(build, build_in & visited)
    elif join_type is JoinType.LEFT_ANTI:
        result = _filter_rows(build, build_in & ~visited)
    elif join_type is JoinType.RIGHT_SEMI:
        result = _filter_rows(probe, probe_in & probe_matched)
    elif join_type is JoinType.RIGHT_ANTI:
        result = _filter_rows(probe, probe_in & ~probe_matched)
    else:  # pragma: no cover
        raise ValueError(join_type)
    if return_visited:
        return result, cr.total, visited
    return result, cr.total
