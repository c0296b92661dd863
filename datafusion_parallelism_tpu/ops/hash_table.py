"""Join lookup structures: the vectorized redesign of the reference's ten
concurrent hash-map build versions (reference src/operator/version{1..10},
src/operator/build_implementation.rs:34-112).

Under XLA there are no locks, shards, or compaction barriers: N concurrent
writers + freeze collapses into phased dataflow — hash, bucket-count
(scatter-add), prefix-sum, stable sort into bucket order. The result is a CSR
("bucket offsets + row permutation") structure that the probe side reads with
pure gathers — the vectorized equivalent of the reference's
hash -> (first index + 1) + overflow-chain layout
(reference src/utils/concurrent_self_hash_join_map.rs:165-181), which it chose
for exactly the same reason: chains laid out flat are gather-friendly.

Two strategies (the engine's analog of the reference's `JoinReplacement` axis):
  * CSR   — bucket table with `table_size = 2 * capacity` slots.
  * SORT  — sort rows by hash; probe by binary search (sort-merge fallback,
            no table memory, O(log n) gathers per probe row).

Both produce, per probe row, a contiguous candidate range `[start, start+count)`
in a row permutation — `probe_candidates` returns these as `CandidateRanges`
and join.py flattens the data-dependent 1:N matches into static-capacity
candidate lists via scatter + diff-cumsum row replication (replacing the
reference's dynamic `UInt32BufferBuilder` loop in src/shared/shared.rs:29-47).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp


class JoinStrategy(enum.Enum):
    """The engine's analog of the reference's 10-variant JoinReplacement
    axis. All three strategies are plain XLA; a hand-written GPU join kernel
    is ROADMAP Queue 1 item 7."""
    CSR = "csr"          # bucketed hash table (default)
    SORT = "sort"        # sort-merge on hashes
    OA = "oa"            # open-addressing linear probe (BASELINE north-star
    #                      A/B candidate; probe walks slots iteratively)


class JoinTable(NamedTuple):
    """Frozen build-side lookup structure (a pytree).

    kind_csr:  start_count[2, T+1] int32 rows (bucket starts; bucket counts)
               — the probe fetches both halves of a bucket descriptor in ONE
               2-row minor-axis gather. int32 pair rows, NOT packed int64:
               the pair rows won the A/B on the first device, where int64
               was emulated; whether the GPU agrees is ROADMAP Queue 1.
               Bucket T holds rows with null keys / padding so valid buckets
               never see them. offsets[T+2] kept for inspection/benches.
               Hash equality is NOT rechecked at probe time: the join
               re-checks keys by VALUE anyway (hash_join's equal_rows_arr
               analog), so bucket-collision candidates just fail there.
               DFP_DESC_I64=1 restores the packed-int64 descriptor (A/B).
    kind_sort: sorted_hash[cap] + perm; offsets is unused (size 1).
    kind_oa:   open addressing — sorted_hash[S] holds per-slot packed
               (key-hash-as-int32 << 32 | row_id + 1), 0 = empty slot;
               perm[S] = row id per slot (junk at empty slots); S = T + T/4
               (a spill region past the mask range replaces wraparound).
               offsets has size 2 as the kind tag.
    """
    offsets: jnp.ndarray      # int32; size-1 dummy under SORT, size-2 under OA
    perm: jnp.ndarray         # int32[cap|S] row ids in bucket/sorted/slot order
    sorted_hash: jnp.ndarray  # int64 sorted keys (SORT) / slots (OA) / dummy
    start_count: jnp.ndarray  # int32[2, T+1] (CSR; int64[T+1] under
    #                           DFP_DESC_I64) or size-1 dummy

    @property
    def is_sort(self) -> bool:
        # derived from a static shape so it works across jit boundaries
        return self.offsets.shape[0] == 1

    @property
    def is_oa(self) -> bool:
        return self.offsets.shape[0] == 2


def table_size_for(capacity: int) -> int:
    # 4x load headroom: every probe-side op scales with the candidate count,
    # and false bucket collisions add ~cap/4 candidates at 4x (vs cap/2 at
    # 2x). FLOOR of 64k buckets: a tiny build probed by a huge side pays
    # probe_rows * n_build / T false candidates — a 62-row build in T=4096
    # turned a 6M-row probe into 91k false candidates (SF1 Q18) and
    # ping-ponged the adaptive capacity; 64k buckets cost 512 KB and cap
    # the false-hit rate at n_build/65536 per probe row.
    return max(4 * capacity, 1 << 16)


def slot_of(hashes: jnp.ndarray, T: int) -> jnp.ndarray:
    """Map a uint32 hash to a bucket in [0, T) for ANY T.

    Capacities above 64M round to 4M multiples (columnar.round_capacity), so
    T = 4*cap is not a power of two there and an AND-mask would reach only
    2^popcount(T-1) buckets (e.g. cap=150,994,944 -> 2^27 of 604M buckets),
    inflating the effective load factor ~4-9x. Non-pow2 T uses the
    multiply-shift reduction (Lemire): floor(h * T / 2^32) — uniform for any
    T, one emulated-u64 multiply per row (cheap vs the bucket gather)."""
    if T & (T - 1) == 0:
        return (hashes & jnp.uint32(T - 1)).astype(jnp.int32)
    wide = hashes.astype(jnp.uint64) * jnp.uint64(T)
    return (wide >> jnp.uint64(32)).astype(jnp.int32)


def build_csr(hashes: jnp.ndarray, key_valid: jnp.ndarray, num_rows) -> JoinTable:
    import os
    cap = hashes.shape[0]
    T = table_size_for(cap)
    in_row = jnp.arange(cap, dtype=jnp.int32) < num_rows
    ok = in_row & key_valid
    slot = jnp.where(ok, slot_of(hashes, T), T)
    counts = jnp.zeros((T + 1,), jnp.int32).at[slot].add(1)
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(counts, dtype=jnp.int32)])
    perm = jnp.argsort(slot, stable=True).astype(jnp.int32)
    if os.environ.get("DFP_DESC_I64"):
        start_count = ((offsets[:-1].astype(jnp.int64) << jnp.int64(32))
                       | counts.astype(jnp.uint32).astype(jnp.int64))
    else:
        start_count = jnp.stack([offsets[:-1], counts])
    return JoinTable(offsets, perm, jnp.zeros((1,), jnp.int64), start_count)


def build_sorted(hashes: jnp.ndarray, key_valid: jnp.ndarray, num_rows) -> JoinTable:
    cap = hashes.shape[0]
    in_row = jnp.arange(cap, dtype=jnp.int32) < num_rows
    ok = in_row & key_valid
    # push invalid rows to the top of the sort order with a key > any hash;
    # the stored sorted key is int64 so the sentinel stays sorted
    key = jnp.where(ok, hashes.astype(jnp.int64), jnp.int64(1) << 33)
    perm = jnp.argsort(key, stable=True).astype(jnp.int32)
    sorted_key = jnp.take(key, perm)
    return JoinTable(jnp.zeros((1,), jnp.int32), perm, sorted_key,
                     jnp.zeros((1,), jnp.int64))


def build_oa(hashes: jnp.ndarray, key_valid: jnp.ndarray, num_rows) -> JoinTable:
    """Open-addressing linear-probe table (the BASELINE north-star's build
    variant, A/B'd against CSR — reference analog: the SwissTable insert path
    src/operator/version10/new_map_3/fixed_table.rs:559-675).

    Built without any sequential insertion via the PARKING-FUNCTION scan:
    rows sort by (home slot, hash); linear-probe placement of the i-th
    sorted row is pos_i = i + cummax_{j<=i}(home_j - j) (the classic
    displacement prefix). Same-hash rows land in CONSECUTIVE slots, so the
    probe emits contiguous (start, count) ranges like the other strategies.
    The table is sized T + T/4: displacements spill past the mask range
    instead of wrapping (max pos < T + cap <= T + T/4)."""
    cap = hashes.shape[0]
    T = table_size_for(cap)
    S = T + T // 4
    in_row = jnp.arange(cap, dtype=jnp.int32) < num_rows
    ok = in_row & key_valid
    h32 = jax.lax.bitcast_convert_type(hashes.astype(jnp.uint32), jnp.int32)
    home = slot_of(hashes, T)
    # sort by (home, hash): same-home rows group, same-hash rows adjacent;
    # invalid rows carry a sentinel > any composite and sort last
    composite = ((home.astype(jnp.int64) << jnp.int64(32))
                 | (h32.astype(jnp.int64) & jnp.int64(0xFFFFFFFF)))
    key = jnp.where(ok, composite, jnp.int64(1) << jnp.int64(62))
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    sh = jnp.take(home, order)
    sok = jnp.take(ok, order)
    i = jnp.arange(cap, dtype=jnp.int32)
    disp = jax.lax.cummax(jnp.where(sok, sh - i, -cap))
    pos = jnp.where(sok, i + disp, S)          # invalid rows drop
    sval = ((jnp.take(h32, order).astype(jnp.int64) << jnp.int64(32))
            | (order.astype(jnp.int64) + 1))   # 0 stays "empty"
    slots = jnp.zeros((S,), jnp.int64).at[pos].set(sval, mode="drop")
    perm = jnp.zeros((S,), jnp.int32).at[pos].set(order, mode="drop")
    return JoinTable(jnp.zeros((2,), jnp.int32), perm, slots,
                     jnp.zeros((1,), jnp.int64))


def _probe_oa(table: JoinTable, probe_hashes: jnp.ndarray, ok: jnp.ndarray):
    """Linear-probe walk, all probe rows in lockstep: one m-index gather per
    step until every row has found its (consecutive) hash-match run or an
    empty slot. This iterative walk is the honest open-addressing probe —
    the A/B against CSR's single bucket-descriptor gather."""
    S = table.sorted_hash.shape[0]
    T = 4 * S // 5
    m = probe_hashes.shape[0]
    ph32 = jax.lax.bitcast_convert_type(
        probe_hashes.astype(jnp.uint32), jnp.int32)
    home = slot_of(probe_hashes, T)
    # phase 0 = seeking first match, 1 = counting the run, 2 = done
    phase0 = jnp.where(ok, jnp.int32(0), jnp.int32(2))
    zeros = jnp.zeros((m,), jnp.int32)
    state = (jnp.int32(0), home, zeros, zeros, phase0)

    def cond(st):
        k, _, _, _, phase = st
        return (k < S) & jnp.any(phase < 2)

    def body(st):
        k, cur, start, count, phase = st
        v = jnp.take(table.sorted_hash, cur, mode="clip")
        empty = v == 0
        vhash = (v >> jnp.int64(32)).astype(jnp.int32)
        match = ~empty & (vhash == ph32)
        seeking = phase == 0
        counting = phase == 1
        found = seeking & match
        start = jnp.where(found, cur, start)
        count = jnp.where(found, 1, jnp.where(counting & match,
                                              count + 1, count))
        phase = jnp.where(seeking & empty, 2,
                          jnp.where(found, 1,
                                    jnp.where(counting & ~match, 2, phase)))
        cur = jnp.where(phase < 2, cur + 1, cur)
        return (k + 1, jnp.minimum(cur, S - 1), start, count, phase)

    _, _, start, count, _ = jax.lax.while_loop(cond, body, state)
    return start, count


def build_join_table(hashes, key_valid, num_rows,
                     strategy: JoinStrategy = JoinStrategy.CSR) -> JoinTable:
    if strategy is JoinStrategy.SORT:
        return build_sorted(hashes, key_valid, num_rows)
    if strategy is JoinStrategy.OA:
        return build_oa(hashes, key_valid, num_rows)
    return build_csr(hashes, key_valid, num_rows)


class CandidateRanges(NamedTuple):
    """Per-PROBE-row candidate ranges: row i's candidates live at perm
    positions [start[i], start[i]+count[i]) and occupy output slots
    [base[i], base[i]+count[i]). The flattening of these data-dependent 1:N
    ranges into static-capacity candidate lists happens in join.py via the
    scatter + diff-cumsum row replication (replicate_rows_exact): the probe
    row id and `start - base` ride the replication as two sidecar words, so
    the per-slot perm position is `replicated(start-base) + slot` and no
    separate expansion scatter/cummax exists (this replaces the reference's
    dynamic UInt32BufferBuilder loop in src/shared/shared.rs:29-47)."""
    start: jnp.ndarray       # int32[m] first perm position per probe row
    count: jnp.ndarray       # int32[m] candidates per probe row
    base: jnp.ndarray        # int32[m] first output slot per probe row
    total: jnp.ndarray       # int32 scalar: candidate count (overflow check)


def probe_ranges(table: JoinTable, probe_hashes: jnp.ndarray,
                 probe_key_valid: jnp.ndarray, probe_num_rows):
    """Per probe row: (start, count) range of hash-bucket candidates in perm.

    CSR path fetches the packed (start, count) bucket pair in ONE gather."""
    mcap = probe_hashes.shape[0]
    in_row = jnp.arange(mcap, dtype=jnp.int32) < probe_num_rows
    ok = in_row & probe_key_valid
    if table.is_oa:
        start, count = _probe_oa(table, probe_hashes, ok)
    elif table.is_sort:
        # valid build rows form a sorted prefix (invalid rows carry sentinel
        # key 2^33 > any uint32 hash, so probe hashes never reach them)
        ph = probe_hashes.astype(jnp.int64)
        start = jnp.searchsorted(table.sorted_hash, ph, side="left").astype(jnp.int32)
        end = jnp.searchsorted(table.sorted_hash, ph, side="right").astype(jnp.int32)
        count = end - start
    else:
        T = table.offsets.shape[0] - 2
        slot = slot_of(probe_hashes, T)
        if table.start_count.ndim == 2:
            # ONE 2-row minor-axis gather fetches start and count
            sc = jnp.take(table.start_count, slot, axis=1, mode="clip")
            start, count = sc[0], sc[1]
        else:  # DFP_DESC_I64 packed-int64 descriptor (A/B)
            sc = jnp.take(table.start_count, slot, mode="clip")
            start = (sc >> jnp.int64(32)).astype(jnp.int32)
            count = jnp.bitwise_and(sc,
                                    jnp.int64(0xFFFFFFFF)).astype(jnp.int32)
    count = jnp.where(ok, count, 0)
    return start, count


def probe_candidates(table: JoinTable, probe_hashes, probe_key_valid,
                     probe_num_rows) -> CandidateRanges:
    start, count = probe_ranges(table, probe_hashes, probe_key_valid,
                                probe_num_rows)
    cum = jnp.cumsum(count, dtype=jnp.int32)
    return CandidateRanges(start, count, cum - count, cum[-1])
