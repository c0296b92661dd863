"""Stage-by-stage decomposition of the join probe's candidate expansion.

Times each stage of the real path in isolation on the device (descriptor
gather, cumsum, scatter + cummax, the [1, out_cap] take_rows vs a plain 1-D
take, the perm dereference) so the probe's cost can be attributed and a
fix validated.

Run: python benches/probe_expand_micro.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from datafusion_parallelism_tpu.ops import hash_table as ht
from datafusion_parallelism_tpu.utils.columnar import (PackedTable,
                                                       replicate_rows_exact)

N = 1 << 22
OUT_CAP = N + N // 2
ITERS = 10


def timeit(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    rng = np.random.default_rng(7)
    bh = jnp.asarray(rng.integers(0, 1 << 31, N).astype(np.uint32))
    ph = jnp.asarray(rng.integers(0, 1 << 31, N).astype(np.uint32))
    ones = jnp.ones((N,), jnp.bool_)
    table = jax.jit(lambda h: ht.build_csr(h, ones, N))(bh)
    jax.tree_util.tree_map(lambda x: x.block_until_ready(), table)

    # full candidate ranges once, as host-side inputs to later stages
    cr = jax.jit(lambda t, h: ht.probe_candidates(t, h, ones, N))(table, ph)
    start = jax.device_put(cr.start)
    count = jax.device_put(cr.count)
    base = jax.device_put(cr.base)

    stages = {}
    # Every stage returns a FULL-materialization reduction (jnp.sum, or
    # sum(x * iota) for prefix-scan outputs): a [-1]-slice consumer lets XLA
    # rewrite the whole stage to a cheap reduction / 1-index gather
    # (a last-element consumer lets XLA skip most of the stage's work).
    iota_c = jnp.arange(OUT_CAP, dtype=jnp.int64)
    iota_n = jnp.arange(N, dtype=jnp.int64)

    # s1: descriptor fetch alone (the int64 start_count gather + unpack)
    @jax.jit
    def s1(t, h):
        s, c = ht.probe_ranges(t, h, ones, N)
        return jnp.sum(s.astype(jnp.int64) * iota_n) + jnp.sum(c)
    stages["probe_ranges (desc gather)"] = timeit(s1, table, ph)

    # s1b: a bare 1-D int32 gather of N for comparison
    idx = jnp.asarray(rng.integers(0, N, N).astype(np.int32))
    vals32 = jnp.asarray(rng.integers(0, 1 << 30, N).astype(np.int32))

    @jax.jit
    def s1b(v, i):
        return jnp.sum(jnp.take(v, i, mode="clip"))
    stages["bare gather(N) int32"] = timeit(s1b, vals32, idx)

    vals64 = vals32.astype(jnp.int64) if jax.config.jax_enable_x64 else None
    if vals64 is not None:
        @jax.jit
        def s1c(v, i):
            return jnp.sum(jnp.take(v, i, mode="clip"))
        stages["bare gather(N) int64"] = timeit(s1c, vals64, idx)

    # s2: + cumsum over count (probe_candidates minus probe_ranges);
    # sum(cum * iota) forces every prefix, not just the total
    @jax.jit
    def s2(c):
        cum = jnp.cumsum(c, dtype=jnp.int32)
        return jnp.sum(cum.astype(jnp.int64) * iota_n)
    stages["cumsum(N)"] = timeit(s2, count)

    # s3: replicate (scatter + cummax + fill gather) on a [1, m] matrix
    p1 = (start - base)[None, :]

    @jax.jit
    def s3(p, b, c):
        rep = replicate_rows_exact(p, b, c, OUT_CAP)
        return jnp.sum(rep[0].astype(jnp.int64) * iota_c)
    stages["replicate [1,m] (scatter+cummax+take_rows)"] = timeit(
        s3, p1, base, count)

    # s3b: scatter + cummax only (no fill gather)
    @jax.jit
    def s3b(b, c):
        dest = jnp.where(c > 0, b, OUT_CAP)
        seg = (jnp.zeros((OUT_CAP,), jnp.int32)
               .at[dest].max(jnp.arange(N, dtype=jnp.int32), mode="drop"))
        return jnp.sum(jax.lax.cummax(seg).astype(jnp.int64) * iota_c)
    stages["scatter(N)+cummax(c)"] = timeit(s3b, base, count)

    # s3c: the fill gather as a plain 1-D take instead of take_rows
    fill_idx = jax.jit(lambda b, c: jax.lax.cummax(
        (jnp.zeros((OUT_CAP,), jnp.int32)
         .at[jnp.where(c > 0, b, OUT_CAP)]
         .max(jnp.arange(N, dtype=jnp.int32), mode="drop"))))(base, count)
    row0 = p1[0]

    @jax.jit
    def s3c(v, i):
        return jnp.sum(jnp.take(v, i, mode="clip"))
    stages["fill gather 1-D take(c)"] = timeit(s3c, row0, fill_idx)

    @jax.jit
    def s3d(p, i):
        return jnp.sum(PackedTable(p, {}, None).take_rows(i).packed[0])
    stages["fill gather take_rows [1,m](c)"] = timeit(s3d, p1, fill_idx)

    # s4: perm deref gather(c) at the REAL index distribution — the
    # replicated (start - base) offsets plus the slot iota, masked to the
    # true candidate total (fill_idx + j ranges to ~2.5x the perm length and
    # mode='clip' would collapse most lookups onto the last element)
    total = int(jax.jit(lambda c: jnp.sum(c, dtype=jnp.int32))(count))
    rep_off = jax.jit(lambda p, i: PackedTable(p, {}, None).take_rows(i)
                      .packed[0])(p1, fill_idx)

    @jax.jit
    def s4(perm, off):
        j = jnp.arange(OUT_CAP, dtype=jnp.int32)
        pos = jnp.where(j < total, off + j, 0)
        return jnp.sum(jnp.take(perm, pos, mode="clip"))
    stages["perm deref gather(c)"] = timeit(s4, table.perm, rep_off)

    for k, v in stages.items():
        print(f"{k:45s} {v:8.2f} ms")


if __name__ == "__main__":
    main()
