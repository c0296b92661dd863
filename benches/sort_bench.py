"""Sort/merge strategy study (reference benches/sort.rs:337-416 compared
total sort vs k-way heap merge vs divide&conquer vs arrow concat+sort for
batch-list ordering — it informed V10's k_way_merge_sort).

Under XLA the contenders are different: one multi-operand `lax.sort` carrying
the payload through the sort network vs argsort + packed row-gather. This
bench measures both so the engine's choice (sort_table uses argsort + ONE
packed row-gather) stays justified.

    python benches/sort_bench.py [--rows N] [--cols K]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from benches.bench_lib import report, timeit_block


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--cols", type=int, default=6)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    n, k = args.rows, args.cols
    rng = np.random.default_rng(0)
    key = jnp.asarray(rng.integers(0, n, n).astype(np.int32))
    payload = [jnp.asarray(rng.integers(0, 1000, n).astype(np.int32))
               for _ in range(k)]

    @jax.jit
    def multi_operand_sort(key, *payload):
        res = jax.lax.sort((key,) + payload, dimension=0, is_stable=True,
                           num_keys=1)
        return res[0][0] + sum(p[0] for p in res[1:])

    @jax.jit
    def argsort_then_gather(key, *payload):
        perm = jnp.argsort(key, stable=True)
        packed = jnp.stack(payload, axis=1)
        g = jnp.take(packed, perm, axis=0)
        return jnp.take(key, perm)[0] + jnp.sum(g[0])

    for name, fn in [("multi_operand_sort", multi_operand_sort),
                     ("argsort_packed_gather", argsort_then_gather)]:
        best, mean = timeit_block(
            lambda f=fn: jax.block_until_ready(f(key, *payload)),
                                  warmup=1, iters=5)
        report(f"sort/{name}/{k}cols", n, best, mean)


if __name__ == "__main__":
    main()
