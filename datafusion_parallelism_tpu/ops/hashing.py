"""Deterministic vectorized row hashing.

Analog of the reference's `calculate_hash` (reference src/shared/shared.rs:11-16,
which uses `create_hashes` with `ahash::RandomState::with_seed(0)`): one seeded,
deterministic hash per row over the join/group key columns.

Design choices:
  * 32-bit hashes (half the bytes of 64-bit ones in every sort and gather).
    Collisions are fine — every consumer re-checks key equality by
    value, exactly like the reference's `equal_rows_arr` recheck.
  * murmur3-style finalizer + boost-style combine, all uint32 vector ops.
  * The same hash drives: hash-table slots (low bits), cross-device partition
    routing (high bits), and group-by pre-sort — so both join sides co-partition
    by construction.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

# numpy scalars, NOT jnp: a module-level jnp constant materializes on a
# device at import time, which initializes the XLA backend and breaks
# jax.distributed.initialize for multi-process runs
SEED = np.uint32(0x9747B28C)
# hash value reserved for NULL keys; equality recheck keeps nulls from matching
NULL_HASH = np.uint32(0xDEADBEEF)


def _fmix32(h: jnp.ndarray) -> jnp.ndarray:
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _hash_values_u32(values: jnp.ndarray) -> jnp.ndarray:
    """Per-element u32 hash of a numeric column."""
    dt = values.dtype
    if dt in (jnp.int32, jnp.uint32):
        return _fmix32(values.astype(jnp.uint32))
    if dt == jnp.bool_:
        return _fmix32(values.astype(jnp.uint32))
    if dt == jnp.float32:
        # canonicalize -0.0 == 0.0
        v = jnp.where(values == 0, jnp.float32(0), values)
        return _fmix32(v.view(jnp.uint32))
    if dt in (jnp.int64, jnp.uint64):
        lo = (values & jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
        hi = (values >> jnp.int64(32)).astype(jnp.uint32)
        return _fmix32(lo ^ (_fmix32(hi) * jnp.uint32(0x9E3779B1)))
    if dt == jnp.float64:
        v = jnp.where(values == 0, jnp.float64(0), values)
        bits = v.view(jnp.int64)
        lo = (bits & jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
        hi = (bits >> jnp.int64(32)).astype(jnp.uint32)
        return _fmix32(lo ^ (_fmix32(hi) * jnp.uint32(0x9E3779B1)))
    raise TypeError(f"unhashable column dtype {dt}")


def combine(h: jnp.ndarray, hv: jnp.ndarray) -> jnp.ndarray:
    """boost::hash_combine-style mixing, uint32."""
    return h ^ (hv + jnp.uint32(0x9E3779B9) + (h << 6) + (h >> 2))


def hash_rows(columns: Sequence[Tuple[jnp.ndarray, jnp.ndarray]]) -> jnp.ndarray:
    """Hash rows over (values, validity) key columns -> uint32[cap].

    NULL keys get a reserved hash; they can land in a bucket but the equality
    recheck (which requires both sides valid) rejects any match.
    """
    assert len(columns) >= 1
    h = None
    for values, validity in columns:
        hv = jnp.where(validity, _hash_values_u32(values), NULL_HASH)
        h = combine(SEED if h is None else h, hv)
    return h
