"""Multi-host (multi-process SPMD) execution support.

The reference is single-process — its "distributed" story is N tokio worker
threads (SURVEY.md §5.8). Here the distributed executor's shard_map program
is process-count-agnostic: under `jax.distributed`, N processes each own a
slice of the global device mesh and execute the SAME compiled program, with
collectives riding the devices' interconnect across hosts. This module holds
the only three process-aware pieces:

  * `init_multihost`     — jax.distributed.initialize wrapper (call once per
                           process before any jax computation);
  * `globalize_tree`     — host numpy pytree (every process holds the full
                           value) -> global jax.Arrays laid out on the mesh;
  * `allgather_tree`     — sharded global outputs -> full numpy on every
                           process (DCN allgather).

Tested by tests/test_multihost.py, which spawns real OS processes over a
virtual CPU mesh — the multi-host simulation layer the reference lacks
(SURVEY.md §4 implication).
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_count: Optional[int] = None):
    """Initialize this process's slice of the global mesh. On CPU,
    `local_device_count` virtual devices per process are created via
    XLA_FLAGS (set it BEFORE importing jax to take effect)."""
    jax.distributed.initialize(coordinator_address, num_processes=num_processes,
                               process_id=process_id)


def globalize_tree(tree, mesh: Mesh, axis: str):
    """numpy pytree (full value on every process, leading dim = mesh size)
    -> global Arrays sharded on `axis`. Each process materializes only its
    addressable shards."""
    def one(a):
        sh = NamedSharding(mesh, PartitionSpec(axis))
        return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])
    return jax.tree.map(one, tree)


def allgather_tree(tree):
    """Sharded global Arrays -> fully-replicated numpy on every process.
    (tiled=True: global inputs come back as the full global value, not
    stacked per process.)"""
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(tree, tiled=True)
