"""Device mesh construction for partition-parallel query execution.

The reference scales with N tokio worker streams over `target_partitions`
(reference src/parse_sql.rs:46-48, src/operator/parallel_hash_join.rs:140-152).
The equivalent here is SPMD over a 1-D `jax.sharding.Mesh` of devices: one
logical partition per device, collectives over the device interconnect
instead of in-process channels (SURVEY.md §2.9, §5.8).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

# The single mesh axis: table rows are hash-partitioned over it. The name is
# shared by every collective in the engine.
PARTITION_AXIS = "p"


def make_mesh(n_devices: Optional[int] = None, axis: str = PARTITION_AXIS,
              platform: Optional[str] = None) -> Mesh:
    """1-D mesh over the first `n_devices` devices (all by default) of
    `platform` (default: JAX's default platform).

    Asking for more devices than the platform has is an error: a CPU mesh is
    asked for explicitly (`platform="cpu"` or `JAX_PLATFORMS=cpu`), never
    substituted for a short accelerator one."""
    devices = jax.devices(platform) if platform else jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} "
                f"{devices[0].platform} devices available")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))
