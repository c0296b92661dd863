"""Device-memory budget: the thresholds that pick resident, staged, streamed
or grace-partitioned execution, and the test for an out-of-memory error.

Each threshold keeps the ratio to device memory that the engine was first
tuned with, on a device with 15.75 GB of memory: stream a scan above 6 GB or
64M rows, stage a plan whose inputs pass 1 GB, keep at most 96M rows of a
grace-demoted table resident. They are scaled to the device's reported
`bytes_limit` and are not tuned for the GPU. Each one's `DFP_*` environment
variable (`_OVERRIDES`), read on every call, replaces it; executors read only
the budget's fields.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import jax

# the device memory the ratios below were tuned against; also the budget on
# the CPU platform, which reports no memory limit (tests)
TUNED_DEVICE_BYTES = 15_750_000_000


@dataclass(frozen=True)
class MemoryBudget:
    device_bytes: int          # what the device lets one process allocate
    stream_bytes: int          # stream the biggest scan above this upload
    stream_rows: int           # ... or above this many rows
    stage_bytes: int           # stage multi-join plans above this input size
    dist_stage_bytes: int      # ... the same on a mesh (summed over shards)
    grace_resident_rows: int   # largest table grace may demote to resident


_OVERRIDES = {"stream_bytes": "DFP_STREAM_THRESHOLD_BYTES",
              "stream_rows": "DFP_STREAM_ROW_THRESHOLD",
              "stage_bytes": "DFP_STAGE_THRESHOLD_BYTES",
              "dist_stage_bytes": "DFP_DIST_STAGE_THRESHOLD_BYTES",
              "grace_resident_rows": "DFP_GRACE_RESIDENT_CEILING"}


def memory_budget(device=None) -> MemoryBudget:
    """The budget of `device` (default: the first device), with the `DFP_*`
    overrides applied. A non-CPU device that reports no `bytes_limit` is an
    error, not a default."""
    dev = device if device is not None else jax.devices()[0]
    if dev.platform == "cpu":
        limit = TUNED_DEVICE_BYTES
    else:
        limit = (dev.memory_stats() or {}).get("bytes_limit")
        if not limit:
            raise RuntimeError(
                f"{dev.platform} device {dev.device_kind!r} reports no "
                "bytes_limit; cannot size the out-of-core thresholds")
    scale = limit / TUNED_DEVICE_BYTES
    budget = MemoryBudget(
        device_bytes=int(limit),
        stream_bytes=int((6 << 30) * scale),
        stream_rows=int((1 << 26) * scale),
        stage_bytes=int((1 << 30) * scale),
        dist_stage_bytes=int((1 << 30) * scale),
        grace_resident_rows=int((96 << 20) * scale))
    return replace(budget, **{field: int(os.environ[var])
                              for field, var in _OVERRIDES.items()
                              if var in os.environ})


def is_out_of_memory(err: BaseException) -> bool:
    """True when a runtime error is the device running out of memory (at
    compile or run time); every other error is a real failure."""
    msg = str(err)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()
