import os
import tempfile

# Tests run on a virtual 8-device CPU mesh (multi-device sharding is
# validated here; the GPU runs are chip_smoke.py and bench.py).
os.environ["JAX_PLATFORMS"] = "cpu"
# deterministic adaptive-capacity behavior (test_overflow_retry_grows_capacity
# asserts a retry happens; the learned-cap store would skip it on reruns)
os.environ["DFP_NO_CAP_STORE"] = "1"
# keep the CPU compile cache out of the checkout (the package's default is a
# directory inside it)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(tempfile.gettempdir(), "dfp_test_jax_cache"))
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
