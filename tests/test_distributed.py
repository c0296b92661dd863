"""Multi-chip distributed join tests on a virtual 8-device CPU mesh.

Validates the engine's SPMD layer — hash shuffle, broadcast join, salted
skew repartition — against the brute-force oracle. This is the multi-host
simulation tier the reference lacks entirely (SURVEY.md §4: its 'distributed'
testing is multi-threaded tokio only).
"""

import numpy as np
import pytest

from datafusion_parallelism_tpu.ops.join import JoinType
from datafusion_parallelism_tpu.parallel import (DistJoinConfig,
                                                 distributed_hash_join,
                                                 make_mesh)
from datafusion_parallelism_tpu.utils.columnar import HostTable

from oracle import assert_rows_equal, oracle_join

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, platform="cpu")


def _tables(rng, n_build=200, n_probe=300, key_range=50, skewed=False):
    if skewed:
        # exponential key distribution y=(16^x-1)/15 like the reference's
        # skew generator (reference src/api_utils.rs:15-23)
        x = rng.random(n_probe)
        pkeys = ((key_range * (16.0 ** x - 1) / 15.0)).astype(np.int64)
        bkeys = rng.integers(0, key_range, n_build)
    else:
        pkeys = rng.integers(0, key_range, n_probe)
        bkeys = rng.integers(0, key_range, n_build)
    build = {"b_key": bkeys.tolist(), "b_val": list(range(n_build))}
    probe = {"p_key": pkeys.tolist(), "p_val": list(range(n_probe))}
    # sprinkle NULL keys: they must never match
    build["b_key"][3] = None
    probe["p_key"][5] = None
    return build, probe


def _run(mesh, build, probe, join_type, mode):
    bt = HostTable.from_pydict(build)
    pt = HostTable.from_pydict(probe)
    cfg = DistJoinConfig(mode=mode, join_type=join_type)
    result, _ = distributed_hash_join(mesh, bt, pt, ["b_key"], ["p_key"], cfg)
    expected = oracle_join(
        [dict(zip(build, v)) for v in zip(*build.values())],
        [dict(zip(probe, v)) for v in zip(*probe.values())],
        ["b_key"], ["p_key"], join_type.value)
    assert_rows_equal(result.to_pylist(), expected)


@pytest.mark.parametrize("join_type", list(JoinType))
def test_partitioned_all_types(mesh, join_type):
    rng = np.random.default_rng(42)
    build, probe = _tables(rng)
    _run(mesh, build, probe, join_type, "partitioned")


@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.RIGHT,
                                       JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI])
def test_broadcast_probe_driven(mesh, join_type):
    rng = np.random.default_rng(7)
    build, probe = _tables(rng, n_build=60)
    _run(mesh, build, probe, join_type, "broadcast")


def test_broadcast_rejects_build_emitting(mesh):
    rng = np.random.default_rng(7)
    build, probe = _tables(rng)
    with pytest.raises(ValueError):
        _run(mesh, build, probe, JoinType.LEFT, "broadcast")


@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.RIGHT])
def test_skew_salted_exponential_keys(mesh, join_type):
    """The reference's exponential-distribution skew scenario
    (benches/exponential_distribution.rs:183) under salted repartition."""
    rng = np.random.default_rng(3)
    build, probe = _tables(rng, n_build=100, n_probe=500, key_range=40,
                           skewed=True)
    _run(mesh, build, probe, join_type, "skew_salted")


def test_partitioned_empty_probe(mesh):
    build = {"b_key": [1, 2, 3], "b_val": [10, 20, 30]}
    probe = {"p_key": [99, 98], "p_val": [0, 1]}
    _run(mesh, build, probe, JoinType.FULL, "partitioned")


def test_gather_shards_compiles_once(mesh):
    from datafusion_parallelism_tpu.parallel.shuffle import (
        _compact_shards, gather_shards, partition_table)

    P = mesh.devices.size
    t = HostTable.from_numpy({"k": np.arange(1000, dtype=np.int32),
                              "v": np.arange(1000, dtype=np.float32)})
    cols, nrows, schema, _ = partition_table(t, P)
    first = gather_shards(schema, cols, nrows)
    size = _compact_shards._cache_size()
    again = gather_shards(schema, cols, nrows)
    assert _compact_shards._cache_size() == size   # no new trace/compile
    assert first.to_pylist() == again.to_pylist() == t.to_pylist()
