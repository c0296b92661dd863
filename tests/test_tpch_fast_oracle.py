"""The numpy fast-path oracles (used at big scale factors where the row-dict
oracle would need ~60 GB) must agree with the row-dict oracle exactly on
small data."""

import pytest

from datafusion_parallelism_tpu.tpch.datagen import generate_tables
from datafusion_parallelism_tpu.tpch.oracle import _FAST, _IMPL, _rows


@pytest.fixture(scope="module")
def tables():
    return generate_tables(sf=0.01)


@pytest.mark.parametrize("q", sorted(_FAST))
def test_fast_oracle_matches_slow(tables, q):
    slow = _IMPL[q](tables, _rows(tables["lineitem"]))
    fast = _FAST[q](tables)
    assert len(fast) == len(slow)
    for a, b in zip(fast, slow):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], float):
                assert a[k] == pytest.approx(b[k], rel=1e-9), (q, k)
            else:
                assert a[k] == b[k], (q, k)


def test_cli_reuses_oracle_answers(tables, monkeypatch):
    from datafusion_parallelism_tpu.tpch import cli

    argv = ["--query", "6", "--iterations", "1", "--check"]
    answers = {}
    assert cli.run(argv, tables=tables, oracle_cache=answers)["checked"][6]
    assert set(answers) == {6}

    def no_oracle(q, tables):
        raise AssertionError("oracle recomputed")
    monkeypatch.setattr(cli, "oracle_query", no_oracle)
    assert cli.run(argv, tables=tables, oracle_cache=answers)["checked"][6]
