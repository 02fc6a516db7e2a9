"""The plain reference on tiny databases: deterministic, independent of
how reads are batched, and equal to what the port's `aln` path writes
(the port's CPU engine through run_search, driven by the harness)."""

import pytest

from portbench import check, dbcache, run


def _rows(cell, wanted, seq, pool, codes, lens, **kw):
    cfg = cell.search_config()
    return check.reference_rows(pool, wanted, seq, codes, lens, cfg, "cpu",
                                **kw)


def test_reference_is_deterministic_and_per_read(short_cell):
    _, codes, lens, _ = dbcache.ensure(short_cell, run.ROOT)
    pool = run.make_pool(short_cell, codes, lens, 11)
    seq = [0, 1, 2, 0]
    wanted = check.sample(11, 4, short_cell.traffic["batch"], 96)
    a = _rows(short_cell, wanted, seq, pool, codes, lens)
    b = _rows(short_cell, wanted, seq, pool, codes, lens)
    c = _rows(short_cell, wanted[::-1][:40], seq, pool, codes, lens)
    assert a == b
    assert all(c[p] == a[p] for p in c)
    assert sum(len(v) for v in a.values()) > 20


@pytest.mark.parametrize("which, seed", [("short_cell", 2 ** 31 + 77),
                                         ("short_cell", 4),
                                         ("chain_cell", 2 ** 31 + 78)])
def test_program_equals_reference(which, seed, request):
    cell = request.getfixturevalue(which)
    res = run.run_cell(cell, seed, 1.0, False, device="cpu")
    rec = res.pop("_records")
    assert res["correct"], res
    assert res["checks"]["reads_differ"]["value"] == 0
    assert rec["reads_written"] == res["attempted"] > 0
    # no device memory on a CPU
    assert set(res["metrics"]) == {"reads_per_s", "batch_p95_ms", "setup_s"}
    assert res["failed"] == 0
