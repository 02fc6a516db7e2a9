"""The long-read cell, longread_k5.hifi10k: its files resolve, its search
is long-read mode's on swissprot_k5's database, its pool is genome reads,
its path check asks for kernel R2, and R2's two readers (chain_vote.py)
read a small trace, and nothing where the kernel is absent."""

import json

import numpy as np
import pytest

from portbench import chain_vote, dbcache, longreads, roofline, run, \
    simulate, spec
from portbench.test_portbench_longreads import small_db
from portbench.test_portbench_trace import X, kernel
from portbench.trace import Trace

CELL = "longread_k5.hifi10k"
R2 = "void (anonymous namespace)::chain_vote_kernel<8>(int const*, int)"


def cell():
    return spec.Cell(run.ROOT / "BENCHMARK.json", CELL)


def test_cell_resolves():
    c = cell()
    assert (c.config["name"], c.traffic_name, c.chips) == (
        "longread_k5", "hifi10k", 1)
    assert {m["name"] for m in c.metrics(False)} == {
        "reads_per_s", "batch_p95_ms", "peak_device_gib", "setup_s"}
    assert {m["name"] for m in c.metrics(True)} == {
        "device_ms.chain_vote", "chain_vote_roofline"}
    # the short-read cells do not report R2's metrics
    for other in ("swissprot_k5.reads100", "swissprot_full.reads100"):
        names = {m["name"] for m in spec.Cell(
            run.ROOT / "BENCHMARK.json", other).metrics(True)}
        assert not names & {"device_ms.chain_vote", "chain_vote_roofline"}


def test_search_is_long_read_mode():
    from ghostm_tpu_torch.config import Config

    c = cell()
    cfg = c.search_config()
    assert (cfg["chain_gamma"], cfg["query_frame_len"], cfg["query_batch"],
            cfg["band_width"], cfg["candidates_per_frame"],
            cfg["seed_len"], cfg["hits_per_seed"], cfg["shards"]) == (
        2, 3456, 64, 64, 4, 5, 128, 1)
    assert not cfg.get("smooth_bins")
    Config(**cfg)
    # three frames of 3,456 residues cover the longest read
    assert 3 * cfg["query_frame_len"] == c.traffic["max_read_len"] \
        == c.traffic["read_len_max"] == c.config["read_len_max"]


def test_database_is_swissprot_k5s_with_its_own_cache():
    c = cell()
    k5 = run.ROOT / "portbench" / "configs" / "swissprot_k5.json"
    assert c.config["database"] == json.loads(k5.read_text())["database"]
    assert dbcache.cache_key(c.config_path, run.ROOT) != \
        dbcache.cache_key(k5, run.ROOT)


def test_pool_is_genome_reads():
    c = cell()
    c.traffic.update(pool_batches=2, batch=3)
    codes, lens = small_db()
    seed = 2 ** 31 + 23
    pool = run.make_pool(c, codes, lens, seed)
    assert len(pool) == 2
    want = longreads.reads(simulate.rng_for(seed), codes, lens, 6, c.traffic)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in pool]),
                                  want[0])
    for names, dna, rl in pool:
        assert len(names) == 3 and dna.shape == (3, 10368)
        assert ((rl >= 1000) & (rl <= 10368)).all()
        for d, n in zip(dna, rl):
            assert (d[n:] == longreads.N_BASE).all()
    # several genes a read
    assert (np.bincount(want[3]["read"]) > 1).any()


def test_path_check_asks_for_r2():
    c = cell()
    ok = dict.fromkeys(c.path_check["kernels"], 5)
    assert run.path_check(c, ok, 5) == []
    parent = {k: v for k, v in ok.items() if k != "chain_vote_rank_rows"}
    assert run.path_check(c, parent, 5) == [
        "chain_vote_rank_rows not launched"]
    assert run.path_check(c, dict(ok, sort_vote_rank_rows=1), 5)


def _trace(tmp_path, durs):
    ev = [X("user_annotation", "portbench.window", 0, 1000),
          X("user_annotation", "portbench.launch", 10, 900),
          X("user_annotation", "portbench.propose", 20, 600)]
    ev += kernel("void (anonymous namespace)::sort_tiles_kernel(int)", 25,
                 30, 50, 99)
    for i, d in enumerate(durs):
        ev += kernel(R2, 40 + i, 100 + 50 * i, d, i + 1)
    p = tmp_path / f"t{len(durs)}.json"
    p.write_text(json.dumps(dict(traceEvents=ev)))
    return Trace(str(p))


def test_readers(tmp_path):
    """Two launches at the cell's shape, 300 and 400 us, over 2 profiled
    batches."""
    rec = dict(trace=_trace(tmp_path, [300, 400]), profiled_batches=2,
               cfg=dict(candidates_per_frame=4),
               shapes={"chain_vote_rank_rows": [[[[128, 441_856]], 2]]})
    assert spec.reader("device_ms.chain_vote")(rec) == pytest.approx(0.35)
    least = roofline.bound(*chain_vote.counts(128, 441_856, 4))[0]
    assert spec.reader("chain_vote_roofline")(rec) == pytest.approx(
        100 * 2 * least / 700e-6)
    # a launch the trace lacks: no share
    rec["shapes"]["chain_vote_rank_rows"][0][1] = 3
    assert spec.reader("chain_vote_roofline")(rec) is None


def test_readers_without_the_kernel(tmp_path):
    """The parent's trace: no R2 kernel and no launch counted."""
    rec = dict(trace=_trace(tmp_path, []), profiled_batches=2,
               cfg=dict(candidates_per_frame=4), shapes={})
    assert spec.reader("device_ms.chain_vote")(rec) is None
    assert spec.reader("chain_vote_roofline")(rec) is None
    assert spec.reader("chain_vote_roofline")(
        dict(rec, shapes={"chain_vote_rank_rows": [[[[4, 8]], 1]]}, cfg={})
    ) is None


def test_counts_by_hand():
    # (2, 10) keys, 4 candidates: 80 bytes in, 2 rows x 8 int32 out;
    # 16 operations a key
    assert chain_vote.counts(2, 10, 4) == (2 * 10 * 4 + 2 * 2 * 4 * 4,
                                           16 * 20)
    # the cell's rows: 226,234,368 bytes at 3.35 TB/s
    secs, by = roofline.bound(*chain_vote.counts(128, 441_856, 4))
    assert by == "bytes" and secs * 1e6 == pytest.approx(67.533, rel=1e-4)
