"""The plain reference on tiny databases: deterministic, independent of
how reads are batched, equal to what the port's `aln` path writes (the
port's CPU engine through run_search, driven by the harness), and voting
for every subject of a Swiss-Prot-sized database."""

from types import SimpleNamespace

import pytest
import torch

from portbench import check, dbcache, reference, run

# Swiss-Prot as released: titin's 35,213 aa at 40-residue frames and band
# 32 give 2,205 bins a subject, and its ~570,000 subjects keys up to
# 1.26e9, past 2^30 from subject 486,958 on
SWISSPROT_NBINS = (35_213 + 40) // 16 + 2


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
                                         ("chain_cell", 2 ** 31 + 78),
                                         ("genome_cell", 2 ** 31 + 80)])
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


def test_propose_chunks_by_keys(chain_cell, monkeypatch):
    """Frames go through propose in passes bounded by their hit keys; the
    candidates do not depend on the passes."""
    _, codes, lens, _ = dbcache.ensure(chain_cell, run.ROOT)
    cfg = chain_cell.search_config()
    sidx = reference.SeedIndex(codes, lens, cfg["seed_len"],
                               cfg["hits_per_seed"], "cpu")
    pool = run.make_pool(chain_cell, codes, lens, 12)
    fr = torch.as_tensor(reference.six_frames(pool[0][1], pool[0][2], 40))
    fr = fr.reshape(-1, 40)
    nbins = (int(lens.max()) + 40) // 32 + 2
    whole = reference.propose(fr, sidx, cfg, nbins)
    monkeypatch.setattr(reference, "PROPOSE_KEYS", 7 * 40 * sidx.width)
    cut = reference.propose(fr, sidx, cfg, nbins)
    assert all(torch.equal(a, b) for a, b in zip(whole, cut))
    assert (whole[0] < reference.BIG).sum() > 100


@pytest.mark.parametrize("chain_gamma", [0, 2])
@pytest.mark.parametrize("sid", [486_950, 569_999])
def test_vote_counts_every_subject(sid, chain_gamma):
    nbins = SWISSPROT_NBINS
    key = sid * nbins + 7
    keys = torch.tensor([[key] * 5 + [key + 1] * 2], dtype=torch.int64)
    k, v = reference.vote(keys, 8, 1, nbins, chain_gamma)
    assert k[0, :2].tolist() == [key, key + 1]
    # chained, the second run takes the first's 5 votes less gamma a bin
    assert v[0, :2].tolist() == [5, 2 if chain_gamma == 0 else 5]
    assert (v[0, 2:] == 0).all()


def test_propose_reaches_the_last_subject():
    """A one-residue seed index whose only entries lie in subject 569,999
    at offsets 100-104: a frame with that residue at position 0 votes for
    the subject's bins 8 (4 seeds) and 9 (1 seed)."""
    sid, Lq = 569_999, 40
    key = torch.zeros(5, dtype=torch.int64)
    sidx = SimpleNamespace(
        k=1, nb=20, width=5, key=key,
        sid=torch.full((5,), sid, dtype=torch.int32),
        off=torch.arange(100, 105, dtype=torch.int32),
        starts=torch.searchsorted(key, torch.arange(22)))
    frames = torch.full((2, Lq), reference.PAD, dtype=torch.int8)
    frames[0, 0] = 0
    cfg = dict(band_width=32, candidates_per_frame=8, min_votes=1)
    g, b = reference.propose(frames, sidx, cfg, SWISSPROT_NBINS)
    assert g[0, :2].tolist() == [sid, sid] and b[0, :2].tolist() == [8, 9]
    assert (g[0, 2:] == reference.BIG).all() and (g[1] == reference.BIG).all()
    assert (b[0, 2:] == reference.BIG).all() and (b[1] == reference.BIG).all()


@pytest.mark.parametrize("loop", [True, False], ids=["shard_loop", "merged"])
def test_program_equals_reference_on_swissprot_full(loop, request):
    """The tiny swissprot_full (its length ranges cut, the titin kept, two
    index shards): the per-shard loop on CSR tables, and the shards merged
    at init on direct tables, each writes the reference's rows."""
    cell = request.getfixturevalue("full_loop_cell" if loop else "full_cell")
    res = run.run_cell(cell, 2 ** 31 + 79, 1.0, False, device="cpu")
    rec = res.pop("_records")
    want = (dict(table_mode="csr", shards=2, presorted_run=0) if loop
            else dict(table_mode="direct", shards=1))
    assert {k: rec["layout"][k] for k in want} == want
    assert res["correct"], res
    assert res["checks"]["reads_differ"]["value"] == 0
    assert rec["reads_written"] == res["attempted"] > 0
