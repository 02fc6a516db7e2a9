"""The port's ("data", "db") grid of ranks against the JAX package, on the
CPU over gloo (the counterparts of tests/test_distributed.py), and the
engine's codes entry (search_batch, refine, search_refine_async) against
the JAX engine's. Tolerance 0.

The parent process builds the index (1 and 2 shards, `db` of the JAX
package) and the JAX references and writes the frames to a temporary
directory; each grid shape starts its ranks once for the module
(`grids`): the ranks import only the port, run every case of that shape,
and write their outputs back for the tests here to compare. Fault F6 of
the JAX package (its mesh step cannot reshape a tail batch whose read
count does not divide by the data axis) is pinned on both sides."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.ops.encode import encode_dna
from ghostm_tpu.parallel.mesh import make_mesh as jmake_mesh
from ghostm_tpu_torch import engine as tengine
from ghostm_tpu_torch.config import Config as TConfig
from ghostm_tpu_torch.index import diskio as tdiskio
from ghostm_tpu_torch.parallel import launch
from ghostm_tpu_torch.parallel.mesh import Mesh
from tools.simulate import random_proteins, reads_from_proteins, write_fasta

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)

CFG = dict(query_batch=16, max_hits=5)
B50 = dict(matrix="BLOSUM50", gap_open=13, gap_extend=2)
HIT_FIELDS = ("score", "gsid", "frame", "qend", "s_end", "bend", "g0",
              "srow", "shard")
STAT_KEYS = ("qstart", "qend", "sstart", "send", "length", "matches",
             "mismatch", "gapopen", "score_check")
# (data, db) -> the index's shard count: the grid shapes started
GRIDS = {(2, 1): 1, (1, 2): 2, (2, 2): 2, (4, 1): 1}

# One rank: argv = coordinator, rank, data, db, directory. Runs every case
# of its grid shape and saves its outputs as out-{data}x{db}-r{rank}.npz.
WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from ghostm_tpu_torch import engine as E
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.engine import SearchEngine
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.parallel.mesh import init_distributed, make_mesh

# the step's graph rule as on a CUDA device: a grid rank still runs eager
E.graphs_device = lambda dev: True

coord, rank, data, db, d = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
init_distributed(coord, data * db, rank)
mesh = make_mesh(data, db)
mesh.time_collectives = True
index = load_index(f"{d}/idx{db}")
qc = np.load(f"{d}/qcodes.npy")
out = {}

def save(tag, hits, stats):
    for f in hits.__dataclass_fields__:
        out[f"{tag}.{f}"] = getattr(hits, f)
    for k, v in stats.items():
        out[f"{tag}.stat.{k}"] = v

cases = [("b62", {})] + ([("b50", dict(matrix="BLOSUM50", gap_open=13,
                                        gap_extend=2))] if (data, db) == (1, 2)
                         else [])
for tag, kw in cases:
    eng = SearchEngine(Config(query_batch=16, max_hits=5, **kw), index,
                       device="cpu", mesh=mesh)
    out[f"{tag}.table_mode"] = np.array(eng.table_mode)
    hits, stats = eng.search_batch_stats(qc)
    save(tag, hits, stats)
    out[f"{tag}.refine"] = np.stack([v for v in eng.refine(qc, hits).values()])
    out[f"{tag}.search_batch"] = eng.search_batch(qc).score
    local = eng.search_batch_stats_local(qc)
    out[f"{tag}.local_rows"] = np.array([st0 for st0, _, _ in local])
    for st0, h, s in local:
        save(f"{tag}.local", h, s)
    if (data, db) == (2, 2):
        save(f"{tag}.tail5", *eng.search_batch_stats(qc[:5]))
    out[f"{tag}.graphs"] = np.array([eng.graph_captures, eng.graph_replays,
                                     eng.last_graph_stages, eng.graph_eager])
out["collectives"] = np.array(sorted(mesh.collective_s))
np.savez(f"{d}/out-{data}x{db}-r{rank}.npz", **out)
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """40 proteins of 60-150 aa, 16 reads of 90 bp (the last two all N),
    the index at 1 and 2 shards, the frames, and the JAX loop engines'
    references."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(3)
    prots = random_proteins(rng, 40, lo=60, hi=150)
    write_fasta(str(d / "db.fa"), [f"s{i}" for i in range(len(prots))], prots)
    for n in (1, 2):
        assert jcli(["db", "-i", str(d / "db.fa"), "-o", str(d / f"idx{n}"),
                     "--shards", str(n)]) == 0
    _, reads = reads_from_proteins(rng, prots, 16, read_len=90)
    dna = np.full((16, 90), 4, np.int8)
    lens = np.zeros(16, np.int32)
    for i, r in enumerate(reads):
        c = encode_dna(r)
        dna[i, :len(c)] = c
        lens[i] = len(c)
    dna[14:] = 4    # two all-N reads: rows of score-0 hits
    # the JAX loop engine over each index, the 2-shard one unmerged (the
    # per-shard loop: its shard-local g0 / srow / shard are a db grid's)
    refs = {}
    os.environ["GHOSTM_TPU_MERGE_COLOCATED"] = "0"
    try:
        for n, tag, kw in ((1, "b62", {}), (2, "b62", {}), (2, "b50", B50)):
            eng = jengine.SearchEngine(JConfig(**CFG, **kw),
                                       jdiskio.load_index(str(d / f"idx{n}")),
                                       use_pallas=False)
            qc = eng.translate(dna, lens)
            hits = eng.search_batch(qc)
            refs[n, tag] = (hits, eng.refine(qc, hits))
            refs[n, tag, "tail5"] = eng.search_batch(qc[:5])
    finally:
        del os.environ["GHOSTM_TPU_MERGE_COLOCATED"]
    np.save(d / "qcodes.npy", qc)
    want = refs[1, "b62"][0].score
    assert want.max() > 0 and (want == 0).any()
    return d, qc, refs


@pytest.fixture(scope="module")
def grids(data):
    """Start each grid shape's ranks once; returns {(data, db): [each
    rank's outputs]}."""
    d = data[0]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for (a, b) in GRIDS:
        procs = launch.start_ranks(
            lambda r, coord: [sys.executable, "-c", WORKER, coord, str(r),
                              str(a), str(b), str(d)], a * b, env=env)
        assert launch.wait_ranks(procs, timeout=300) == 0, f"grid {a}x{b}"
    return {(a, b): [dict(np.load(d / f"out-{a}x{b}-r{r}.npz"))
                     for r in range(a * b)] for (a, b) in GRIDS}


def _hits(out, tag, fields=HIT_FIELDS):
    return {f: out[f"{tag}.{f}"] for f in fields}


def _assert_hits(got: dict, want, fields):
    for f in fields:
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_mesh_equals_loop(data, grids, shape):
    """Every rank returns the whole batch: the JAX loop engine's hits (all
    9 fields, over the same index) and refine stats, through the step's
    in-graph refine and through refine(qcodes, hits)."""
    _, _, refs = data
    want, wstats = refs[shape[1], "b62"]
    for out in grids[shape]:
        _assert_hits(_hits(out, "b62"), want, HIT_FIELDS)
        np.testing.assert_array_equal(out["b62.search_batch"], want.score)
        for j, k in enumerate(STAT_KEYS):
            np.testing.assert_array_equal(out[f"b62.stat.{k}"], wstats[k], k)
            np.testing.assert_array_equal(out["b62.refine"][j], wstats[k], k)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_mesh_local_blocks(data, grids, shape):
    """search_batch_stats_local: db rank 0 of each data row returns its
    row block (the JAX package's replica 0), the others nothing; the
    blocks tile the batch once."""
    a, b = shape
    outs = grids[shape]
    starts = []
    for r, out in enumerate(outs):
        rows = out["b62.local_rows"].tolist()
        assert rows == ([r // b * 16 // a] if r % b == 0 else []), (r, rows)
        if rows:
            n = out["b62.local.score"].shape[0]
            assert n == 16 // a
            for f in HIT_FIELDS:
                np.testing.assert_array_equal(
                    out[f"b62.local.{f}"],
                    out[f"b62.{f}"][rows[0]:rows[0] + n], f)
            starts.append(rows[0])
    assert sorted(starts) == list(range(0, 16, 16 // a))


def test_grid_collectives_timed(grids):
    """Mesh.time_collectives times each collective under its name: the
    step's select, merge and windows along "db", search_batch_stats's
    rows along "data"; an axis of size 1 runs none."""
    want = {(2, 1): ["rows"], (4, 1): ["rows"],
            (1, 2): ["merge", "select", "windows"],
            (2, 2): ["merge", "rows", "select", "windows"]}
    for shape, outs in grids.items():
        for out in outs:
            assert out["collectives"].tolist() == want[shape], shape


def test_grid_rank_captures_nothing(grids):
    """A grid rank's engine runs its step eager where a CUDA engine of one
    device replays graphs (the graph rule forced on in the ranks): no
    capture, no replay, refine eager in each of its steps."""
    for shape, outs in grids.items():
        for out in outs:
            cap, rep, last, eager = out["b62.graphs"].tolist()
            assert (cap, rep, last) == (0, 0, 0), shape
            assert eager > 0, shape


def test_mesh_matches_different_shardings(grids):
    """(2, 2) over 2 shards == (4, 1) over 1 shard."""
    h1 = _hits(grids[4, 1][0], "b62", HIT_FIELDS[:5])
    for out in grids[2, 2]:
        h2 = _hits(out, "b62", HIT_FIELDS[:5])
        for f in h1:
            np.testing.assert_array_equal(h1[f], h2[f], f)


def test_mesh_blosum50_equals_loop(data, grids):
    """BLOSUM50 13/2 (the score-fed align, B5's plain version) on the
    (1, 2) grid: the JAX loop engine's hits and refine stats (in place of
    the JAX test's fused-kernel interpret case: the port has one align
    route a matrix)."""
    want, wstats = data[2][2, "b50"]
    for out in grids[1, 2]:
        _assert_hits(_hits(out, "b50"), want, HIT_FIELDS)
        for k in STAT_KEYS:
            np.testing.assert_array_equal(out[f"b50.stat.{k}"], wstats[k], k)
    assert not np.array_equal(want.score, data[2][2, "b62"][0].score)


def test_mesh_tail_batch_f6(data, grids):
    """Fault F6: the JAX mesh step on a (2, 2) mesh raises TypeError for 5
    reads (its row block of 15 frames cannot reshape into reads of 6).
    The port's grid pads the batch to a multiple of the data axis with
    inert reads and returns the JAX loop engine's hits for the 5."""
    d, qc, refs = data
    jeng = jengine.SearchEngine(JConfig(**CFG),
                                jdiskio.load_index(str(d / "idx2")),
                                use_pallas=False, mesh=jmake_mesh(2, 2))
    with pytest.raises(TypeError, match="cannot reshape"):
        jeng.search_batch_stats(qc[:5])
    want = refs[2, "b62", "tail5"]
    assert want.score.shape == (5, 5) and want.score.max() > 0
    for out in grids[2, 2]:
        _assert_hits(_hits(out, "b62.tail5"), want, HIT_FIELDS)


def test_grid_ranks_take_one_table_mode(data, grids):
    """Every rank's layout mode is the one decided over all shards."""
    d = data[0]
    for shape, n in GRIDS.items():
        idx = tdiskio.load_index(str(d / f"idx{n}"))
        want = tengine.key_tables_for(TConfig(**CFG), idx,
                                      colocated_shards=False, shards=[])[1]
        assert {str(o["b62.table_mode"]) for o in grids[shape]} == {want}


def test_grid_mode_decided_over_all_shards(data, monkeypatch):
    """A shard that fails the direct check sends every rank to the CSR
    tables, also the rank whose own shard would fit; and a grid's shard
    gets the whole direct-table cap where colocated shards split it (the
    JAX package's colocated_shards)."""
    d = data[0]
    idx = tdiskio.load_index(str(d / "idx2"))
    cfg = TConfig(**CFG)
    direct = tengine.direct_key_tables
    monkeypatch.setattr(
        tengine, "direct_key_tables",
        lambda index, shard, *a, **k: ((None, False) if shard == 1
                                       else direct(index, shard, *a, **k)))
    eng = tengine.SearchEngine(cfg, idx, device="cpu", mesh=Mesh(1, 2))
    assert eng.table_mode == "csr" and len(eng.shard_dev) == 1
    monkeypatch.setattr(tengine, "direct_key_tables", direct)
    maps, mode, w = tengine.key_tables_for(cfg, idx)
    nbytes = maps[0][0].nbytes
    jidx = jdiskio.load_index(str(d / "idx2"))
    for mod in (tengine, jengine):
        monkeypatch.setattr(mod, "DIRECT_TABLE_CAP", nbytes * 3 // 2)
    args = (tengine.diag_bins(cfg, idx), cfg.band_width // 2,
            cfg.query_frame_len)
    e = idx.expand_width     # the JAX package's aligned rows: width 32
    for colocated, want, jwant in ((True, "csr", "aligned"),
                                   (False, "direct", "direct")):
        assert tengine.build_key_tables(idx, *args, e, colocated)[1] == want
        assert jengine.build_key_tables(jidx, *args, 32, e,
                                        colocated)[1] == jwant
    eng = tengine.SearchEngine(cfg, idx, device="cpu", mesh=Mesh(1, 2, 1))
    assert eng.table_mode == "direct"
    np.testing.assert_array_equal(eng.shard_dev[0]["tab_main"].numpy(),
                                  maps[1][0])


@pytest.mark.parametrize("case", ["shards", "batch"])
def test_grid_engine_refusals(data, case):
    """The JAX mesh engine's two refusals, word for word: an index whose
    shard count is not the db axis, a query_batch the data axis does not
    divide."""
    d = data[0]
    kw, shape, n = ((CFG, (2, 1), 2) if case == "shards"
                    else (dict(CFG, query_batch=15), (2, 1), 1))
    with pytest.raises(ValueError) as je:
        jengine.SearchEngine(JConfig(**kw),
                             jdiskio.load_index(str(d / f"idx{n}")),
                             use_pallas=False, mesh=jmake_mesh(*shape))
    with pytest.raises(ValueError) as te:
        tengine.SearchEngine(TConfig(**kw),
                             tdiskio.load_index(str(d / f"idx{n}")),
                             device="cpu", mesh=Mesh(*shape))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("shards", [1, 2])
def test_codes_entry_equals_jax(data, shards):
    """One device's engines: search_batch (all 9 fields), refine (with
    score_check and the -1 coordinates of score-0 hits) and
    search_refine_async on the whole batch and on a 5-read tail batch
    (padded with code-25 frames, the pad rows sliced off): the JAX
    engine's integers."""
    d, qc, _ = data
    jeng = jengine.SearchEngine(JConfig(**CFG),
                                jdiskio.load_index(str(d / f"idx{shards}")),
                                use_pallas=False)
    teng = tengine.SearchEngine(TConfig(**CFG),
                                tdiskio.load_index(str(d / f"idx{shards}")),
                                device="cpu")
    want, got = jeng.search_batch(qc), teng.search_batch(qc)
    _assert_hits(dataclasses.asdict(got), want, HIT_FIELDS)
    ws, gs = jeng.refine(qc, want), teng.refine(qc, got)
    assert sorted(ws) == sorted(gs)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(gs[k], ws[k], k)
    zero = got.score == 0
    assert zero.any() and (gs["qstart"][zero] == -1).all()
    for q in (qc, qc[:5]):
        np.testing.assert_array_equal(
            teng.fetch(teng.search_refine_async(q)),
            np.asarray(jeng.search_refine_async(q)))


def test_codes_entry_refuses_the_wrong_engine(data):
    """search_refine_async and the DNA entry are one device's; the grid
    entries need a grid engine."""
    d, qc, _ = data
    idx = tdiskio.load_index(str(d / "idx1"))
    grid = tengine.SearchEngine(TConfig(**CFG), idx, device="cpu",
                                mesh=Mesh(1, 1))
    with pytest.raises(ValueError, match="one device's engine"):
        grid.search_refine_async(qc)
    with pytest.raises(ValueError, match="one device's engine"):
        grid.search_refine_async_dna(np.zeros((1, 90), np.int8),
                                     np.zeros(1, np.int32))
    loop = tengine.SearchEngine(TConfig(**CFG), idx, device="cpu")
    with pytest.raises(ValueError, match="needs a grid engine"):
        loop.search_batch_stats(qc)
