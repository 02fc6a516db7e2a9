"""The port's SearchEngine(device="cpu") against the JAX package's
SearchEngine(use_pallas=False) on the same random index: the packed
(6, R, K) output of search_refine_async_dna must be equal, with the index
loaded through disk and through index_from_arrays, on every align route
(fused B3, score-fed rows B5, score-fed wave B6). Also the device
translation, the score-fed chunking, the CUDA band and gap-cost limits,
the align route's score table built once, negative gap costs on the CPU and
the port's pipeline checkpoint/resume. Tolerance 0."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.io.fasta import read_batches
from ghostm_tpu.ops.translate import six_frame_translate_jnp
from ghostm_tpu_torch import engine as tengine
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.config import Config as TConfig
from ghostm_tpu_torch.index import diskio as tdiskio
from ghostm_tpu_torch.ops.translate import (
    six_frame_translate, six_frame_translate_torch,
)
from tools.simulate import random_proteins, reads_from_proteins, write_fasta

# One intra-op thread: the suite runs several pytest workers at once and
# torch's spinning OpenMP threads would oversubscribe the cores.
torch.set_num_threads(1)

# seed_len 3 everywhere; hits 16 -> 16-wide direct rows, M = 38 * 16 = 608:
# B2's monolithic entry. hits 64 + low-complexity subjects -> 64-wide rows,
# M = 38 * 64: the split sort (B1 twice + B2's merge entry).
CASES = {"monolithic": dict(hits_per_seed=16),
         "split": dict(hits_per_seed=64)}
# BLOSUM50 is outside the fused kernel's nibble range: the score-fed path,
# by rows on int8 tiles (band 32), as a wavefront (72-residue frames), and
# by rows on int32 tiles with the LOW span mask (band 24).
B50 = dict(hits_per_seed=16, matrix="BLOSUM50", gap_open=13, gap_extend=2)
SCORE_FED = {"blosum50": B50,
             "blosum50_wave": dict(B50, query_frame_len=72),
             "blosum50_band24": dict(B50, band_width=24)}
ROUTE = {"monolithic": "fused", "split": "fused", "blosum50": "rows",
         "blosum50_wave": "wave", "blosum50_band24": "rows"}
# Negative gap costs (the JAX package takes them; the CUDA kernels do not),
# on the fused route and on a BLOSUM50 route; explicit Karlin-Altschul
# constants, since the published table has no such combination.
KA = dict(ka_lambda=0.3, ka_k=0.1)
NEG_GAP = {"neg_gap_fused": dict(hits_per_seed=16, gap_open=-1,
                                 gap_extend=2, **KA),
           "neg_gap_blosum50": dict(B50, gap_open=13, gap_extend=-1, **KA)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("eng")
    rng = np.random.default_rng(11)
    prots = random_proteins(rng, 50, 80, 200)
    prots += ["A" * 150, "AAAG" * 40]   # deep k-mer buckets
    write_fasta(str(d / "db.fa"), [f"s{i}" for i in range(len(prots))], prots)
    names, reads = reads_from_proteins(rng, prots, 50, read_len=100)
    write_fasta(str(d / "reads.fa"), names, reads)
    return d


@pytest.fixture(scope="module")
def built(data):
    """Cache of _build_case results, shared by the fixtures below."""
    return {}


def _build_case(data, built, name):
    """(cfg dict, index prefix, JAX index, JAX packed output, dna, lens)."""
    if name not in built:
        kw = dict({**CASES, **SCORE_FED, **NEG_GAP}[name], query_batch=64)
        prefix = str(data / f"idx_{name}")
        assert jcli(["db", "-i", str(data / "db.fa"), "-o", prefix, "-k",
                     "3", "--config", _cfg_file(data, name, kw)]) == 0
        jidx = jdiskio.load_index(prefix)
        cfg = JConfig(**kw)
        _, dna, lens = next(read_batches(str(data / "reads.fa"), 64, 120))
        dna, lens = dna[:50], lens[:50]   # a tail batch: padded to 64 inside
        eng = jengine.SearchEngine(cfg, jidx, use_pallas=False)
        want = np.asarray(eng.search_refine_async_dna(dna, lens))
        built[name] = (kw, prefix, jidx, want, dna, lens)
    return built[name]


@pytest.fixture(scope="module", params=list(CASES))
def case(request, data, built):
    return _build_case(data, built, request.param)


@pytest.fixture(scope="module", params=list(CASES) + list(SCORE_FED))
def any_case(request, data, built):
    return request.param, _build_case(data, built, request.param)


def _cfg_file(d, tag, kw):
    import json

    p = d / f"cfg_{tag}.json"
    p.write_text(json.dumps({"hits_per_seed": kw["hits_per_seed"]}))
    return str(p)


@pytest.mark.parametrize("load", ["disk", "arrays"])
def test_engine_packed_equals_jax(any_case, load):
    name, (kw, prefix, jidx, want, dna, lens) = any_case
    idx = (tdiskio.load_index(prefix) if load == "disk"
           else tdiskio.index_from_arrays(jidx))
    eng = tengine.SearchEngine(TConfig(**kw), idx, device="cpu")
    assert eng.route == ROUTE[name]
    got = tengine.SearchEngine.fetch(eng.search_refine_async_dna(dna, lens))
    assert got.shape == want.shape == (6, 50, 10)
    assert (got[1] >> 15).max() > 0, "no hits: the comparison is vacuous"
    np.testing.assert_array_equal(got, want)


def test_engine_score_fed_chunking(data, built):
    """The score-fed path's output does not depend on its chunk: 24 chunks
    of 128 alignments against the default (one chunk of 3072)."""
    kw, prefix, jidx, want, dna, lens = _build_case(data, built, "blosum50")
    eng = tengine.SearchEngine(TConfig(**kw), tdiskio.index_from_arrays(jidx),
                               device="cpu")
    assert eng.chunk == 64 * 6 * 8
    eng.chunk = 128
    got = tengine.SearchEngine.fetch(eng.search_refine_async_dna(dna, lens))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(), dict(B50), dict(B50, query_frame_len=72),
], ids=["fused", "rows", "wave"])
def test_engine_band_limit_on_cuda(data, built, monkeypatch, kw):
    """A CUDA engine refuses bands above 128 at init, on every route (the
    SW kernels take up to 128); the check needs no card."""
    _, prefix, jidx, *_ = _build_case(data, built, "monolithic")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="wider than"):
        tengine.SearchEngine(TConfig(**kw, band_width=136),
                             tdiskio.index_from_arrays(jidx))


def test_engine_split_path_reaches_merge(case, monkeypatch):
    """The split case must take B2's merge entry and the monolithic case
    its monolithic entry, as the JAX kernels would."""
    from ghostm_tpu_torch.kernels import sort

    kw, prefix, jidx, want, dna, lens = case
    calls = []
    for name in ("merge_vote_rank_rows", "sort_vote_rank_rows"):
        fn = getattr(sort, name)
        monkeypatch.setattr(sort, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append((_n, a[0].shape)), _f(*a, **k))[1])
    eng = tengine.SearchEngine(TConfig(**kw), tdiskio.index_from_arrays(jidx),
                               device="cpu")
    got = tengine.SearchEngine.fetch(eng.search_refine_async_dna(dna, lens))
    np.testing.assert_array_equal(got, want)
    names = {c[0] for c in calls}
    if kw["hits_per_seed"] == 64:
        assert names == {"merge_vote_rank_rows"}
        assert calls[0][1][1] == 2048          # (Q, 32 runs of 64)
    else:
        assert names == {"sort_vote_rank_rows"}
        assert calls[0][1][1] == 38 * 16


def test_engine_requires_cuda_unless_cpu(case, monkeypatch):
    kw, prefix, jidx, *_ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.SearchEngine(TConfig(**kw), tdiskio.index_from_arrays(jidx))


def test_engine_builds_fused_table_once(case, monkeypatch):
    """B3's score table is built at engine init and handed to every fused
    call; the output is unchanged."""
    from ghostm_tpu_torch.kernels import sw_fused

    kw, prefix, jidx, want, dna, lens = case
    tables = []
    fn = sw_fused.sw_fused
    monkeypatch.setattr(sw_fused, "sw_fused", lambda *a, **k: (
        tables.append(k["table"]), fn(*a, **k))[1])
    eng = tengine.SearchEngine(TConfig(**kw), tdiskio.index_from_arrays(jidx),
                               device="cpu")
    assert torch.equal(eng.sw_table,
                       sw_fused.score_table(eng.matrix, eng.code_limit))
    got = tengine.SearchEngine.fetch(eng.search_refine_async_dna(dna, lens))
    np.testing.assert_array_equal(got, want)
    assert tables and all(t is eng.sw_table for t in tables)


@pytest.mark.parametrize("name,entry", [
    ("blosum50", "sw_scored_codes"), ("blosum50_wave", "sw_wave_codes"),
    ("blosum50_band24", "sw_scored_codes"),
])
def test_engine_builds_code_table_once(data, built, monkeypatch, name,
                                       entry):
    """The score-fed route's code table and its largest value are built at
    engine init and handed to every call of its entry (B5 or B6), one
    call per chunk on the CPU; the output is unchanged."""
    from ghostm_tpu_torch.kernels import sw_scored, sw_wave

    kw, prefix, jidx, want, dna, lens = _build_case(data, built, name)
    mod = sw_wave if entry == "sw_wave_codes" else sw_scored
    calls = []
    fn = getattr(mod, entry)
    monkeypatch.setattr(mod, entry, lambda *a, **k: (
        calls.append((a[2], k["table_max"], a[0].shape[0])), fn(*a, **k))[1])
    eng = tengine.SearchEngine(TConfig(**kw), tdiskio.index_from_arrays(jidx),
                               device="cpu")
    band = kw.get("band_width", 32)
    assert torch.equal(eng.sw_table,
                       sw_scored.code_table(eng.matrix, band))
    assert eng.sw_table_max == int(eng.sw_table.max()) == 15
    eng.chunk = 1024
    got = tengine.SearchEngine.fetch(eng.search_refine_async_dna(dna, lens))
    np.testing.assert_array_equal(got, want)
    assert [c[2] for c in calls] == [1024, 1024, 1024]
    assert all(t is eng.sw_table and m == 15 for t, m, _ in calls)


@pytest.mark.parametrize("name", list(NEG_GAP))
def test_engine_negative_gap_costs_equal_jax(data, built, name):
    """The JAX package takes negative gap costs, and so does the port's
    CPU engine: equal packed output, on the fused route and on a BLOSUM50
    route."""
    kw, prefix, jidx, want, dna, lens = _build_case(data, built, name)
    eng = tengine.SearchEngine(TConfig(**kw), tdiskio.load_index(prefix),
                               device="cpu")
    assert eng.route == ("fused" if name == "neg_gap_fused" else "rows")
    got = tengine.SearchEngine.fetch(eng.search_refine_async_dna(dna, lens))
    assert (got[1] >> 15).max() > 0, "no hits: the comparison is vacuous"
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gap_open,gap_extend", [(-1, 1), (11, -1)])
def test_engine_refuses_negative_gap_costs_on_cuda(data, built, monkeypatch,
                                                   gap_open, gap_extend):
    """A CUDA engine refuses negative gap costs at init (the SW kernels
    hold diagonals past the band at a large negative value, which a
    negative cost could lift); the check needs no card."""
    _, prefix, jidx, *_ = _build_case(data, built, "monolithic")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="gap costs >= 0"):
        tengine.SearchEngine(TConfig(gap_open=gap_open, gap_extend=gap_extend,
                                     hits_per_seed=16, **KA),
                             tdiskio.index_from_arrays(jidx))


def test_translate_torch_matches_jax_and_host(rng):
    for L in (100, 31, 3):
        dna = rng.integers(0, 5, (40, L)).astype(np.int8)
        lens = rng.integers(0, L + 1, 40).astype(np.int32)
        got = six_frame_translate_torch(torch.from_numpy(dna),
                                        torch.from_numpy(lens), 40).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(six_frame_translate_jnp(jnp.asarray(dna),
                                                    jnp.asarray(lens), 40)))
        np.testing.assert_array_equal(got, six_frame_translate(dna, lens, 40))


def test_pipeline_checkpoint_resume(data, tmp_path):
    """Port pipeline: checkpointed parts + --resume after a lost part give
    the same bytes as one straight run (three batches of 20 reads)."""
    prefix = str(tmp_path / "idx")
    assert tcli(["db", "-i", str(data / "db.fa"), "-o", prefix]) == 0
    base = ["aln", "-d", prefix, "-i", str(data / "reads.fa"), "--device",
            "cpu", "--batch", "20"]
    plain, ck = str(tmp_path / "plain.tsv"), str(tmp_path / "ck.tsv")
    assert tcli(base + ["-o", plain]) == 0
    assert tcli(base + ["-o", ck, "--checkpoint-batches", "1"]) == 0
    parts = ck + ".parts"
    os.remove(os.path.join(parts, "part-000002.tsv"))
    with open(os.path.join(parts, "cursor.json"), "w") as f:
        f.write('{"completed_batches": 2}')
    os.remove(ck)
    assert tcli(base + ["-o", ck, "--checkpoint-batches", "1",
                        "--resume"]) == 0
    with open(plain) as a, open(ck) as b:
        want, got = a.read(), b.read()
    assert got == want and len(want.splitlines()) > 10
