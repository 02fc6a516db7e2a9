"""The port's seed-key tables against the JAX package's: the CSR tables
(seed_key_tables), the layout fallback of build_key_tables (mode, width
and every array), propose_shard's CSR branch on the same frames, and the
engine's packed (18, R, K) output with CSR tables. Tables are forced the
way the JAX package's tests force them, in both engine modules:
DIRECT_TABLE_CAP lowered, where the JAX package takes its bucket-aligned
tables and the port its CSR tables (the same keys, value for value, but
for the JAX package's fault F8), and _packed_value_bound raised (CSR in
both); and, unforced, a database with one 35,213-aa subject takes the CSR
tables (and, at 2 shards, the per-shard loop) through both CLIs.
Tolerance 0."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.io.fasta import read_batches
from ghostm_tpu.ops.translate import six_frame_translate
from ghostm_tpu_torch import engine as tengine
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.config import Config as TConfig
from ghostm_tpu_torch.index import diskio as tdiskio
from tools.simulate import random_proteins, reads_from_proteins, write_fasta

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# hits 16: expansion 16, a power of two (the JAX package's aligned rows
# keep the presorted run); hits 12: expansion 12, no run; hits 64: two
# 32-wide aligned rows a k-mer in the JAX package, and at one shard a
# 64-deep bucket (its fault F8)
HITS = (16, 12, 64)
# the JAX package's aligned row width: the narrowest its engine steps
# down to, so that hits 64 reads two rows a k-mer
JAX_WIDTH = 32


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tables")
    rng = np.random.default_rng(21)
    prots = random_proteins(rng, 40, 60, 220)
    prots += ["A" * 150, "AAAG" * 40]   # deep k-mer buckets
    write_fasta(str(d / "db.fa"), [f"s{i}" for i in range(len(prots))], prots)
    names, reads = reads_from_proteins(rng, prots, 40, read_len=100)
    write_fasta(str(d / "reads.fa"), names, reads)
    return d


@pytest.fixture(scope="module")
def indexes(data):
    """(hits, shards) -> (prefix, JAX index, port index), built once."""
    import json

    out = {}
    for hits in HITS:
        cfgf = data / f"cfg{hits}.json"
        cfgf.write_text(json.dumps({"hits_per_seed": hits}))
        for shards in (1, 2):
            prefix = str(data / f"idx{hits}_{shards}")
            assert jcli(["db", "-i", str(data / "db.fa"), "-o", prefix, "-k",
                         "3", "--shards", str(shards), "--config",
                         str(cfgf)]) == 0
            out[hits, shards] = (prefix, jdiskio.load_index(prefix),
                                 tdiskio.load_index(prefix))
    return out


def _force(monkeypatch, mode):
    """Force `mode` on the JAX engine module ("aligned": a 1 KB
    direct-table cap, where the port's takes "csr"; "csr": a packed-value
    bound past int32), patching both modules alike."""
    for mod in (jengine, tengine):
        if mode == "aligned":
            monkeypatch.setattr(mod, "DIRECT_TABLE_CAP", 1024)
        elif mode == "csr":
            monkeypatch.setattr(mod, "_packed_value_bound",
                                lambda *a: 1 << 40)


def _geometry(idx, cfg):
    half = cfg.band_width // 2
    nbins = int(idx.lengths.max() + cfg.query_frame_len) // half + 2
    return nbins, half, cfg.query_frame_len


@pytest.mark.parametrize("hits", HITS)
@pytest.mark.parametrize("shards", [1, 2])
def test_csr_tables_equal_jax(indexes, hits, shards):
    _, jidx, tidx = indexes[hits, shards]
    nbins, _, _ = _geometry(tidx, TConfig())
    for i in range(shards):
        for t, j in zip(tengine.seed_key_tables(tidx, i, nbins),
                        jengine.seed_key_tables(jidx, i, nbins)):
            assert t.dtype == j.dtype == np.int32
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mode", ["direct", "aligned", "csr"])
@pytest.mark.parametrize("shards", [1, 2])
def test_build_key_tables_equal_jax(indexes, monkeypatch, mode, shards):
    """Mode, width and every shard's arrays, as build_key_tables returns
    them in each layout. Where the JAX package takes its aligned tables
    the port takes the CSR tables, equal to the JAX package's; a CSR
    table's width is the expansion."""
    _, jidx, tidx = indexes[16, shards]
    _force(monkeypatch, mode)
    nbins, half, Lq = _geometry(tidx, TConfig())
    expand = tidx.expand_width
    tmaps, tmode, tw = tengine.build_key_tables(tidx, nbins, half, Lq,
                                                expand)
    jmaps, jmode, jw = jengine.build_key_tables(jidx, nbins, half, Lq,
                                                JAX_WIDTH, expand)
    assert jmode == mode
    if mode == "aligned":
        jmaps = [jengine.seed_key_tables(jidx, i, nbins)
                 for i in range(shards)]
    assert tmode == ("direct" if mode == "direct" else "csr")
    assert tw == (jw if mode == "direct" else expand)
    assert len(tmaps) == len(jmaps) == shards
    for tm, jm in zip(tmaps, jmaps):
        for t, j in zip(tm, jm):
            np.testing.assert_array_equal(t, j)


def test_merge_fits_direct_equals_jax(indexes, monkeypatch):
    for shards in (1, 2):
        _, jidx, tidx = indexes[64, shards]
        for cap in (3 << 30, 1 << 20, 1024):
            for mod in (jengine, tengine):
                monkeypatch.setattr(mod, "DIRECT_TABLE_CAP", cap)
            for band in (32, 16):
                want = jengine._merge_fits_direct(jidx,
                                                  JConfig(band_width=band))
                assert tengine._merge_fits_direct(
                    tidx, TConfig(band_width=band)) == want


def _frames(data, n=24):
    _, dna, lens = next(read_batches(str(data / "reads.fa"), 64, 120))
    q = six_frame_translate(dna[:n], lens[:n], 40)
    return q.reshape(-1, 40)


@pytest.mark.parametrize("mode", ["aligned", "csr"])
@pytest.mark.parametrize("hits", HITS)
def test_propose_shard_branches_equal_jax(data, indexes, monkeypatch, mode,
                                          hits):
    """propose_shard's CSR branch (no presorted run, as the port's engine
    sets it) against the JAX propose_shard on the XLA path, shard by shard
    of a 2-shard index: on the JAX package's aligned tables (its presorted
    run where the expansion is a power of two) or on its CSR tables."""
    _, jidx, tidx = indexes[hits, 2]
    _force(monkeypatch, mode)
    cfg = TConfig(hits_per_seed=hits)
    nbins, half, Lq = _geometry(tidx, cfg)
    expand = tidx.expand_width
    maps, got_mode, tw = tengine.build_key_tables(tidx, nbins, half, Lq,
                                                  expand)
    assert (got_mode, tw) == ("csr", expand)
    jmaps, jmode, jw = jengine.build_key_tables(jidx, nbins, half, Lq,
                                                JAX_WIDTH, expand)
    assert jmode == mode
    if mode == "aligned" and hits == 64:
        assert expand > jw, "want more than one aligned row a k-mer"
    run = expand if (mode == "aligned" and expand >= 8
                     and expand & (expand - 1) == 0) else 0
    q = _frames(data)
    kw = dict(seed_len=3, expand=expand, band=32, ncand=8, min_votes=1,
              nbins=nbins)
    for i, ((tab_main, tab_aux), (jmain, jaux)) in enumerate(zip(maps,
                                                                jmaps)):
        got = tengine.propose_shard(
            torch.from_numpy(q), torch.from_numpy(tidx.bucket_starts[i]),
            torch.from_numpy(tab_main), torch.from_numpy(tab_aux),
            torch.from_numpy(tidx.subject_ids[i]), mode="csr",
            table_width=tw, **kw)
        want = jengine.propose_shard(
            jnp.asarray(q), jnp.asarray(jidx.bucket_starts[i]),
            jnp.asarray(jmain), jnp.asarray(jaux),
            jnp.asarray(jidx.subject_ids[i]), table_width=jw,
            presorted_run=run, fuse_tables=mode == "aligned", **kw)
        assert int(want[2].max()) > 0, "no votes: the comparison is vacuous"
        for t, j in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("mode", ["aligned", "csr"])
@pytest.mark.parametrize("hits", HITS)
def test_engine_tables_equal_jax(data, indexes, monkeypatch, mode, hits):
    """The whole step on the port's CSR tables: its (18, R, K) payload
    equals the JAX engine's on the JAX package's aligned or CSR tables.
    Fault F8 of the JAX package: its aligned row/count word keeps a
    bucket's count in bit_length(width) bits, so a bucket of
    2^bit_length(width) positions or more (hits 64's 64-deep bucket at
    width 32) reads a wrong row and count. There the JAX engine's aligned
    payload differs, and the port equals the JAX engine on CSR tables."""
    _, jidx, tidx = indexes[hits, 1]
    _force(monkeypatch, mode)
    _, dna, lens = next(read_batches(str(data / "reads.fa"), 64, 120))
    dna, lens = dna[:40], lens[:40]
    jcfg = JConfig(hits_per_seed=hits, query_batch=40)
    jeng = jengine.SearchEngine(jcfg, jidx, use_pallas=False)
    assert jeng.table_mode == mode
    want = np.asarray(jeng.search_refine_async(jeng.translate(dna, lens)))
    teng = tengine.SearchEngine(TConfig(hits_per_seed=hits, query_batch=40),
                                tidx, device="cpu")
    assert (teng.table_mode, teng.presorted_run) == ("csr", 0)
    got = teng.step_dna(torch.from_numpy(dna), torch.from_numpy(lens),
                        pack=False).numpy()
    assert got.shape == want.shape == (18, 40, 10)
    assert got[0].max() > 0, "no hits: the comparison is vacuous"
    deepest = int(np.diff(jidx.bucket_starts[0].astype(np.int64)).max())
    f8 = (mode == "aligned"
          and deepest >= 1 << int(jeng._table_width).bit_length())
    assert f8 == (mode == "aligned" and hits == 64)
    if f8:
        assert not np.array_equal(got, want)
        monkeypatch.setattr(jengine, "_packed_value_bound",
                            lambda *a: 1 << 40)
        jeng = jengine.SearchEngine(jcfg, jidx, use_pallas=False)
        assert jeng.table_mode == "csr"
        want = np.asarray(jeng.search_refine_async(jeng.translate(dna,
                                                                  lens)))
    np.testing.assert_array_equal(got, want)


def test_direct_table_cap_fallback(tmp_path, monkeypatch):
    """Port of tests/test_index.py::test_direct_table_cap_fallback through
    the port's CLI: with the direct-table cap at 1 KB the engine takes the
    CSR tables and writes the config-1 golden byte for byte."""
    prefix = str(tmp_path / "idx")
    assert tcli(["db", "-i", os.path.join(GOLD, "config1_db.fa"), "-o",
                 prefix]) == 0
    monkeypatch.setattr(tengine, "DIRECT_TABLE_CAP", 1024)
    eng = tengine.SearchEngine(TConfig(query_batch=128),
                               tdiskio.load_index(prefix), device="cpu")
    assert eng.table_mode == "csr"
    out = str(tmp_path / "hits.tsv")
    assert tcli(["aln", "-d", prefix, "-i",
                 os.path.join(GOLD, "config1_reads.fa"), "-o", out,
                 "--device", "cpu", "--batch", "128"]) == 0
    with open(out) as f, open(os.path.join(GOLD, "config1_hits.tsv")) as g:
        assert f.read() == g.read()


def test_direct_table_cap_env():
    """GHOSTM_TPU_DIRECT_TABLE_CAP sets DIRECT_TABLE_CAP when the engine
    module is imported, as in the JAX package."""
    env = dict(os.environ, GHOSTM_TPU_DIRECT_TABLE_CAP="1024")
    out = subprocess.run(
        [sys.executable, "-c", "import ghostm_tpu_torch.engine as e; "
         "print(e.DIRECT_TABLE_CAP)"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["1024"]
    assert tengine.DIRECT_TABLE_CAP == jengine.DIRECT_TABLE_CAP


@pytest.fixture(scope="module")
def long_tail(tmp_path_factory):
    """62,000 proteins of 30 aa and one of 35,213 (Swiss-Prot's longest):
    62,001 rows x (35,213 + Lq + band) packs past int32, so one shard takes
    the CSR tables without forcing, and a 2-shard index fails the merge
    check (each shard alone still takes the direct table). Reads from the
    long protein and from short ones."""
    d = tmp_path_factory.mktemp("tail")
    rng = np.random.default_rng(35213)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    short = aas[rng.integers(0, 20, (62_000, 30))].view("S30").ravel()
    prots = [p.decode() for p in short] + [
        aas[rng.integers(0, 20, 35_213)].tobytes().decode()]
    write_fasta(str(d / "db.fa"), [f"s{i}" for i in range(len(prots))], prots)
    names, reads = reads_from_proteins(rng, prots[-1:] * 30 + prots[:10], 40,
                                       read_len=100)
    write_fasta(str(d / "reads.fa"), names, reads)
    return d


@pytest.mark.parametrize("shards", [1, 2])
def test_long_subject_tables_cli(long_tail, tmp_path, shards):
    """The port's CLI on an index with a realistic length tail writes the
    JAX package's table byte for byte: CSR tables at 1 shard; at 2 shards
    the per-shard loop (the merged packing would overflow)."""
    d = long_tail
    prefix = str(tmp_path / "idx")
    assert tcli(["db", "-i", str(d / "db.fa"), "-o", prefix, "--shards",
                 str(shards)]) == 0
    cfg = TConfig(query_batch=40)
    teng = tengine.SearchEngine(cfg, tdiskio.load_index(prefix), device="cpu")
    jeng = jengine.SearchEngine(JConfig(query_batch=40),
                                jdiskio.load_index(prefix), use_pallas=False)
    want_mode = "csr" if shards == 1 else "direct"
    assert teng.table_mode == jeng.table_mode == want_mode
    assert teng.n_shards == jeng.n_shards == shards
    outs = []
    for cli in (tcli, jcli):
        out = str(tmp_path / f"{cli.__module__}.tsv")
        assert cli(["aln", "-d", prefix, "-i", str(d / "reads.fa"), "-o",
                    out, "--batch", "40", "--no-pallas"]
                   + (["--device", "cpu"] if cli is tcli else [])) == 0
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    assert "\ts62000\t" in outs[0], "no hit on the long subject"
