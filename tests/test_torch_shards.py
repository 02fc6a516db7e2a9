"""Indexes of more than one shard on one device, against the JAX package:
the colocated merge (GHOSTM_TPU_MERGE_COLOCATED=1, the default) and the
true per-shard loop (=0) give the JAX engine's (18, R, K) payload on all
rows, at 2 and 3 shards and with CSR tables in the loop; select_global's
multi-shard merge with vote ties; and shard invariance through the port's
CLI (1, 2 and 3 shards write the config-1 golden). Tolerance 0."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.io.fasta import read_batches
from ghostm_tpu.kernels import candidates as jcand
from ghostm_tpu_torch import engine as tengine
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.config import Config as TConfig
from ghostm_tpu_torch.index import diskio as tdiskio
from ghostm_tpu_torch.kernels import candidates as tcand
from tools.simulate import random_proteins, reads_from_proteins, write_fasta

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
BIG = 1 << 30


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A random database (deep buckets included), its reads, and its index
    at 1, 2 and 3 shards (`db` of the JAX package, hits_per_seed 16)."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(5)
    prots = random_proteins(rng, 45, 60, 220)
    prots += ["A" * 150, "AAAG" * 40]
    write_fasta(str(d / "db.fa"), [f"s{i}" for i in range(len(prots))], prots)
    names, reads = reads_from_proteins(rng, prots, 48, read_len=100)
    write_fasta(str(d / "reads.fa"), names, reads)
    for s in (1, 2, 3):
        assert jcli(["db", "-i", str(d / "db.fa"), "-o", str(d / f"idx{s}"),
                     "-k", "3", "--shards", str(s)]) == 0
    _, dna, lens = next(read_batches(str(d / "reads.fa"), 64, 120))
    return d, dna[:48], lens[:48]


def _jax_payload(prefix, dna, lens):
    eng = jengine.SearchEngine(JConfig(query_batch=48),
                               jdiskio.load_index(prefix), use_pallas=False)
    return eng, np.asarray(eng.search_refine_async(eng.translate(dna, lens)))


def _port_payload(prefix, dna, lens):
    eng = tengine.SearchEngine(TConfig(query_batch=48),
                               tdiskio.load_index(prefix), device="cpu")
    return eng, eng.step_dna(torch.from_numpy(dna), torch.from_numpy(lens),
                             pack=False).numpy()


@pytest.mark.parametrize("shards,merge,tables", [
    (2, "1", "direct"), (2, "0", "direct"), (3, "1", "direct"),
    (3, "0", "direct"), (2, "0", "csr"), (3, "0", "aligned"),
])
def test_colocated_merge_and_loop_equal_jax(data, monkeypatch, shards, merge,
                                            tables):
    """Port of tests/test_index.py::test_colocated_merge_engine_paths: the
    merged engine and the true loop each equal the JAX engine on all 18
    rows; the loop equals the 1-shard engine on rows 0-5 and 9-17 (rows
    6-8 are shard-local bookkeeping), the merged engine on all of them.
    Where the JAX engine takes its aligned tables the port takes CSR."""
    d, dna, lens = data
    monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", merge)
    for mod in (jengine, tengine):
        if tables == "csr":
            monkeypatch.setattr(mod, "_packed_value_bound",
                                lambda *a: 1 << 40)
        elif tables == "aligned":
            monkeypatch.setattr(mod, "DIRECT_TABLE_CAP", 1024)
    jeng, want = _jax_payload(str(d / f"idx{shards}"), dna, lens)
    teng, got = _port_payload(str(d / f"idx{shards}"), dna, lens)
    assert teng.merged_colocated == jeng.merged_colocated == (merge == "1")
    assert teng.n_shards == jeng.n_shards == (1 if merge == "1" else shards)
    assert jeng.table_mode == tables
    assert teng.table_mode == ("csr" if tables == "aligned" else tables)
    assert got.shape == want.shape == (18, 48, 10)
    assert got[0].max() > 0, "no hits: the comparison is vacuous"
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", "1")
    _, one = _port_payload(str(d / "idx1"), dna, lens)
    rows = list(range(18)) if merge == "1" else [*range(6), *range(9, 18)]
    np.testing.assert_array_equal(got[rows], one[rows])
    if merge == "0":
        assert set(np.unique(got[8])) == set(range(shards))


def _proposals(rng, shards, q, ncand):
    """Each shard's proposals as vote_and_rank emits them: disjoint subject
    ids a shard (shard s holds ids = s mod shards), rows ordered by (votes
    desc, gsid asc, bin asc), votes 0-3, half of them 0 (ties across
    shards; BIG-masked at 0; frames with fewer than ncand live)."""
    gs, bs, vs = [], [], []
    for s in range(shards):
        v = rng.choice([0, 0, 0, 1, 2, 3], (q, ncand))
        g = rng.integers(0, 12, (q, ncand)) * shards + s
        b = rng.integers(0, 5, (q, ncand))
        g = np.where(v > 0, g, BIG)
        b = np.where(v > 0, b, BIG)
        order = np.lexsort((b, g, -v), axis=1)
        take = lambda x: np.take_along_axis(x, order, 1).astype(np.int32)
        gs.append(take(g))
        bs.append(take(b))
        vs.append(take(v))
    return (np.concatenate(x, axis=1) for x in (gs, bs, vs))


@pytest.mark.parametrize("shards", [2, 3])
def test_select_global_equals_jax(shards):
    rng = np.random.default_rng(shards)
    g, b, v = _proposals(rng, shards, 200, 8)
    got = tcand.select_global(torch.from_numpy(g), torch.from_numpy(b),
                              torch.from_numpy(v), 8)
    want = jcand.select_global(jnp.asarray(g), jnp.asarray(b),
                               jnp.asarray(v), 8)
    for t, j in zip(got, want):
        assert t.shape == (200, 8)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # ties: some frame's winners share a vote count across shards
    sv = got[2].numpy()
    assert (sv[:, :-1] == sv[:, 1:]).any() and (sv == 0).any()


@pytest.mark.parametrize("shards,merge", [(1, "1"), (2, "1"), (3, "1"),
                                          (2, "0"), (3, "0")])
def test_shard_invariance_cli(tmp_path, monkeypatch, shards, merge):
    """Port of tests/test_pipeline.py::test_shard_invariance: `db --shards
    N` and `aln` through the port's CLI write the config-1 golden byte for
    byte, merged at init and through the per-shard loop."""
    monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", merge)
    prefix = str(tmp_path / "idx")
    out = str(tmp_path / "hits.tsv")
    assert tcli(["db", "-i", os.path.join(GOLD, "config1_db.fa"), "-o",
                 prefix, "--shards", str(shards)]) == 0
    assert tcli(["aln", "-d", prefix, "-i",
                 os.path.join(GOLD, "config1_reads.fa"), "-o", out,
                 "--device", "cpu", "--batch", "128"]) == 0
    with open(out) as f, open(os.path.join(GOLD, "config1_hits.tsv")) as g:
        assert f.read() == g.read(), f"{shards} shards changed the table"


@pytest.mark.parametrize("nbins,refused", [((1 << 29) + 1, True),
                                           (1 << 29, False)])
def test_vote_keys_past_big_refused(nbins, refused):
    """Two subjects, four hits on subject 1 in its last bin but one. Where
    row * nbins + bin reaches BIG = 2^30 (the invalid key), the JAX
    package's vote drops them (its guard is 2^31), and the port refuses;
    one bin fewer a row and both vote the hits."""
    keys = np.full((1, 128), BIG, np.int32)
    keys[0, :4] = nbins + nbins - 2
    sid = np.arange(2, dtype=np.int32)
    _, _, jv = jcand.vote_and_rank(jnp.asarray(keys), jnp.asarray(sid), 4, 1,
                                   False, nbins)
    assert int(np.asarray(jv).max()) == (0 if refused else 4)
    args = (torch.from_numpy(keys), torch.from_numpy(sid), 4, 1)
    if refused:
        with pytest.raises(ValueError, match="reach BIG"):
            tcand.vote_and_rank(*args, nbins=nbins)
    else:
        got = tcand.vote_and_rank(*args, nbins=nbins)
        assert int(got[2].max()) == 4 and int(got[0][0, 0]) == 1


def test_engine_refuses_vote_keys_past_big(tmp_path):
    """17,500 proteins of 30 aa and one of 1,000,000: 17,501 rows x 62,504
    bins pass BIG, so one shard is refused at init (use more shards); at 3
    shards (the long protein alone, 8,750 short ones in each of the others)
    the engine builds, on CSR tables."""
    rng = np.random.default_rng(3)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    prots = [p.decode() for p in
             aas[rng.integers(0, 20, (17_500, 30))].view("S30").ravel()]
    prots.append(aas[rng.integers(0, 20, 1_000_000)].tobytes().decode())
    write_fasta(str(tmp_path / "db.fa"), [f"s{i}" for i in range(len(prots))],
                prots)
    for shards in (1, 3):
        prefix = str(tmp_path / f"idx{shards}")
        assert tcli(["db", "-i", str(tmp_path / "db.fa"), "-o", prefix,
                     "--shards", str(shards)]) == 0
        idx = tdiskio.load_index(prefix)
        if shards == 1:
            with pytest.raises(ValueError, match="use more shards"):
                tengine.SearchEngine(TConfig(), idx, device="cpu")
        else:
            eng = tengine.SearchEngine(TConfig(), idx, device="cpu")
            assert (eng.n_shards, eng.table_mode) == (3, "csr")
