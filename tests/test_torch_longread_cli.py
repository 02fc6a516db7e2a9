"""Long-read mode end to end through the port on the CPU (the kernels'
plain versions): the committed long-read golden (5 kbp reads, collinear
chaining) byte for byte from an index built by either package; the 900 bp
neighbour-bin smoothing run of tests/test_longread.py through both CLIs,
byte-compared; and an engine whose packed transport cannot hold its value
ranges (the (18, R, K) payload) against the JAX engine. Tolerance 0."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.io.fasta import read_batches
from ghostm_tpu_torch import engine as tengine
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.config import Config as TConfig
from ghostm_tpu_torch.index import diskio as tdiskio
from tools.simulate import make_dataset

# One intra-op thread: the suite runs several pytest workers at once and
# torch's spinning OpenMP threads would oversubscribe the cores.
torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("db_pkg", ["ghostm_tpu_torch", "ghostm_tpu"])
def test_longread_golden_cpu(tmp_path, db_pkg):
    prefix = str(tmp_path / "idx")
    out = str(tmp_path / "hits.tsv")
    cfgf = os.path.join(GOLD, "longread_cfg.json")
    db = tcli if db_pkg == "ghostm_tpu_torch" else jcli
    assert db(["db", "-i", os.path.join(GOLD, "longread_db.fa"), "-o",
               prefix, "--config", cfgf]) == 0
    assert tcli(["aln", "-d", prefix, "-i",
                 os.path.join(GOLD, "longread_reads.fa"), "-o", out,
                 "--device", "cpu", "--config", cfgf,
                 "--max-read-len", "5300"]) == 0
    with open(out) as f, open(os.path.join(GOLD, "longread_hits.tsv")) as g:
        assert f.read() == g.read(), "port's long-read hit table differs"


def test_smooth_bins_900bp_equals_jax_cli(tmp_path):
    """tests/test_longread.py::test_long_reads_end_to_end's dataset and
    config (384-residue frames, band 32, smooth_bins) through both CLIs:
    the same bytes."""
    db_fa, reads_fa = make_dataset(
        str(tmp_path / "lr"), n_proteins=30, n_reads=16, read_len=900,
        sub_rate=0.01, indel_rate=0.02, seed=11, protein_len=(350, 500),
    )
    cfgf = str(tmp_path / "cfg.json")
    with open(cfgf, "w") as f:
        json.dump({"query_frame_len": 384, "band_width": 32,
                   "smooth_bins": True, "query_batch": 16}, f)
    outs = {}
    for name, cli, dev in (("jax", jcli, ["--no-pallas"]),
                           ("torch", tcli, ["--device", "cpu"])):
        prefix = str(tmp_path / f"idx_{name}")
        outs[name] = str(tmp_path / f"hits_{name}.tsv")
        assert cli(["db", "-i", db_fa, "-o", prefix, "--config", cfgf]) == 0
        assert cli(["aln", "-d", prefix, "-i", reads_fa, "-o", outs[name],
                    "--config", cfgf, "--max-read-len", "1200", *dev]) == 0
    with open(outs["jax"]) as f, open(outs["torch"]) as g:
        want, got = f.read(), g.read()
    assert len(want.splitlines()) > 14, "vacuous: the JAX run found no hits"
    assert got == want


def test_unpacked_payload_equals_jax(tmp_path):
    """4096-residue frames (Lq >= 2^12): the packed (6, R, K) transport
    cannot hold the coordinates, so the step returns the full (18, R, K)
    payload; the port's equals the JAX engine's."""
    db_fa, reads_fa = make_dataset(
        str(tmp_path / "lr"), n_proteins=12, n_reads=4, read_len=900,
        sub_rate=0.01, indel_rate=0.02, seed=3, protein_len=(350, 500),
    )
    prefix = str(tmp_path / "idx")
    assert jcli(["db", "-i", db_fa, "-o", prefix]) == 0
    kw = dict(query_frame_len=4096, band_width=16, query_batch=4,
              candidates_per_frame=4, smooth_bins=True)
    _, dna, lens = next(read_batches(reads_fa, 4, 1200))
    jeng = jengine.SearchEngine(JConfig(**kw), jdiskio.load_index(prefix),
                                use_pallas=False)
    want = np.asarray(jeng.search_refine_async_dna(dna, lens))
    teng = tengine.SearchEngine(TConfig(**kw), tdiskio.load_index(prefix),
                                device="cpu")
    assert not teng._pack_ok
    got = teng.fetch(teng.search_refine_async_dna(dna, lens))
    assert got.shape == want.shape == (18, 4, 10)
    assert got[0].max() > 0, "no hits: the comparison is vacuous"
    np.testing.assert_array_equal(got, want)
    hits, stats = teng.unpack_results(got)
    assert set(stats) == set(tengine.SearchEngine.STAT_KEYS) | {"score_check"}
