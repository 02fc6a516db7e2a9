"""The port's SearchEngine(device="cpu") against the JAX package's
SearchEngine(use_pallas=False) on the same random index: the packed
(6, R, K) output of search_refine_async_dna must be equal, with the index
loaded through disk and through index_from_arrays. Also the device
translation and the port's pipeline checkpoint/resume. Tolerance 0."""

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


@pytest.fixture(scope="module", params=list(CASES))
def case(request, data):
    """(cfg dict, index prefix, JAX packed output, dna, lens)."""
    kw = dict(CASES[request.param], query_batch=64)
    prefix = str(data / f"idx_{request.param}")
    assert jcli(["db", "-i", str(data / "db.fa"), "-o", prefix, "-k", "3",
                 "--config", _cfg_file(data, request.param, kw)]) == 0
    jidx = jdiskio.load_index(prefix)
    cfg = JConfig(**kw)
    _, dna, lens = next(read_batches(str(data / "reads.fa"), 64, 120))
    dna, lens = dna[:50], lens[:50]   # a tail batch: padded to 64 inside
    eng = jengine.SearchEngine(cfg, jidx, use_pallas=False)
    want = np.asarray(eng.search_refine_async_dna(dna, lens))
    return kw, prefix, jidx, want, dna, lens


def _cfg_file(d, tag, kw):
    import json

    p = d / f"cfg_{tag}.json"
    p.write_text(json.dumps({"hits_per_seed": kw["hits_per_seed"]}))
    return str(p)


@pytest.mark.parametrize("load", ["disk", "arrays"])
def test_engine_packed_equals_jax(case, load):
    kw, prefix, jidx, want, dna, lens = case
    idx = (tdiskio.load_index(prefix) if load == "disk"
           else tdiskio.index_from_arrays(jidx))
    eng = tengine.SearchEngine(TConfig(**kw), idx, device="cpu")
    got = tengine.SearchEngine.fetch(eng.search_refine_async_dna(dna, lens))
    assert got.shape == want.shape == (6, 50, 10)
    assert (got[1] >> 15).max() > 0, "no hits: the comparison is vacuous"
    np.testing.assert_array_equal(got, want)


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
