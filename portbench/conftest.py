"""Fixtures of the benchmark's tests: a tiny benchmark (its own
BENCHMARK.json, a configuration cut to a few thousand proteins, the
real mix cut to small batches) in a temporary directory, with its own
index cache; and `cuda`, which skips a test of the card without one."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import spec

HERE = Path(__file__).resolve().parent
TINY = {"swissprot_k5": dict(groups=[3000], size_max=40,
                             traffic="reads100", batch=64, pool_batches=3,
                             check_reads=192),
        # each length range cut to ~1/250 (at least one protein), the
        # 35,213-aa titin kept: ~2,300 proteins, ~0.9 M residues
        "swissprot_full": dict(groups=[68, 192, 256, 244, 228, 220, 200,
                                       184, 144, 120, 84, 64, 46, 36, 28,
                                       23, 19, 16, 13, 11, 48, 18, 11, 4,
                                       1, 1, 1], size_max=40,
                               traffic="reads100", batch=64,
                               pool_batches=3, check_reads=192)}


def tiny_bench(d: Path, which: str, search: dict | None = None,
               tag: str = "") -> spec.Cell:
    """A one-cell benchmark in d on a cut copy of configuration `which`,
    its search settings updated by `search` (the copy named with `tag`)."""
    t = TINY[which]
    c = json.loads((HERE / "configs" / f"{which}.json").read_text())
    assert len(t["groups"]) == len(c["database"]["groups"])
    c["name"] = "tiny_" + which + tag
    c["search"].update(search or {})
    for g, n in zip(c["database"]["groups"], t["groups"]):
        g["n"] = n
        if "families" in g:          # families in scale with the cut
            g["families"]["size_max"] = t["size_max"]
    (d / "configs").mkdir(exist_ok=True)
    (d / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench = dict(real, configs=[dict(name=c["name"], source="-",
                                     file=f"configs/{c['name']}.json",
                                     reduced=[], why="-")],
                 workloads=[dict(name="tiny", config=c["name"],
                                 traffic=t["traffic"], chips=1, why="-")])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:     # the cut cell stands for the real one
            m["workloads"] = ["tiny"]
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell(d / "BENCHMARK.json", "tiny")
    cell.cache_dir = d / "cache"
    cell.traffic.update(batch=t["batch"], pool_batches=t["pool_batches"],
                        check_reads=t["check_reads"])
    return cell


@pytest.fixture(scope="session")
def tiny_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("portbench")


@pytest.fixture
def short_cell(tiny_dir):
    return tiny_bench(tiny_dir, "swissprot_k5")


@pytest.fixture
def full_cell(tiny_dir):
    """The tiny cut of swissprot_full: two index shards and the titin."""
    return tiny_bench(tiny_dir, "swissprot_full")


@pytest.fixture
def full_loop_cell(full_cell, monkeypatch):
    """The tiny swissprot_full on the real cell's path: the per-shard loop
    on CSR seed tables. The tiny index would take direct tables and be
    merged into one shard at init, so the loop is kept and CSR tables
    forced, as the port's own shard tests force them."""
    from ghostm_tpu_torch import engine

    monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", "0")
    monkeypatch.setattr(engine, "_packed_value_bound", lambda *a: 1 << 40)
    return full_cell


@pytest.fixture
def chain_cell(tiny_dir):
    """The tiny cell under long-read mode's search (k = 4, a 16-seed cap,
    the chained vote, band 64, 4 candidates a frame): the reference's
    chaining against the port's."""
    return tiny_bench(tiny_dir, "swissprot_k5", tag="_chain", search=dict(
        seed_len=4, hits_per_seed=16, chain_gamma=2, band_width=64,
        candidates_per_frame=4))


@pytest.fixture
def genome_cell(chain_cell):
    """The chained tiny cell on long-read traffic cut short: reads of
    300-600 bp over several genes on both strands, with errors (ten times
    the HiFi rates, so most reads carry one), frames of 200."""
    chain_cell.traffic.update(
        reads="genomes", frame_len=200, max_read_len=600, read_len_min=300,
        read_len_max=600, len_median=450, len_sigma=0.3, spacer_min=50,
        spacer_max=200, sub_rate=0.01, ins_rate=0.005, del_rate=0.005)
    return chain_cell


@pytest.fixture
def cuda():
    """Skips a test of the card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's cells run only "
                    "on the card)")
