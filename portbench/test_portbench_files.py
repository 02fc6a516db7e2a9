"""The benchmark's files: every configuration, mix, reader and cell of
BENCHMARK.json is found by its name and loads, and BENCHMARK.json keeps
to its format's limits."""

import json
import re
from pathlib import Path

import pytest

from portbench import spec

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.Cell(HERE.parent / "BENCHMARK.json", cell)
    cfg = c.search_config()
    assert cfg["query_batch"] == c.traffic["batch"]
    assert c.config["name"] == c.workload["config"]
    for key in ("kernels", "absent", "once_a_batch"):
        assert isinstance(c.path_check.get(key), list)
    assert c.metrics(False) and c.metrics(True)


@pytest.mark.parametrize("m", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(m):
    assert callable(spec.reader(m))
    assert spec.reader(m)({}) is None      # nothing to read: nothing


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"]: m.get("workloads", CELLS) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        # each cell that reads it reports the metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]])
    for w in CELLS:
        reported = [n for n, cells in e2e.items() if w in cells]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert (HERE.parent / c["file"]).exists()
        assert set(c["reduced"]) <= set(json.loads(
            (HERE.parent / c["file"]).read_text()))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("path", sorted((HERE / "traffic").glob("*.json"))
                         + sorted((HERE / "configs").glob("*.json"))
                         + sorted((HERE / "cells").glob("*.json")),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_data_file_loads(path):
    assert isinstance(json.loads(path.read_text()), dict)


def test_path_check_names_known_kernels():
    from ghostm_tpu_torch.kernels import _build

    for p in (HERE / "cells").glob("*.json"):
        d = json.loads(p.read_text())
        for k in d["kernels"] + d["absent"] + d["once_a_batch"]:
            assert k in _build.LAUNCHES, (p.name, k)


def test_path_check_faults():
    from portbench import run

    cell = spec.Cell(HERE.parent / "BENCHMARK.json", "swissprot_k5.reads100")
    ok = dict.fromkeys(cell.path_check["kernels"], 3)
    assert run.path_check(cell, ok, 3) == []
    assert run.path_check(cell, dict(ok, refine=2), 3)
    assert run.path_check(cell, dict(ok, sort_rows=0), 3)
    assert run.path_check(cell, dict(ok, sort_vote_rank_rows=1), 3)
