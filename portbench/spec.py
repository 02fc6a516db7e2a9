"""The benchmark's files, found by the names in BENCHMARK.json.

A cell (`workloads` entry) names a configuration (`configs` entry, whose
`file` holds the database and the search settings) and a traffic mix
(`traffic/<mix>.json`). Every metric, end to end or per layer, has a
reader `metrics/<name>.py` with `read(rec) -> float | None`. A cell may
have `cells/<cell>.json`, the kernels its path has to launch. Adding a
configuration, mix, metric or cell is adding its file and its entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


class Cell:
    def __init__(self, bench_path: Path, name: str):
        self.bench_path = Path(bench_path).resolve()
        self.root = self.bench_path.parent
        self.bench = json.loads(self.bench_path.read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {self.bench_path}; "
                           f"have {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = confs[self.workload["config"]]
        self.config_path = self.root / self.config_entry["file"]
        self.config = json.loads(self.config_path.read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.traffic_name}.json").read_text())
        path = HERE / "cells" / f"{name}.json"
        self.path_check = json.loads(path.read_text()) if path.exists() \
            else {}
        self.cache_dir = HERE / "cache"     # the configuration's index

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def search_config(self) -> dict:
        """The engine's Config fields: the configuration's search
        settings, with the mix's frame length and batch."""
        return dict(self.config["search"],
                    query_frame_len=self.traffic["frame_len"],
                    query_batch=self.traffic["batch"])

    def metrics(self, trace: bool) -> List[dict]:
        """The metric entries this cell reports: its end-to-end ones
        (trace 0) or per-layer ones (trace 1); an entry with `workloads`
        only in those cells."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """metrics/<name>.py's `read`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], rec: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each entry whose reader found
    something to read."""
    out = {}
    for m in entries:
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
