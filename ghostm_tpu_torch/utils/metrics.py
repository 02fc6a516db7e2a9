"""Per-batch metrics records (SURVEY.md §5.5): the measurement source for
BASELINE.md. Cell counts are analytic: alignments x Lq x band."""

from __future__ import annotations

import dataclasses
import json
from typing import List


@dataclasses.dataclass
class BatchMetrics:
    reads: int
    wall_s: float
    sw_cells: int
    hits: int
    candidates: int = 0
    # the flush's host work (run_search): the fetch + unpack of the step's
    # payload, then write_hits's vectorised columns, formatting and write
    fetch_s: float = 0.0
    columns_s: float = 0.0
    format_s: float = 0.0
    write_s: float = 0.0

    @property
    def reads_per_s(self) -> float:
        return self.reads / max(self.wall_s, 1e-9)

    @property
    def gcups(self) -> float:
        return self.sw_cells / max(self.wall_s, 1e-9) / 1e9


class MetricsLog:
    def __init__(self):
        self.batches: List[BatchMetrics] = []
        self.setup_s = 0.0   # run_search's one-time set-up (the name map)

    def add(self, m: BatchMetrics) -> None:
        self.batches.append(m)

    def summary(self) -> dict:
        if not self.batches:
            return {"reads": 0, "wall_s": 0.0, "reads_per_s": 0.0, "gcups": 0.0,
                    "hits": 0}
        reads = sum(b.reads for b in self.batches)
        wall = sum(b.wall_s for b in self.batches)
        cells = sum(b.sw_cells for b in self.batches)
        return {
            "reads": reads,
            "wall_s": round(wall, 3),
            "reads_per_s": round(reads / max(wall, 1e-9), 1),
            "gcups": round(cells / max(wall, 1e-9) / 1e9, 3),
            "hits": sum(b.hits for b in self.batches),
        }

    def dumps(self) -> str:
        return json.dumps(self.summary())
