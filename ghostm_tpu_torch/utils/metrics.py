"""Per-batch metrics records (SURVEY.md §5.5) and the program's trace spans.

`BatchMetrics` holds the host counters of one batch of `run_search`,
always on (a few clock reads a batch). `span` names the layers of the
batch loop for `torch.profiler`; it costs one flag test when no profiler
records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL_SPAN = contextlib.nullcontext()


def span(name: str, batch: Optional[int] = None):
    """A `torch.profiler.record_function` range "ghostm.<name>" while a
    profiler records, so the program's layers land in the trace beside the
    device's ops; one shared null context otherwise (entering
    record_function costs microseconds even with no profiler). A batch's two
    outer spans (`step`, `flush`) carry its index as "ghostm.<name>#<batch>"
    (the Chrome trace drops record_function's string args), and the
    engine's and writer's spans nest inside them."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    if batch is not None:
        name = f"{name}#{batch}"
    return torch.profiler.record_function("ghostm." + name)


@dataclasses.dataclass
class BatchMetrics:
    reads: int
    wall_s: float        # the batch's launch until its rows are written
    hits: int
    # the flush's host work (run_search): the fetch + unpack of the step's
    # payload, then write_hits's vectorised columns, formatting and write
    fetch_s: float = 0.0
    columns_s: float = 0.0
    format_s: float = 0.0
    write_s: float = 0.0
    # the main loop: its block on the previous flush before it hands this
    # batch to the flush thread, then the wait from the end of this
    # batch's step to the start of its flush
    wait_s: float = 0.0
    queue_s: float = 0.0
    # the step's wall and the main thread's CPU seconds in it
    step_s: float = 0.0
    step_cpu_s: float = 0.0
    # parts of columns_s (the e-values) and of format_s (the read names)
    evalue_s: float = 0.0
    names_s: float = 0.0
    # the distinct query lengths whose e-value length adjustment was solved
    evalue_lengths: int = 0
    # the step's stages this batch replayed from CUDA graphs (0: eager)
    graph_stages: int = 0


class MetricsLog:
    def __init__(self):
        self.batches: List[BatchMetrics] = []
        self.setup_s = 0.0   # run_search's one-time set-up (the name map)
        # perf_counter seconds: the first batch's launch, the last rows
        # written
        self.first_launch = math.inf
        self.last_written = -math.inf

    def add(self, m: BatchMetrics, launched: float, written: float) -> None:
        self.batches.append(m)
        self.first_launch = min(self.first_launch, launched)
        self.last_written = max(self.last_written, written)

    def summary(self) -> dict:
        """Reads and rows written, and the rate over the window from the
        first batch's launch to the last rows written."""
        if not self.batches:
            return {"reads": 0, "wall_s": 0.0, "reads_per_s": 0.0,
                    "hits": 0}
        reads = sum(b.reads for b in self.batches)
        wall = self.last_written - self.first_launch
        return {
            "reads": reads,
            "wall_s": round(wall, 3),
            "reads_per_s": round(reads / max(wall, 1e-9), 1),
            "hits": sum(b.hits for b in self.batches),
        }

    def dumps(self) -> str:
        return json.dumps(self.summary())
