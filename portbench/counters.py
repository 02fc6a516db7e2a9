"""The readers of the program's own counters: fields of each window
batch's BatchMetrics (`rec["batches"]`) that run_search fills. A program
that lacks the field (an older checkout) gives nothing to read."""

from __future__ import annotations

import numpy as np


def mean_ms(rec, field: str):
    """Mean ms a window batch of BatchMetrics.<field> (seconds)."""
    b = rec.get("batches")
    if not b or field not in b[0]:
        return None
    return float(np.mean([x[field] for x in b])) * 1e3
