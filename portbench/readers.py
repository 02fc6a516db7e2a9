"""What each metric reads from a run's records (`rec`, run.py's
`run_cell`): the functions behind the one-line readers in metrics/. A
reader that finds nothing to read returns None, and the metric is left
out of the run's line.

Records: `window_s`, `reads_written`, `batches` (the window's
BatchMetrics), `peak_bytes`, `setup_s`, `launch_s` (host seconds inside
each window batch's search_refine_async_dna), `cfg` (the engine's
Config fields), `layout` (the engine's seed-table mode, shards in its
loop and presorted run); with --trace 1 also `engine` (the step alone:
reads, wall_s), `trace` (trace.Trace of the profiled stretch), `shapes`
(its launches by wrapper and input shapes), `profiled_batches`.
"""

from __future__ import annotations

import re

import numpy as np

from portbench import roofline

SW_KERNEL = re.compile(r"\bsw_rows_kernel\b")
REFINE_KERNEL = re.compile(r"\brefine_(thread|warp)\b")
SORT_VOTE_KERNEL = re.compile(r"\bsort_vote_kernel\b")


def reads_per_s(rec):
    """Reads whose m8 rows run_search wrote in the window, over the
    window (first batch handed over to the last rows written)."""
    if not rec.get("window_s"):
        return None
    return rec["reads_written"] / rec["window_s"]


def batch_p95_ms(rec):
    """95th percentile over all the window's batches of a batch's launch
    until its rows are written (BatchMetrics.wall_s)."""
    walls = [b["wall_s"] for b in rec.get("batches", ())]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None


def peak_device_gib(rec):
    """torch.cuda.max_memory_allocated() over set-up and the window."""
    return rec["peak_bytes"] / 2**30 if rec.get("peak_bytes") else None


def setup_s(rec):
    """Process start to the end of the warm batches, less the traffic
    pool and the index cache (both timed apart)."""
    return rec.get("setup_s")


def writer_ms(rec):
    """The m8 writer's host ms a window batch: write_hits's columns,
    formatting and write. The flush's fetch is left out: it waits for
    the batch's device work."""
    b = rec.get("batches")
    if not b:
        return None
    return float(np.mean([x["columns_s"] + x["format_s"] + x["write_s"]
                          for x in b])) * 1e3


def engine_reads_per_s(rec):
    """The step alone, with a background fetch and no writer: reads over
    the stretch's wall."""
    e = rec.get("engine")
    return e["reads"] / e["wall_s"] if e and e["wall_s"] else None


def launch_ms(rec):
    """Mean host ms a window batch inside search_refine_async_dna."""
    t = rec.get("launch_s")
    return float(np.mean(t)) * 1e3 if t else None


def device_ms(rec, stage: str):
    """Device ms a batch of the ops launched under the harness's range
    `stage`, profiled stretch."""
    tr = rec.get("trace")
    if tr is None or not tr.window_us():
        return None
    us = tr.device_us(stage)
    return us / rec["profiled_batches"] * 1e-3 if us else None


def device_idle_pct(rec):
    """100 x (1 - union of the device ops' intervals / the profiled
    stretch's wall)."""
    tr = rec.get("trace")
    if tr is None or not tr.window_us():
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us())


def _share(rec, wrapper: str, pattern, least_s) -> float | None:
    """100 x the launches' least time (least_s(shape) a launch) over
    their device time, when the trace holds every launch of `wrapper`."""
    tr, launches = rec.get("trace"), rec.get("shapes", {}).get(wrapper)
    if tr is None or not launches:
        return None
    durs = tr.kernel_durations(pattern)
    if not durs or len(durs) != sum(n for _, n in launches):
        return None
    secs = sum(least_s(shp) * n for (shp,), n in launches)
    return 100.0 * secs / (sum(durs) * 1e-6)


def sw_fused_roofline(rec):
    """Kernel B3: its launches' least time at their (N, Lq) and the band
    over their device time."""
    band = rec["cfg"]["band_width"] if "cfg" in rec else 0
    return _share(rec, "sw_fused", SW_KERNEL, lambda s: roofline.bound(
        *roofline.sw_counts(s[0], s[1], band))[0])


def refine_roofline(rec):
    """Kernel R1: its launches' least time at their (N, Lq + band) over
    their device time; N = reads x max_hits."""
    cfg = rec.get("cfg", {})
    K, B = cfg.get("max_hits", 1), cfg.get("band_width", 0)
    return _share(rec, "refine", REFINE_KERNEL, lambda s: roofline.bound(
        *roofline.refine_counts(s[0] // K, K, s[1] - B, B))[0])


def sort_vote_roofline(rec):
    """Kernel B2's monolithic entry: its launches' least time at their
    (Q, M), the candidates a frame and the engine's presorted run, over
    their device time."""
    if "layout" not in rec:
        return None
    ncand = rec["cfg"]["candidates_per_frame"]
    run = rec["layout"]["presorted_run"]
    return _share(rec, "sort_vote_rank_rows", SORT_VOTE_KERNEL,
                  lambda s: roofline.bound(*roofline.sort_vote_counts(
                      s[0], s[1], ncand, run))[0])
