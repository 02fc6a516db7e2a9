"""Batch streaming loop with checkpoint/resume (port of the JAX package's
pipeline.py, one process, no mesh).

The only mutable state of a search run is (input cursor, emitted rows) — the
index is immutable — so fault tolerance is per-batch result parts plus a
cursor manifest: results are written to `<out>.parts/part-{i}.tsv` with
`<out>.parts/cursor.json` recording completed batches; `--resume` skips
completed parts and re-runs the first incomplete one. Without checkpointing,
rows stream straight into the output file.

Batch i+1's device step is launched before batch i's result is fetched and
written: the fetch + TSV format + write of a batch run on one background
thread (a single worker keeps part files and cursor updates in order), so
host work overlaps the next batch's device work. Not ported yet: the
profiler trace and the device-memory log.
"""

from __future__ import annotations

import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

from ghostm_tpu_torch.report import M8_HEADER, write_hits
from ghostm_tpu_torch.utils.metrics import BatchMetrics, MetricsLog

log = logging.getLogger("ghostm_tpu_torch.pipeline")

NFRAMES = 6


def _subject_names(index) -> Dict[int, str]:
    names = {}
    for sh in index.shards:
        for row, gid in enumerate(sh.store.subject_ids):
            names[int(gid)] = sh.store.names[row]
    return names


def run_search(engine, batches: Iterable, output: str,
               resume: bool = False) -> int:
    cfg = engine.cfg
    snames = _subject_names(engine.index)
    db_seqs = sum(sh.store.num_subjects for sh in engine.index.shards)
    metrics = MetricsLog()
    checkpointing = cfg.checkpoint_batches > 0
    parts_dir = output + ".parts"
    cursor_path = os.path.join(parts_dir, "cursor.json")
    done = 0
    if checkpointing:
        os.makedirs(parts_dir, exist_ok=True)
        if resume and os.path.exists(cursor_path):
            with open(cursor_path) as f:
                done = json.load(f)["completed_batches"]
            log.info("resuming after %d completed batches", done)
    total_rows = 0
    out_f = None

    def _flush(p):
        nonlocal total_rows
        bi, names, lens, R, payload, t0 = p
        hits, stats = engine.unpack_results(engine.fetch(payload))
        if checkpointing:
            part = os.path.join(parts_dir, f"part-{bi:06d}.tsv")
            with open(part + ".tmp", "w") as f:
                rows = write_hits(
                    f, cfg, names, lens, snames, hits, stats,
                    engine.index.total_residues, db_seqs,
                )
            os.replace(part + ".tmp", part)
            with open(cursor_path, "w") as f:
                json.dump({"completed_batches": bi + 1}, f)
        else:
            rows = write_hits(
                out_f, cfg, names, lens, snames, hits, stats,
                engine.index.total_residues, db_seqs,
            )
        wall = time.time() - t0
        cells = R * NFRAMES * cfg.candidates_per_frame \
            * cfg.query_frame_len * cfg.band_width
        m = BatchMetrics(len(names), wall, cells * engine.n_shards, rows)
        metrics.add(m)
        log.info(
            "batch %d: %d reads, %d rows, %.2fs (%.0f reads/s, %.2f GCUPS)",
            bi, len(names), rows, wall, m.reads_per_s, m.gcups,
            extra={"metrics": vars(m)},
        )
        total_rows += rows

    pending = None  # (bi, names, lens, R, device payload, t0)
    flusher = ThreadPoolExecutor(1)
    fut = None
    try:
        if not checkpointing:
            out_f = open(output, "w")
            out_f.write(M8_HEADER + "\n")
        for bi, (names, dna, lens) in enumerate(batches):
            if checkpointing and bi < done:
                continue
            t0 = time.time()
            payload = engine.search_refine_async_dna(dna, lens)
            if pending is not None:
                if fut is not None:
                    fut.result()   # propagate errors, bound the queue
                fut = flusher.submit(_flush, pending)
            pending = (bi, names, lens, dna.shape[0], payload, t0)
        if fut is not None:
            fut.result()
            fut = None
        if pending is not None:
            _flush(pending)
            pending = None
        if checkpointing:
            with open(output, "w") as f:
                f.write(M8_HEADER + "\n")
                for p in sorted(os.listdir(parts_dir)):
                    if p.startswith("part-") and p.endswith(".tsv"):
                        with open(os.path.join(parts_dir, p)) as pf:
                            f.write(pf.read())
    finally:
        try:
            if fut is not None:
                fut.result()
        finally:
            flusher.shutdown(wait=True)
            if out_f is not None:
                out_f.close()
    log.info("search done: %s", metrics.dumps())
    return total_rows
