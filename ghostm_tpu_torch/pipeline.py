"""Batch streaming loop with checkpoint/resume (port of the JAX package's
pipeline.py).

The only mutable state of a search run is (input cursor, emitted rows) — the
index is immutable — so fault tolerance is per-batch result parts plus a
cursor manifest: results are written to `<out>.parts/part-{i}.tsv` with
`<out>.parts/cursor.json` recording completed batches; `--resume` skips
completed parts and re-runs the first incomplete one. Without checkpointing,
rows stream straight into the output file.

On one device, batch i+1's step is launched before batch i's result is
fetched and written: the fetch + TSV format + write of a batch run on one
background thread (a single worker keeps part files and cursor updates in
order), so host work overlaps the next batch's device work. The rows are
formatted in C (report.SubjectNames, native.m8_format) where the host
library is built.

Debug and observability hooks, as in the JAX package:
  * GHOSTM_TPU_SYNC_PIPELINE=1: batch i is flushed before batch i+1 is
    launched (no background thread; one batch in flight; the same bytes);
  * cfg.check (CLI --check): each batch is also translated on the host and
    run through SearchEngine.search_batch_checked before its step;
  * cfg.profile_dir (CLI --profile DIR): torch.profiler (CPU activity, and
    CUDA on a CUDA engine; every thread) around the batch loop; the Chrome
    trace goes to DIR/trace.json. The program's spans (utils.metrics.span,
    "ghostm.*") name the loop's, the step's and the flush's parts in it;
  * GHOSTM_TPU_HBM_LOG=FILE: device memory sampled after each batch's
    flush; at exit FILE holds the maxima as JSON (bytes_in_use,
    peak_bytes_in_use, largest_alloc_size, bytes_limit). A CPU engine has
    no allocator statistics: no file is written, and the run logs why.

A grid engine (SearchEngine(mesh=...), parallel/) searches each batch
through its collectives, synchronously (the host-translated frames in, the
host results out; the flush thread still writes). Two forms, as in the JAX
package:
  * the one-run grid (ranks the CLI started itself, Mesh.local_ranks):
    every rank gets the whole batch (search_batch_stats) and rank 0 alone
    writes the table, parts and cursor;
  * multi-process (joined with --num-processes): checkpointing is
    required; each process writes the row blocks it holds
    (search_batch_stats_local) as row-addressed parts
    `part-{bi:06d}-r{row:08d}.tsv` with its own `cursor-p{rank}.json`;
    --resume starts every process from the minimum cursor (a missing one
    counts 0); after a barrier rank 0 concatenates the parts, whose names
    sort into global row order.
Every rank of a grid ends at a barrier, so no rank exits 0 while a peer
died.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from ghostm_tpu_torch import native
from ghostm_tpu_torch.report import M8_HEADER, SubjectNames, write_hits
from ghostm_tpu_torch.utils.metrics import BatchMetrics, MetricsLog, span

log = logging.getLogger("ghostm_tpu_torch.pipeline")

HBM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "largest_alloc_size",
            "bytes_limit")


def _subject_names(index) -> SubjectNames:
    names = {}
    for sh in index.shards:
        for row, gid in enumerate(sh.store.subject_ids):
            names[int(gid)] = sh.store.names[row]
    return SubjectNames(names)


def device_memory(device: torch.device) -> dict:
    """The CUDA allocator's figures under the JAX package's memory_stats
    keys: bytes allocated now and at peak, the largest live allocation,
    and the card's memory (bytes_limit)."""
    st = torch.cuda.memory_stats(device)
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    largest = max((b["size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == idx for b in seg["blocks"]
                   if b["state"] == "active_allocated"), default=0)
    return dict(bytes_in_use=st.get("allocated_bytes.all.current", 0),
                peak_bytes_in_use=st.get("allocated_bytes.all.peak", 0),
                largest_alloc_size=largest,
                bytes_limit=torch.cuda.mem_get_info(device)[1])


@contextlib.contextmanager
def _profiled(engine, profile_dir: Optional[str]):
    """torch.profiler around the body when profile_dir is set; its Chrome
    trace is written to profile_dir/trace.json."""
    if not profile_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        # the flush thread's spans too: by default the profiler records
        # only the thread that starts it
        extra = dict(experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    except TypeError:
        log.warning("this torch's profiler records only the main thread: "
                    "the flush thread's spans are not in the trace")
        extra = {}
    with profile(activities=acts, **extra) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profile trace -> %s", path)


def _read_cursor(path: str) -> int:
    """Completed batches in a cursor file; 0 when it is missing or torn (a
    process killed while writing it)."""
    try:
        with open(path) as f:
            return int(json.load(f)["completed_batches"])
    except (FileNotFoundError, ValueError, KeyError):
        return 0


def _spanned(batches: Iterable):
    """The batches, each pulled from the caller's iterator (for `aln`, the
    FASTA reader) inside a "loop.next" span."""
    it = iter(batches)
    while True:
        with span("loop.next"):
            item = next(it, None)
        if item is None:
            return
        yield item


def run_search(engine, batches: Iterable, output: str,
               resume: bool = False,
               metrics: Optional[MetricsLog] = None) -> int:
    """Search every batch and write the m8 table to `output`; returns the
    rows written (by this process). metrics: a MetricsLog to fill (the
    one-time set-up and each batch's wall and host split), for a caller
    that reads them."""
    cfg = engine.cfg
    mesh = getattr(engine, "mesh", None)
    metrics = metrics if metrics is not None else MetricsLog()
    t_setup = time.perf_counter()
    snames = _subject_names(engine.index)
    if native.available():
        snames.arena()   # once, here, so that no batch carries it
    metrics.setup_s = time.perf_counter() - t_setup
    db_seqs = sum(sh.store.num_subjects for sh in engine.index.shards)
    checkpointing = cfg.checkpoint_batches > 0
    parts_dir = output + ".parts"
    cursor_path = os.path.join(parts_dir, "cursor.json")
    joined = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if joined else 0
    world = dist.get_world_size() if joined else 1
    multiproc = world > 1 and not (mesh is not None and mesh.local_ranks)
    writer = multiproc or rank == 0
    if multiproc and not checkpointing:
        raise ValueError(
            "multi-process runs need checkpoint_batches > 0 "
            "(per-batch row-addressed result parts)"
        )
    done = 0
    if checkpointing:
        os.makedirs(parts_dir, exist_ok=True)
        if multiproc:
            cursor_path = os.path.join(parts_dir, f"cursor-p{rank}.json")
        if resume and multiproc:
            # every process resumes from the same batch (each batch is a
            # sequence of collectives), the minimum of the process cursors:
            # a kill can land between one process's cursor write and its
            # peer's; re-writing a completed part writes the same bytes
            dones = [_read_cursor(os.path.join(parts_dir,
                                               f"cursor-p{pi}.json"))
                     for pi in range(world)]
            done = min(dones)
            log.info("resuming after %d completed batches (process "
                     "cursors: %s)", done, dones)
        elif resume and os.path.exists(cursor_path):
            done = _read_cursor(cursor_path)
            log.info("resuming after %d completed batches", done)
    # GHOSTM_TPU_HBM_LOG: the maxima of device_memory over the batches
    hbm_log = os.environ.get("GHOSTM_TPU_HBM_LOG")
    hbm_peak = {} if hbm_log and engine.device.type == "cuda" else None
    if hbm_log and hbm_peak is None:
        log.info("GHOSTM_TPU_HBM_LOG: a CPU engine has no device allocator "
                 "statistics; no device-memory log is written")
    sync = os.environ.get("GHOSTM_TPU_SYNC_PIPELINE") == "1"
    total_rows = 0
    out_f = None

    def _write_part(part, names, lens, hits, stats, split):
        with open(part + ".tmp", "w") as f:
            rows = write_hits(
                f, cfg, names, lens, snames, hits, stats,
                engine.index.total_residues, db_seqs, timing=split,
            )
        os.replace(part + ".tmp", part)
        return rows

    def _flush(p):
        nonlocal total_rows
        bi, names, lens, payload, t0, counts = p
        t1 = time.perf_counter()
        with span("flush", bi):
            # [(first row, hits, stats)]: the loop's one block, a grid's
            # blocks this process writes (none on a one-run grid's rank > 0)
            if mesh is not None:
                blocks = payload
            else:
                with span("flush.fetch"):
                    arr = engine.fetch(payload)
                with span("flush.unpack"):
                    blocks = [(0, *engine.unpack_results(arr))]
            split = dict(fetch_s=time.perf_counter() - t1)
            rows = 0
            for st0, hits, stats in blocks:
                n = hits.score.shape[0]
                nm, ln = names[st0:st0 + n], lens[st0:st0 + n]
                if checkpointing:
                    part = (f"part-{bi:06d}-r{st0:08d}.tsv" if multiproc
                            else f"part-{bi:06d}.tsv")
                    rows += _write_part(os.path.join(parts_dir, part), nm,
                                        ln, hits, stats, split)
                else:
                    rows += write_hits(
                        out_f, cfg, nm, ln, snames, hits, stats,
                        engine.index.total_residues, db_seqs, timing=split,
                    )
            with span("flush.record"):
                if checkpointing and writer:
                    with open(cursor_path, "w") as f:
                        json.dump({"completed_batches": bi + 1}, f)
                if hbm_peak is not None:
                    for k, v in device_memory(engine.device).items():
                        hbm_peak[k] = max(hbm_peak.get(k, 0), int(v))
                t_end = time.perf_counter()
                m = BatchMetrics(
                    reads=len(names), wall_s=t_end - t0, hits=rows,
                    queue_s=t1 - t0 - counts["step_s"], **counts, **split)
                metrics.add(m, t0, t_end)
                log.info(
                    "batch %d: %d reads, %d rows, wall %.1f ms: step %.1f "
                    "(cpu %.1f, graph stages %d), wait %.1f, queue %.1f, "
                    "fetch %.1f, columns %.1f (e-values %.1f, lengths %d), "
                    "format %.1f (names %.1f), write %.1f", bi, len(names),
                    rows, 1e3 * m.wall_s, 1e3 * m.step_s,
                    1e3 * m.step_cpu_s, m.graph_stages,
                    *(1e3 * getattr(m, k) for k in (
                        "wait_s", "queue_s", "fetch_s", "columns_s",
                        "evalue_s")),
                    m.evalue_lengths,
                    *(1e3 * getattr(m, k) for k in (
                        "format_s", "names_s", "write_s")),
                    extra={"metrics": vars(m)},
                )
        total_rows += rows

    def _launch(dna, lens):
        """One batch's step: the loop's device payload, or a grid's
        host row blocks ([(first row, hits, stats)])."""
        if mesh is None:
            if cfg.check:
                # bounds and NaN asserts (raise on a violation), then
                # the step
                engine.search_batch_checked(engine.translate(dna, lens))
            return engine.search_refine_async_dna(dna, lens)
        qcodes = engine.translate(dna, lens)
        if multiproc:
            return engine.search_batch_stats_local(qcodes)
        hits, stats = engine.search_batch_stats(qcodes)
        return [(0, hits, stats)] if writer else []

    def _wait(f) -> float:
        """The main thread's block on a flush's future (its errors
        propagate); returns its seconds."""
        t = time.perf_counter()
        with span("loop.wait"):
            f.result()
        return time.perf_counter() - t

    # (bi, names, lens, payload, launch time, {step_s, step_cpu_s, wait_s,
    # graph_stages})
    pending = None
    flusher = None if sync else ThreadPoolExecutor(1)
    fut = None
    try:
        with _profiled(engine, cfg.profile_dir):
            if writer and not checkpointing:
                out_f = open(output, "w")
                out_f.write(M8_HEADER + "\n")
            for bi, (names, dna, lens) in enumerate(_spanned(batches)):
                if checkpointing and bi < done:
                    continue
                t0 = time.perf_counter()
                cpu0 = time.thread_time()
                with span("step", bi):
                    payload = _launch(dna, lens)
                counts = dict(step_s=time.perf_counter() - t0,
                              step_cpu_s=time.thread_time() - cpu0,
                              wait_s=0.0, graph_stages=(
                                  engine.last_graph_stages
                                  if mesh is None else 0))
                if pending is not None:
                    if fut is not None:
                        # bound the queue: one flush in flight
                        pending[-1]["wait_s"] = _wait(fut)
                    fut = flusher.submit(_flush, pending)
                pending = (bi, names, lens, payload, t0, counts)
                if sync:
                    _flush(pending)
                    pending = None
            if fut is not None:
                pending[-1]["wait_s"] = _wait(fut)
                fut = None
            if pending is not None:
                _flush(pending)
                pending = None
        if world > 1:
            dist.barrier()   # a rank whose peer died fails here
        if checkpointing and rank == 0:
            # row-addressed part names sort into global row order
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
            if flusher is not None:
                flusher.shutdown(wait=True)
            if out_f is not None:
                out_f.close()
            if hbm_peak:
                with open(hbm_log, "w") as f:
                    json.dump(hbm_peak, f)
    log.info("search done: %s", metrics.dumps())
    return total_rows
