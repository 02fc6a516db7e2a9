"""The port's debug and observability hooks on the CPU: GHOSTM_TPU_SYNC_PIPELINE
(batch i flushed before batch i + 1 is launched, the same bytes),
--profile (torch.profiler's Chrome trace), GHOSTM_TPU_HBM_LOG on a CPU
engine (no file, a log line saying why), --debug-nans, the CLI's flags
(the debug flags, and the mesh and multi-process flags: run, or refused
as the JAX CLI refuses them), run_search's host split and counters, the
program's spans in a --profile trace (and no record_function entered
without a profiler), and MetricsLog's window rate. The config-1 golden is
the expected table throughout (byte for byte)."""

import json
import logging
import os
import re

import jax
import pytest
import torch

from ghostm_tpu.parallel.mesh import make_mesh as jmake_mesh
from ghostm_tpu_torch import engine as tengine
from ghostm_tpu_torch import native, pipeline
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.io.fasta import read_batches
from ghostm_tpu_torch.utils.metrics import BatchMetrics, MetricsLog

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
DB = os.path.join(GOLD, "config1_db.fa")
READS = os.path.join(GOLD, "config1_reads.fa")


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("dbg") / "idx")
    assert tcli(["db", "-i", DB, "-o", prefix]) == 0
    return prefix


def _golden():
    with open(os.path.join(GOLD, "config1_hits.tsv")) as f:
        return f.read()


@pytest.fixture(autouse=True)
def _no_debug_nans(monkeypatch):
    """--debug-nans is process-wide: set it back after each test."""
    monkeypatch.setattr(tengine, "DEBUG_NANS", False)


def _aln(prefix, out, *flags):
    return tcli(["aln", "-d", prefix, "-i", READS, "-o", out, "--device",
                 "cpu", *flags])


@pytest.mark.parametrize("sync", ["0", "1"])
def test_sync_pipeline_order_and_bytes(index, tmp_path, monkeypatch, sync):
    """4 batches of 32 reads: with GHOSTM_TPU_SYNC_PIPELINE=1 each batch is
    written before the next is launched; without it batch i + 1 is
    launched first. The table is the golden either way."""
    events = []
    launch = tengine.SearchEngine.search_refine_async_dna
    write = pipeline.write_hits

    def launch_(self, dna, lens):
        events.append("launch")
        return launch(self, dna, lens)

    def write_(*a, **k):
        events.append("write")
        return write(*a, **k)

    monkeypatch.setattr(tengine.SearchEngine, "search_refine_async_dna",
                        launch_)
    monkeypatch.setattr(pipeline, "write_hits", write_)
    monkeypatch.setenv("GHOSTM_TPU_SYNC_PIPELINE", sync)
    out = str(tmp_path / "hits.tsv")
    assert _aln(index, out, "--batch", "32") == 0
    with open(out) as f:
        assert f.read() == _golden()
    assert events.count("launch") == events.count("write") == 4
    if sync == "1":
        assert events == ["launch", "write"] * 4
    else:
        assert events[:2] == ["launch", "launch"]


def test_sync_pipeline_with_checkpoints(index, tmp_path, monkeypatch):
    monkeypatch.setenv("GHOSTM_TPU_SYNC_PIPELINE", "1")
    cfgf = tmp_path / "cfg.json"
    cfgf.write_text(json.dumps({"checkpoint_batches": 1}))
    out = str(tmp_path / "hits.tsv")
    assert _aln(index, out, "--batch", "32", "--config", str(cfgf)) == 0
    with open(out) as f:
        assert f.read() == _golden()
    assert len([p for p in os.listdir(out + ".parts")
                if p.startswith("part-")]) == 4


def test_profile_writes_a_trace(index, tmp_path):
    out, prof = str(tmp_path / "hits.tsv"), str(tmp_path / "prof")
    assert _aln(index, out, "--batch", "128", "--profile", prof) == 0
    with open(out) as f:
        assert f.read() == _golden()
    path = os.path.join(prof, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_hbm_log_on_a_cpu_engine(index, tmp_path, monkeypatch, caplog):
    """A CPU engine has no allocator statistics: GHOSTM_TPU_HBM_LOG writes
    no file and the run logs one line saying so."""
    log_path = tmp_path / "hbm.json"
    monkeypatch.setenv("GHOSTM_TPU_HBM_LOG", str(log_path))
    cfg = Config(query_batch=128)
    eng = tengine.SearchEngine(cfg, load_index(index), device="cpu")
    out = str(tmp_path / "hits.tsv")
    with caplog.at_level(logging.INFO, logger="ghostm_tpu_torch.pipeline"):
        rows = pipeline.run_search(eng, read_batches(READS, 128, 120), out)
    assert rows == 549
    assert not log_path.exists()
    why = [r.message for r in caplog.records if "GHOSTM_TPU_HBM_LOG" in
           r.message]
    assert len(why) == 1 and "CPU engine" in why[0]


def test_run_search_host_split(index, tmp_path):
    """run_search fills a caller's MetricsLog: the one-time set-up (the
    name map and its arena) and, per batch, fetch + unpack, the
    vectorised columns, formatting and the write; the rows go through the
    native formatter."""
    eng = tengine.SearchEngine(Config(query_batch=32), load_index(index),
                               device="cpu")
    m = MetricsLog()
    native.reset_calls()
    out = str(tmp_path / "hits.tsv")
    assert pipeline.run_search(eng, read_batches(READS, 32, 120), out,
                               metrics=m) == 549
    with open(out) as f:
        assert f.read() == _golden()
    assert m.setup_s > 0 and len(m.batches) == 4
    for b in m.batches:
        assert min(b.fetch_s, b.columns_s, b.format_s, b.write_s) > 0
    assert native.CALLS[("m8_format", "native")] == 4
    assert native.CALLS[("m8_format", "python")] == 0


def test_run_search_counters(index, tmp_path):
    """run_search fills the loop's counters on every batch: the main
    loop's wait on the previous flush, the queue from the end of the step
    to the flush, the step's wall and CPU seconds, and inside the
    writer's columns and formatting the e-values and the read names."""
    eng = tengine.SearchEngine(Config(query_batch=32), load_index(index),
                               device="cpu")
    m = MetricsLog()
    out = str(tmp_path / "hits.tsv")
    assert pipeline.run_search(eng, read_batches(READS, 32, 120), out,
                               metrics=m) == 549
    with open(out) as f:
        assert f.read() == _golden()
    assert len(m.batches) == 4
    # batch 0 is handed over with no flush in flight; batches 1-2 wait on
    # the one before them, batch 3 (flushed by the main thread) on batch 2
    assert m.batches[0].wait_s == 0
    for b in m.batches:
        assert min(b.queue_s, b.step_s, b.step_cpu_s, b.evalue_s,
                   b.names_s) > 0
        assert b.evalue_s <= b.columns_s and b.names_s <= b.format_s
        assert b.step_cpu_s <= b.step_s + 2e-3
        assert b.wall_s >= b.step_s + b.queue_s - 1e-9
    assert all(b.wait_s > 0 for b in m.batches[1:])


@pytest.mark.parametrize("reads", ["uniform", "mixed"])
def test_run_search_evalue_lengths(index, tmp_path, caplog, reads):
    """Each batch records the distinct query lengths whose e-value length
    adjustment the writer solved (BatchMetrics.evalue_lengths), and its
    log line carries it: 1 a batch of the golden's 100 bp reads; a
    batch's distinct count (qlen_aa = max(bp // 3, 1)) when the same
    reads are cut to 1-100 bp."""
    path = READS
    if reads == "mixed":
        path = str(tmp_path / "mixed.fa")
        with open(READS) as f, open(path, "w") as g:
            for i, line in enumerate(f):
                if not line.startswith(">"):
                    line = line.strip()[:max(100 - 13 * (i // 2 % 8), 1)]
                g.write(line.strip() + "\n")
    want = []
    for names, _, lens in read_batches(path, 32, 120):
        want.append(len({max(int(n) // 3, 1)
                         for n in lens[:len(names)]}))
    eng = tengine.SearchEngine(Config(query_batch=32), load_index(index),
                               device="cpu")
    m = MetricsLog()
    out = str(tmp_path / "hits.tsv")
    with caplog.at_level(logging.INFO, logger="ghostm_tpu_torch.pipeline"):
        pipeline.run_search(eng, read_batches(path, 32, 120), out,
                            metrics=m)
    got = [b.evalue_lengths for b in m.batches]
    assert got == want
    assert want == [1] * 4 if reads == "uniform" else min(want) > 1
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("batch ")]
    assert len(lines) == 4
    for ln, n in zip(lines, want):
        assert "(e-values " in ln and f", lengths {n})" in ln


def _spans(path):
    """The trace's ghostm.* ranges: [(name, batch id or None, tid, start,
    end)]."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("ghostm."):
            name, _, bi = e["name"][len("ghostm."):].partition("#")
            out.append((name, int(bi) if bi else None, e["tid"],
                        e["ts"], e["ts"] + e["dur"]))
    return out


def test_profile_trace_has_the_program_spans(index, tmp_path):
    """aln --profile over 4 batches: the trace holds the loop's, the
    step's and the flush's spans, the flush thread's included; each
    engine span lies inside its batch's ghostm.step on the same thread,
    each writer span inside a ghostm.flush, and every batch has one step
    and one flush."""
    out, prof = str(tmp_path / "hits.tsv"), str(tmp_path / "prof")
    assert _aln(index, out, "--batch", "32", "--profile", prof) == 0
    with open(out) as f:
        assert f.read() == _golden()
    spans = _spans(os.path.join(prof, "trace.json"))
    names = {s[0] for s in spans}
    assert {"loop.next", "loop.wait", "step", "step.h2d", "step.translate",
            "step.propose", "step.align", "step.rank", "step.refine",
            "step.pack", "flush", "flush.fetch", "flush.unpack",
            "flush.columns", "flush.evalue", "flush.format", "flush.names",
            "flush.write", "flush.record"} <= names
    for outer in ("step", "flush"):
        ids = sorted(s[1] for s in spans if s[0] == outer)
        assert ids == [0, 1, 2, 3]
        boxes = [s for s in spans if s[0] == outer]
        inner = [s for s in spans if s[0].startswith(outer + ".")]
        assert inner and all(s[1] is None for s in inner)
        for name, _, tid, a, b in inner:
            assert any(t == tid and a0 <= a and b <= b0
                       for _, _, t, a0, b0 in boxes), name
    # batches 0-2 are flushed on the flush thread, batch 3 on the main one
    flush_tid = {s[1]: s[2] for s in spans if s[0] == "flush"}
    main = {s[2] for s in spans if s[0] == "step"}
    assert len(main) == 1 and flush_tid[3] in main
    assert not {flush_tid[b] for b in (0, 1, 2)} & main


def test_no_profiler_no_record_function(index, tmp_path, monkeypatch):
    """With no profiler recording, run_search enters no record_function:
    every span is the shared null context."""
    from ghostm_tpu_torch.utils import metrics as mmod

    calls = []

    def stub(*a, **k):
        calls.append(a)
        return mmod._NULL_SPAN

    monkeypatch.setattr(torch.profiler, "record_function", stub)
    eng = tengine.SearchEngine(Config(query_batch=32), load_index(index),
                               device="cpu")
    out = str(tmp_path / "hits.tsv")
    assert pipeline.run_search(eng, read_batches(READS, 32, 120),
                               out) == 549
    assert calls == []
    # the stub is what a span enters while a profiler records
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    with mmod.span("step", 7):
        pass
    assert calls == [("ghostm.step#7",)]


def test_metrics_log_window_rate(index, tmp_path):
    """MetricsLog.summary(): reads over the window from the first launch
    to the last rows written (not over the sum of the batches' overlapping
    walls), and no GCUPS."""
    m = MetricsLog()
    m.add(BatchMetrics(reads=100, wall_s=2.0, hits=5), 10.0, 12.0)
    m.add(BatchMetrics(reads=100, wall_s=3.0, hits=7), 11.0, 14.0)
    assert m.summary() == {"reads": 200, "wall_s": 4.0,
                           "reads_per_s": 50.0, "hits": 12}
    assert not {"sw_cells", "candidates"} & set(vars(m.batches[0]))
    eng = tengine.SearchEngine(Config(query_batch=32), load_index(index),
                               device="cpu")
    m = MetricsLog()
    out = str(tmp_path / "hits.tsv")
    assert pipeline.run_search(eng, read_batches(READS, 32, 120), out,
                               metrics=m) == 549
    s = m.summary()
    assert set(s) == {"reads", "wall_s", "reads_per_s", "hits"}
    assert s["hits"] == 549
    assert 0 < m.last_written - m.first_launch < sum(
        b.wall_s for b in m.batches)
    assert s["reads_per_s"] == round(
        s["reads"] / (m.last_written - m.first_launch), 1)


def test_debug_nans(index, tmp_path):
    """--debug-nans turns the process-wide NaN check on (the run writes
    the golden: every stage returns integers); the check names the stage
    of a floating output that holds a NaN."""
    out = str(tmp_path / "hits.tsv")
    assert _aln(index, out, "--batch", "128", "--debug-nans") == 0
    assert tengine.DEBUG_NANS
    with open(out) as f:
        assert f.read() == _golden()
    bad = torch.tensor([1.0, float("nan")])
    with pytest.raises(FloatingPointError, match="stage refine"):
        tengine._check_nans("refine", torch.zeros(2, dtype=torch.int32), bad)
    tengine.DEBUG_NANS = False
    tengine._check_nans("refine", bad)            # off: no check
    with pytest.raises(FloatingPointError, match="stage align"):
        tengine._check_nans("align", bad, check=True)


def test_cli_accepts_the_debug_flags(index, tmp_path, monkeypatch):
    """--check, --debug-nans and --profile together, with both variables
    set: the golden's bytes."""
    monkeypatch.setenv("GHOSTM_TPU_SYNC_PIPELINE", "1")
    monkeypatch.setenv("GHOSTM_TPU_HBM_LOG", str(tmp_path / "hbm.json"))
    out = str(tmp_path / "hits.tsv")
    assert _aln(index, out, "--batch", "128", "--check", "--debug-nans",
                "--profile", str(tmp_path / "prof")) == 0
    with open(out) as f:
        assert f.read() == _golden()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


@pytest.mark.parametrize("flags", [
    ["--data-axis", "2", "--cpu", "2"], ["--db-axis", "2", "--cpu", "2"],
    ["--coordinator", "127.0.0.1:9", "--num-processes", "1"],
    ["--num-processes", "2", "--checkpoint-batches", "1"],
    ["--process-id", "2", "--num-processes", "2", "--coordinator",
     "127.0.0.1:9", "--checkpoint-batches", "1"],
    ["--cpu", "2", "--data-axis", "2", "--db-axis", "2"],
])
def test_cli_still_rejects_mesh_flags(index, tmp_path, monkeypatch, flags):
    """The mesh and multi-process flags through the port's CLI: the
    config-1 golden through two local ranks (`--cpu 2` with `--data-axis
    2`, and with `--db-axis 2` over `db --shards 2`) and through one
    process of a 1x1 grid (`--num-processes 1`, as the JAX CLI builds a
    1x1 mesh for it); refused, before joining any peer: 2 processes
    without a coordinator, a process id outside [0, 2), and a grid larger
    than --cpu allows (the JAX package's "needs 4 devices", word for
    word)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "h.tsv")
    prefix = index
    if flags[0] == "--db-axis":
        prefix = str(tmp_path / "idx2")
        assert tcli(["db", "-i", DB, "-o", prefix, "--shards", "2"]) == 0
    args = [prefix, out, "--batch", "128", *flags]
    if flags[0] in ("--data-axis", "--db-axis", "--coordinator"):
        assert _aln(*args) == 0
        with open(out) as f:
            assert f.read() == _golden()
        return
    if flags[0] == "--cpu":
        with pytest.raises(ValueError) as want:
            jmake_mesh(2, 2, jax.devices()[:2])
        match = re.escape(str(want.value))
    else:
        match = {"--num-processes": "2 processes need a coordinator",
                 "--process-id": r"process id 2 is not in \[0, 2\)"}[flags[0]]
    with pytest.raises(ValueError, match=match):
        _aln(*args)
    assert not os.path.exists(out)
