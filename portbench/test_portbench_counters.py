"""The readers of the program's counters (portbench/counters.py) and the
program's spans in a profiled trace: each counter reader reads its
BatchMetrics field and nothing where the program lacks it; the program's
"ghostm.*" ranges leave every reader of the trace as it was."""

import json

import pytest

from portbench import counters, spec
from portbench.test_portbench_files import BENCH
from portbench.test_portbench_trace import FLUSH, X, trace  # noqa: F401
from portbench.trace import Trace

COUNTERS = {"loop_wait_ms": "wait_s", "queue_ms": "queue_s",
            "step_cpu_ms": "step_cpu_s", "writer_ms.evalue": "evalue_s",
            "writer_ms.names": "names_s"}


def test_counter_readers_read_their_fields():
    from ghostm_tpu_torch.utils.metrics import BatchMetrics

    fields = set(BatchMetrics.__dataclass_fields__)
    assert set(COUNTERS.values()) <= fields
    rec = {"batches": [vars(BatchMetrics(
        reads=8, wall_s=1.0, hits=3,
        **{f: (i + 1) * 1e-3 * k for i, f in enumerate(COUNTERS.values())}))
        for k in (1, 3)]}
    for i, (m, f) in enumerate(COUNTERS.items()):
        assert spec.reader(m)(rec) == pytest.approx((i + 1) * 2.0), m
        assert counters.mean_ms(rec, f) == spec.reader(m)(rec)


@pytest.mark.parametrize("m", sorted(COUNTERS))
def test_counter_readers_without_the_counter(m):
    """A program without the field (the parent of the counters) and a run
    with no batches: nothing to read, no error."""
    old = {"batches": [dict(reads=8, wall_s=1.0, hits=3, fetch_s=0.1,
                            columns_s=0.1, format_s=0.1, write_s=0.1)]}
    assert spec.reader(m)(old) is None
    assert spec.reader(m)({"batches": []}) is None


def test_counters_are_per_layer_program_counters():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for m in COUNTERS:
        assert entries[m]["source"] == "program_counter"
        assert entries[m]["workloads"] == ["swissprot_k5.reads100",
                                           "swissprot_full.reads100"]


PROGRAM_SPANS = [
    X("user_annotation", "ghostm.loop.next", 1, 3),
    X("user_annotation", "ghostm.step#0", 5, 318),
    X("user_annotation", "ghostm.step.h2d", 12, 5),
    X("user_annotation", "ghostm.step.translate", 18, 1),
    X("user_annotation", "ghostm.step.propose", 19, 108),
    X("user_annotation", "ghostm.step.align", 128, 108),
    X("user_annotation", "ghostm.step.rank", 237, 2),
    X("user_annotation", "ghostm.step.refine", 241, 48),
    X("user_annotation", "ghostm.step.pack", 295, 10),
    X("user_annotation", "ghostm.loop.wait", 330, 669),
    X("user_annotation", "ghostm.flush#0", 311, 680, tid=FLUSH),
    X("user_annotation", "ghostm.flush.fetch", 312, 18, tid=FLUSH),
    X("user_annotation", "ghostm.flush.columns", 400, 150, tid=FLUSH),
    X("user_annotation", "ghostm.flush.format", 620, 180, tid=FLUSH),
]


def test_program_spans_leave_the_readers_as_they_were(trace, tmp_path):
    """The fixture's trace again with the program's spans nested as
    run_search nests them: every reader of a traced run, and the
    breakdown, read the same."""
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    p = tmp_path / "spans.json"
    p.write_text(json.dumps(dict(traceEvents=events + PROGRAM_SPANS)))
    spanned = Trace(str(p))
    shapes = dict(sw_fused=[[[[1000, 40]], 1]], refine=[[[[200, 72]], 1]])
    for tr in (trace, spanned):
        assert tr.window_us() == 990
    for name in ("launch", "propose", "align", "refine", "flush.write",
                 "flush.fetch"):
        assert spanned.device_us(name) == trace.device_us(name)
    assert spanned.busy_us() == trace.busy_us()
    assert spanned.top_ops() == trace.top_ops()
    assert spanned.idle_gaps() == trace.idle_gaps()
    recs = [dict(trace=tr, profiled_batches=1, shapes=shapes,
                 cfg=dict(band_width=32, max_hits=10))
            for tr in (trace, spanned)]
    traced = [m["name"] for m in BENCH["per_layer"]
              if m["source"] == "device_trace"]
    assert traced
    for m in traced:
        assert spec.reader(m)(recs[1]) == spec.reader(m)(recs[0]), m
