"""The trace reduction and the readers of the traced run, on a small
Chrome trace written here: device ops put under the harness range open
when they were launched, the device's busy union, the idle gaps and their
labels, and the roofline readers' counts."""

import json

import pytest

from portbench import roofline, spec
from portbench.trace import Trace

MAIN, FLUSH = 1, 2


def X(cat, name, ts, dur, tid=MAIN, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                pid=1, args=args)


def kernel(name, launch_ts, ts, dur, corr, tid=MAIN):
    return [X("cuda_runtime", "cudaLaunchKernel", launch_ts, 1, tid=tid,
              correlation=corr),
            X("kernel", name, ts, dur, tid=7, correlation=corr)]


@pytest.fixture
def trace(tmp_path):
    ev = [X("user_annotation", "portbench.window", 0, 1000),
          X("user_annotation", "portbench.launch", 10, 300),
          X("user_annotation", "portbench.propose", 20, 100),
          X("user_annotation", "portbench.align", 130, 100),
          X("user_annotation", "portbench.refine", 240, 50),
          X("user_annotation", "portbench.flush.write", 600, 300, tid=FLUSH)]
    ev += kernel("void sort_rows_kernel<12>(int const*)", 30, 40, 50, 1)
    ev += kernel("void sw_rows_kernel<signed char, 1, false>(x)", 140, 150,
                 100, 2)
    ev += kernel("void refine_thread<1, false>(x)", 250, 260, 40, 3)
    ev += kernel("elementwise", 300, 305, 5, 4)      # launch, no stage
    ev += [X("gpu_memcpy", "Memcpy DtoH", 320, 10, tid=7, correlation=5),
           X("cuda_runtime", "cudaMemcpyAsync", 315, 1, tid=FLUSH,
             correlation=5)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=ev)))
    return Trace(str(p))


def test_ops_under_their_ranges(trace):
    assert trace.device_us("propose") == 50
    assert trace.device_us("align") == 100
    assert trace.device_us("refine") == 40
    assert trace.device_us("launch") == 5


def test_busy_and_gaps(trace):
    assert trace.window_us() == 990           # from the first launch
    assert trace.busy_us() == 50 + 100 + 40 + 5 + 10
    gaps = trace.idle_gaps()
    assert gaps[0][0] == "flush.write"      # 330-1000, main thread waits
    assert gaps[0][1] == pytest.approx(670e-6)
    assert [g[0] for g in gaps[1:3]] == ["propose", "propose"]
    assert [g[1] for g in gaps[1:3]] == pytest.approx([60e-6, 30e-6])


def test_readers(trace):
    rec = dict(trace=trace, profiled_batches=1,
               cfg=dict(band_width=32, max_hits=10),
               shapes=dict(sw_fused=[[[[1000, 40]], 1]],
                           refine=[[[[200, 72]], 1]]))
    assert spec.reader("device_ms.align")(rec) == pytest.approx(0.1)
    assert spec.reader("device_idle_pct")(rec) == pytest.approx(
        100 * (1 - 205 / 990))
    sw = roofline.bound(*roofline.sw_counts(1000, 40, 32))[0]
    assert spec.reader("sw_fused_roofline")(rec) == pytest.approx(
        100 * sw / 100e-6)
    r1 = roofline.bound(*roofline.refine_counts(20, 10, 40, 32))[0]
    assert spec.reader("refine_roofline")(rec) == pytest.approx(
        100 * r1 / 40e-6)
    # launches the trace does not hold: nothing to read
    rec["shapes"]["refine"] = [[[[200, 72]], 2]]
    assert spec.reader("refine_roofline")(rec) is None


def test_sort_vote_reader(tmp_path):
    """B2's monolithic entry: two launches at (6144, 5120), CSR rows (no
    presorted run), 8 candidates a frame, 400 us of device time."""
    ev = [X("user_annotation", "portbench.window", 0, 1000),
          X("user_annotation", "portbench.launch", 10, 900)]
    ev += kernel("void (anonymous namespace)::sort_vote_kernel<13, 8>(x)",
                 20, 30, 150, 1)
    ev += kernel("void (anonymous namespace)::sort_vote_kernel<13, 8>(x)",
                 40, 200, 250, 2)
    ev += kernel("void merge_vote_kernel<8>(x)", 60, 500, 50, 3)
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=ev)))
    rec = dict(trace=Trace(str(p)), profiled_batches=1,
               cfg=dict(candidates_per_frame=8),
               layout=dict(table_mode="csr", shards=2, presorted_run=0),
               shapes=dict(sort_vote_rank_rows=[[[[6144, 5120]], 2]]))
    least = roofline.bound(*roofline.sort_vote_counts(6144, 5120, 8))[0]
    assert spec.reader("sort_vote_roofline")(rec) == pytest.approx(
        100 * 2 * least / 400e-6)
    # a run with no layout record (or one launch the trace lacks): nothing
    assert spec.reader("sort_vote_roofline")(
        {k: v for k, v in rec.items() if k != "layout"}) is None
    rec["shapes"]["sort_vote_rank_rows"][0][1] = 3
    assert spec.reader("sort_vote_roofline")(rec) is None
