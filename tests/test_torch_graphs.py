"""The engine step's CUDA graphs on the CPU: the rule that decides where
graphs run, the launch counts a replay adds back, and the graphed step
through a stand-in for the capture (each stage's function run again and
its results copied into the outputs it returned at capture, which is what
a replay of a CUDA graph does to its static outputs). The graphed step on
the card against the eager one is in tests/test_torch_cuda.py."""

import os
import types
from collections import Counter

import numpy as np
import pytest
import torch

from ghostm_tpu_torch import engine as E
from ghostm_tpu_torch import pipeline
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.io.fasta import read_batches
from ghostm_tpu_torch.kernels import _build
from ghostm_tpu_torch.ops.translate import (
    device_luts, six_frame_translate, six_frame_translate_torch,
)
from ghostm_tpu_torch.utils.metrics import MetricsLog

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLD, "config1_reads.fa")
BATCH = 16   # the golden's 100 reads: 6 batches and a tail of 4


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("graphs") / "idx")
    assert tcli(["db", "-i", os.path.join(GOLD, "config1_db.fa"), "-o",
                 prefix]) == 0
    return prefix


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [t for a in x for t in _flat(a)]
    return [x]


def _stand_in_capture(self, gs, fn, args, sig):
    """SearchEngine._capture on the CPU: the stage's outputs, made once
    and overwritten with garbage (a capture computes nothing); each replay
    runs fn(*args) again and copies its results into them."""
    with _build.Replayed(None).recording() as rg:
        out = fn(*args)
    for t in _flat(out):
        t.fill_(-7)

    def replay():
        for t, new in zip(_flat(out), _flat(fn(*args))):
            t.copy_(new)

    rg.graph = types.SimpleNamespace(replay=replay)
    self.graph_captures += 1
    return E._Stage(rg, out, sig)


@pytest.fixture
def graphed(monkeypatch):
    """The graph rule as on a CUDA device, and the stand-in capture."""
    monkeypatch.setattr(E, "graphs_device", lambda dev: True)
    monkeypatch.setattr(E.SearchEngine, "_capture", _stand_in_capture)


def _batches():
    """The golden's reads in batches of BATCH, the tail batch cut to its 4
    reads (search_refine_async_dna pads it)."""
    return [(names, dna[:len(names)], lens[:len(names)])
            for names, dna, lens in read_batches(READS, BATCH, 120)]


class _StandInGraph:
    """A graph whose capture launched `launches` kernels: the launches
    are counted (through the wrappers' _build.count) while recording."""

    def __init__(self, launches):
        self.launches = launches
        self.replays = 0

    def capture(self):
        for name, shape in self.launches:
            _build.count(name, shape)

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("launches", [
    [("sw_fused", (393216, 40)), ("refine", (81920, 72))],
    [("sort_rows", (6144, 4096)), ("sort_rows", (6144, 512)),
     ("merge_vote_rank_rows", (6144, 4096), )],
    [],
])
def test_replayed_counts(launches):
    """A capture's launches are taken back out of LAUNCHES and SHAPES,
    and every replay adds them again: after n replays the counts are
    what n eager runs count, with no zero entry left in SHAPES."""
    _build.reset_launches()
    _build.count("lex_rank_rows", (9, 8, 48))        # a launch before
    eager = Counter(_build.SHAPES)
    g = _StandInGraph(launches)
    rg = _build.Replayed(g)
    with rg.recording():
        g.capture()
    assert _build.SHAPES == eager
    assert sum(_build.LAUNCHES.values()) == 1
    for n in range(1, 4):
        rg.replay()
        assert g.replays == n
        for name, shape in launches:
            eager[(name, shape)] += 1
        assert _build.SHAPES == eager
        assert sum(_build.LAUNCHES.values()) == 1 + n * len(launches)
        for name in {name for name, _ in launches}:
            assert _build.LAUNCHES[name] == sum(
                v for (k, *_), v in eager.items() if k == name)
    assert all(v > 0 for v in _build.SHAPES.values())
    _build.reset_launches()


def test_replayed_counts_exception():
    """A capture that raises takes its launches back out all the same."""
    _build.reset_launches()
    rg = _build.Replayed(None)
    with pytest.raises(RuntimeError):
        with rg.recording():
            _build.count("sw_fused", (8, 40))
            raise RuntimeError("capture failed")
    assert sum(_build.LAUNCHES.values()) == 0 and not _build.SHAPES


@pytest.mark.parametrize("pack", [True, False])
def test_graphed_step_equals_eager(index, graphed, pack):
    """The graphed step (stand-in capture) over the golden's 7 batches of
    distinct reads, the tail of 4 included: batch 0 eager, batch 1
    captures the 6 stages, every later batch replays them; every payload
    equals the eager engine's, also fetched two replays later (the clone:
    a static output would hold the last batch's rows by then)."""
    idx = load_index(index)
    cfg = Config(query_batch=BATCH)
    g = E.SearchEngine(cfg, idx, device="cpu")
    c = E.SearchEngine(cfg, idx, device="cpu", key_table=g.key_table)
    if not pack:
        g._pack_ok = c._pack_ok = False
    batches = _batches()
    assert len(batches) == 7 and len(batches[-1][0]) == 4
    payloads, stages = [], []
    for _, dna, lens in batches:
        payloads.append(g.search_refine_async_dna(dna, lens))
        stages.append(g.last_graph_stages)
    n = len(E.GRAPH_STAGES)
    assert stages == [0] + [n] * 6
    assert g.graph_captures == n
    assert g.graph_replays == 6 * n
    assert g.graph_eager == n            # the warm-up batch
    assert c.graph_captures == c.graph_replays == c.graph_eager == 0
    hits = 0
    for p, (_, dna, lens) in zip(payloads, batches):
        want = c.fetch(c.search_refine_async_dna(dna, lens))
        np.testing.assert_array_equal(g.fetch(p), want)
        hits += int((want[1 if pack else 0] != 0).sum())
    assert hits > 0
    assert payloads[-1].shape[1] == 4


def test_graphed_step_refuses_moved_inputs(index, graphed):
    """A stage replayed on other tensors than it was captured on raises
    (its graph would read the old ones)."""
    g = E.SearchEngine(Config(query_batch=BATCH), load_index(index),
                       device="cpu")
    (_, dna, lens), = _batches()[:1]
    for _ in range(2):
        g.search_refine_async_dna(dna, lens)
    (gs,) = g._graphs.values()
    gs.stages["propose"].signature = ("elsewhere",)
    with pytest.raises(RuntimeError, match="propose"):
        g.search_refine_async_dna(dna, lens)
    assert g._graphing is None


def test_cpu_engine_captures_nothing(index, tmp_path):
    """The CPU engine runs every batch eager: no capture, no replay, no
    eager stage counted, graph_stages 0 in every batch's metrics; the
    golden table."""
    eng = E.SearchEngine(Config(query_batch=BATCH), load_index(index),
                         device="cpu")
    m = MetricsLog()
    out = str(tmp_path / "hits.tsv")
    assert pipeline.run_search(eng, read_batches(READS, BATCH, 120), out,
                               metrics=m) == 549
    assert (eng.graph_captures, eng.graph_replays, eng.graph_eager) == \
        (0, 0, 0)
    assert not eng._graphs
    assert [b.graph_stages for b in m.batches] == [0] * 7
    with open(out) as f, open(os.path.join(GOLD, "config1_hits.tsv")) as g:
        assert f.read() == g.read()


def test_fetch_waits_for_the_started_copy(index):
    """fetch takes the host copy search_refine_async_dna started (after
    waiting on its event) where the payload carries one, and copies the
    payload itself where not; a CPU engine starts none."""
    class Done:
        waited = 0

        def synchronize(self):
            Done.waited += 1

    payload = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    np.testing.assert_array_equal(E.SearchEngine.fetch(payload),
                                  payload.numpy())
    host = torch.full((2, 3), 7, dtype=torch.int32)
    payload.host_copy = (host, Done())
    got = E.SearchEngine.fetch(payload)
    assert Done.waited == 1
    np.testing.assert_array_equal(got, host.numpy())
    eng = E.SearchEngine(Config(query_batch=BATCH), load_index(index),
                         device="cpu")
    _, dna, lens = next(read_batches(READS, BATCH, 120))
    assert not hasattr(eng.search_refine_async_dna(dna, lens), "host_copy")


def test_check_path_captures_nothing(index, tmp_path, graphed, monkeypatch):
    """--check (cfg.check): each batch's checked pass runs its stages
    eager and neither captures nor replays, while the step beside it
    replays from the second batch on; graph_stages counts the step's
    replays in the metrics. The golden table."""
    cfg = Config(query_batch=BATCH, check=True)
    eng = E.SearchEngine(cfg, load_index(index), device="cpu")
    checked = E.SearchEngine.search_batch_checked
    seen = []

    def spy(self, qcodes):
        before = (self.graph_captures, self.graph_replays, self.graph_eager)
        out = checked(self, qcodes)
        seen.append((self.graph_captures - before[0],
                     self.graph_replays - before[1],
                     self.graph_eager - before[2]))
        return out

    monkeypatch.setattr(E.SearchEngine, "search_batch_checked", spy)
    m = MetricsLog()
    out = str(tmp_path / "hits.tsv")
    assert pipeline.run_search(eng, read_batches(READS, BATCH, 120), out,
                               metrics=m) == 549
    # propose, align, rank eager a checked pass
    assert seen == [(0, 0, 3)] * 7
    n = len(E.GRAPH_STAGES)
    assert eng.graph_captures == n
    assert [b.graph_stages for b in m.batches] == [0] + [n] * 6
    with open(out) as f, open(os.path.join(GOLD, "config1_hits.tsv")) as g:
        assert f.read() == g.read()


def test_grid_rank_rule(index, graphed):
    """A grid rank's engine (mesh=) never graphs, even where the device
    would: search_refine_async_dna is refused on it and its step runs
    eager (the grid's CPU runs are tests/test_torch_mesh.py)."""
    mesh = types.SimpleNamespace(data=1, db=1, db_index=0, data_index=0)
    eng = E.SearchEngine(Config(query_batch=BATCH), load_index(index),
                         device="cpu", mesh=mesh)
    assert not eng._graphs_on()
    (_, dna, lens), = _batches()[:1]
    with pytest.raises(ValueError, match="one device"):
        eng.search_refine_async_dna(dna, lens)
    assert eng.graph_captures == 0 and not eng._graphs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_translate_device_luts(seed):
    """six_frame_translate_torch with the LUTs kept as device constants
    (made once a device) equals the host path on reads of length 0-250,
    N codes and padding included."""
    rng = np.random.default_rng(seed)
    R, L = 64, 250
    dna = rng.integers(0, 5, (R, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, R).astype(np.int32)
    lens[:3] = (0, 1, L)
    for frame_len in (40, 83, 90):
        got = six_frame_translate_torch(torch.from_numpy(dna),
                                        torch.from_numpy(lens), frame_len)
        np.testing.assert_array_equal(
            got.numpy(), six_frame_translate(dna, lens, frame_len))
    dev = torch.device("cpu")
    assert all(a is b for a, b in zip(device_luts(dev), device_luts(dev)))
