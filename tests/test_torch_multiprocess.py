"""Two processes joined over TCP on the CPU (gloo), against one process and
the JAX package (the counterparts of tests/test_multihost.py), and the
multi-process pipeline's row-addressed parts, per-process cursors and
resume from the minimum cursor. Tolerance 0; every process has its own
timeout, and the process-group timeout fails a rank whose peer is gone."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.ops.encode import encode_dna
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.parallel import launch
from tools.simulate import (
    make_dataset, random_proteins, reads_from_proteins, write_fasta,
)

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", GHOSTM_TPU_DIST_TIMEOUT="120")

# One process of a (1, 2) grid across two processes: argv = coordinator,
# process id, directory. It checks its own rows against the port's
# one-process loop engine over both shards, then saves them.
WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.engine import SearchEngine
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.parallel import mesh as pm

coord, pid, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
os.environ["GHOSTM_TPU_MERGE_COLOCATED"] = "0"
cfg = Config(query_batch=8, max_hits=5)
index = load_index(f"{d}/idx")
qc = np.load(f"{d}/qcodes.npy")
ref = SearchEngine(cfg, index, device="cpu").search_batch(qc)
pm.init_distributed(coord, 2, pid)
mesh = pm.make_mesh(1, 2)
assert mesh.backend == "gloo" and mesh.db_index == pid
eng = SearchEngine(cfg, index, device="cpu", mesh=mesh)
assert len(eng.shard_dev) == 1
blocks = eng.search_batch_stats_local(qc)
assert [b[0] for b in blocks] == ([0] if pid == 0 else [])
hits, _ = eng.search_batch_stats(qc)
for f in hits.__dataclass_fields__:
    np.testing.assert_array_equal(getattr(hits, f), getattr(ref, f),
                                  err_msg=f"field {f} on process {pid}")
np.savez(f"{d}/p{pid}.npz", **{f: getattr(hits, f)
                               for f in hits.__dataclass_fields__})
print(f"process {pid}: ok", flush=True)
"""


def _run_procs(cmds, cwd=None, timeout=240):
    """Start every command, wait for all (each with its own timeout);
    returns their outputs, or fails with the first failing one's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=launch.rank_env(
                                  ENV), cwd=cwd) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        launch.kill_ranks(procs)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return outs


def test_two_process_equivalence(tmp_path, monkeypatch):
    """A (1, 2) grid across two processes: each holds one shard, and both
    return the one-process loop engine's hits; they equal the JAX loop
    engine's."""
    rng = np.random.default_rng(5)
    prots = random_proteins(rng, 24, lo=60, hi=120)
    write_fasta(str(tmp_path / "db.fa"), [f"s{i}" for i in range(24)], prots)
    assert jcli(["db", "-i", str(tmp_path / "db.fa"), "-o",
                 str(tmp_path / "idx"), "--shards", "2"]) == 0
    _, reads = reads_from_proteins(rng, prots, 8, read_len=90)
    dna = np.full((8, 90), 4, np.int8)
    lens = np.zeros(8, np.int32)
    for i, r in enumerate(reads):
        c = encode_dna(r)
        dna[i, :len(c)] = c
        lens[i] = len(c)
    monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", "0")
    jeng = jengine.SearchEngine(JConfig(query_batch=8, max_hits=5),
                                jdiskio.load_index(str(tmp_path / "idx")),
                                use_pallas=False)
    qc = jeng.translate(dna, lens)
    np.save(tmp_path / "qcodes.npy", qc)
    want = jeng.search_batch(qc)
    assert want.score.max() > 0
    coord = f"127.0.0.1:{launch.free_port()}"
    outs = _run_procs([[sys.executable, "-c", WORKER, coord, str(pid),
                        str(tmp_path)] for pid in range(2)])
    assert all("ok" in o for o in outs)
    for pid in range(2):
        got = np.load(tmp_path / f"p{pid}.npz")
        for f in got.files:
            np.testing.assert_array_equal(got[f], getattr(want, f), f)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """The JAX test's CLI dataset (30 proteins, 32 reads of 100 bp), its
    index (`db` of the port), a config of 16-read batches with per-batch
    parts, and the JAX package's table of it."""
    d = tmp_path_factory.mktemp("mp")
    db_fa, reads_fa = make_dataset(str(d / "mp"), n_proteins=30, n_reads=32,
                                   read_len=100, seed=9)
    cfgf = str(d / "cfg.json")
    with open(cfgf, "w") as f:
        json.dump({"query_batch": 16, "checkpoint_batches": 1,
                   "max_hits": 5}, f)
    prefix = str(d / "idx")
    assert tcli(["db", "-i", db_fa, "-o", prefix, "--config", cfgf]) == 0
    jout = str(d / "jax.tsv")
    assert jcli(["aln", "-d", prefix, "-i", reads_fa, "--config", cfgf,
                 "--no-pallas", "-o", jout]) == 0
    with open(jout) as f:
        want = f.read()
    assert len(want.splitlines()) > 20
    return d, prefix, reads_fa, cfgf, want


def _two_process_aln(args, out, extra=()):
    coord = f"127.0.0.1:{launch.free_port()}"
    return _run_procs([
        [sys.executable, "-m", "ghostm_tpu_torch", *args, "-o", out,
         "--cpu", "1", "--coordinator", coord, "--num-processes", "2",
         "--process-id", str(pid), *extra] for pid in range(2)], cwd=REPO)


def test_two_process_cli_run(cli_data, monkeypatch):
    """Two processes through the CLI (data axis across them): each writes
    the row-addressed parts of its row block and its own cursor, process
    0 concatenates after the barrier; the table equals the one-run grid's
    (`--cpu 2 --data-axis 2`, two local ranks), the one-process run's and
    the JAX package's, byte for byte."""
    d, prefix, reads_fa, cfgf, want = cli_data
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    base = ["aln", "-d", prefix, "-i", reads_fa, "--config", cfgf,
            "--data-axis", "2", "--db-axis", "1"]
    ref = str(d / "ref.tsv")
    assert tcli(base + ["-o", ref, "--cpu", "2"]) == 0
    one = str(d / "one.tsv")
    assert tcli(["aln", "-d", prefix, "-i", reads_fa, "--config", cfgf,
                 "--device", "cpu", "-o", one]) == 0
    out = str(d / "mp.tsv")
    _two_process_aln(base, out)
    with open(out) as f, open(ref) as g, open(one) as h:
        got = f.read()
        assert got == g.read() == h.read() == want
    parts = sorted(os.listdir(out + ".parts"))
    assert parts == ["cursor-p0.json", "cursor-p1.json",
                     "part-000000-r00000000.tsv", "part-000000-r00000008.tsv",
                     "part-000001-r00000000.tsv", "part-000001-r00000008.tsv"]
    assert sorted(os.listdir(ref + ".parts")) == [
        "cursor.json", "part-000000.tsv", "part-000001.tsv"]


def test_two_process_resume_from_min_cursor(cli_data):
    """--resume after process 1's cursor and its part of batch 1 are lost
    (a kill between the two processes' writes): both processes resume
    from the minimum cursor (1), batch 1 is searched again, and the table
    is the uninterrupted run's."""
    d, prefix, reads_fa, cfgf, want = cli_data
    base = ["aln", "-d", prefix, "-i", reads_fa, "--config", cfgf,
            "--data-axis", "2", "--db-axis", "1"]
    out = str(d / "res.tsv")
    _two_process_aln(base, out)
    parts = out + ".parts"
    os.remove(os.path.join(parts, "part-000001-r00000008.tsv"))
    with open(os.path.join(parts, "cursor-p1.json"), "w") as f:
        json.dump({"completed_batches": 1}, f)
    os.remove(out)
    logs = _two_process_aln(base, out, ["--resume"])
    for log in logs:
        assert "resuming after 1 completed batches (process cursors: " \
               "[2, 1])" in log
    with open(out) as f:
        assert f.read() == want


def test_multiprocess_run_needs_checkpoints(cli_data, tmp_path):
    """The JAX package's refusal, raised by run_search for an engine of a
    joined process group without per-batch parts (and by the CLI before
    it joins, test_torch_golden)."""
    d, prefix, reads_fa, cfgf, _ = cli_data
    code = r"""
import sys
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.engine import SearchEngine
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.io.fasta import read_batches
from ghostm_tpu_torch.parallel import mesh as pm
from ghostm_tpu_torch.pipeline import run_search
coord, pid, prefix, reads, out = sys.argv[1:6]
pm.init_distributed(coord, 2, int(pid))
eng = SearchEngine(Config(query_batch=16), load_index(prefix), device="cpu",
                   mesh=pm.make_mesh(2, 1))
try:
    run_search(eng, read_batches(reads, 16, 120), out)
except ValueError as e:
    print("refused:", e)
"""
    coord = f"127.0.0.1:{launch.free_port()}"
    outs = _run_procs([[sys.executable, "-c", code, coord, str(pid), prefix,
                        reads_fa, str(tmp_path / "x.tsv")]
                       for pid in range(2)])
    for o in outs:
        assert ("refused: multi-process runs need checkpoint_batches > 0 "
                "(per-batch row-addressed result parts)") in o
    assert not (tmp_path / "x.tsv").exists()


def test_wait_ranks_fails_fast():
    """launch.wait_ranks: a rank that exits non-zero fails the run at once
    with its code, and the ranks still running are killed."""
    procs = launch.start_ranks(
        lambda r, coord: [sys.executable, "-c",
                          "import sys, time; time.sleep(60) if "
                          f"{r} == 0 else sys.exit(3)"], 2)
    t0 = time.time()
    assert launch.wait_ranks(procs, timeout=60) == 3
    assert time.time() - t0 < 30
    assert all(p.poll() is not None for p in procs)


def test_peer_death_fails_rank_0(cli_data, tmp_path):
    """Two processes through the CLI; process 1 is SIGKILLed once the first
    parts land. Process 0 must exit non-zero (its next collective fails),
    and no final table is written; both rerun with --resume write the
    uninterrupted run's bytes."""
    _, prefix, reads_fa, cfgf, want = cli_data
    out = str(tmp_path / "x.tsv")
    args = ["aln", "-d", prefix, "-i", reads_fa, "--config", cfgf,
            "--data-axis", "2", "--db-axis", "1", "--batch", "8"]
    coord = f"127.0.0.1:{launch.free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ghostm_tpu_torch", *args, "-o", out, "--cpu",
         "1", "--coordinator", coord, "--num-processes", "2", "--process-id",
         str(pid)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env=launch.rank_env(ENV), cwd=REPO) for pid in range(2)]
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not (
                os.path.isdir(out + ".parts") and any(
                    p.startswith("part-")
                    for p in os.listdir(out + ".parts"))):
            time.sleep(0.01)
        procs[1].kill()
        _, err = procs[0].communicate(timeout=150)
    finally:
        launch.kill_ranks(procs)
    assert procs[0].returncode != 0, err.decode()[-2000:]
    assert not os.path.exists(out)
    for log in _two_process_aln(args, out, ["--resume"]):
        assert "resuming after" in log
    with open(out) as f:
        assert f.read() == want
