"""Fault injection and the --check debug mode of the port, against the JAX
package (the port of tests/test_faultinject.py).

Fault injection: `python -m ghostm_tpu_torch aln` with per-batch
checkpointing over a 2-shard index runs as a subprocess in a session of
its own, is SIGKILLed mid-run with its whole process group (after at least
one part file lands, before the last), restarts with --resume, and must
write the bytes of the JAX package's run on the same data: on the CPU
with the per-shard loop (GHOSTM_TPU_MERGE_COLOCATED=0), and as the JAX
test runs it, `--cpu 2 --db-axis 2` (two local ranks, a shard each).

--check: clean data passes and writes the table of a run without it (the
config-1 golden). Corrupted seed tables go to the JAX package's
search_batch_checked (checkify) and to the port's on the same frames: both
raise, or both pass with equal hits; residue codes outside the 32-letter
code space are refused by the port (fault F5). Tolerance 0."""

import json
import os
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.io.fasta import read_batches
from ghostm_tpu_torch import engine as tengine
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.config import Config as TConfig
from ghostm_tpu_torch.index import diskio as tdiskio
from tools.simulate import make_dataset

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden")


@pytest.fixture(scope="module")
def fi(tmp_path_factory):
    """The JAX test's data (40 proteins, 192 reads of 100 bp), 16-read
    batches with per-batch parts, its 2-shard index (`db` of the port) and
    the JAX package's table of it (the per-shard loop)."""
    d = tmp_path_factory.mktemp("fi")
    db_fa, reads_fa = make_dataset(
        str(d / "fi"), n_proteins=40, n_reads=192, read_len=100,
        seed=3,
    )
    cfgf = str(d / "cfg.json")
    with open(cfgf, "w") as f:
        json.dump({"query_batch": 16, "checkpoint_batches": 1,
                   "max_hits": 5}, f)
    prefix = str(d / "idx")
    assert tcli(["db", "-i", db_fa, "-o", prefix, "--shards", "2",
                 "--config", cfgf]) == 0
    args = ["aln", "-d", prefix, "-i", reads_fa, "--config", cfgf]
    jax_out = str(d / "jax.tsv")
    os.environ["GHOSTM_TPU_MERGE_COLOCATED"] = "0"
    try:
        assert jcli(args + ["--no-pallas", "-o", jax_out]) == 0
    finally:
        del os.environ["GHOSTM_TPU_MERGE_COLOCATED"]
    with open(jax_out) as f:
        want = f.read()
    n_parts = len([p for p in os.listdir(jax_out + ".parts")
                   if p.startswith("part-")])
    assert n_parts == 12
    return args, want


def _kill_mid_run_then_resume(cmd, out, n_parts_total, env):
    """Start `cmd` in a session of its own, SIGKILL its whole process
    group once >= 1 part file exists and < all do, then rerun it with
    --resume; returns the resumed run's stderr."""
    parts = out + ".parts"
    proc = subprocess.Popen(cmd, cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                            start_new_session=True)
    killed = False
    deadline = time.time() + 60
    try:
        while time.time() < deadline and proc.poll() is None:
            if os.path.isdir(parts):
                done = [p for p in os.listdir(parts)
                        if p.startswith("part-") and p.endswith(".tsv")]
                if 1 <= len(done) < n_parts_total:
                    os.killpg(proc.pid, signal.SIGKILL)
                    killed = True
                    break
            time.sleep(0.01)
    finally:
        if proc.poll() is None and not killed:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    assert killed, "never reached the kill window"
    survivors = [p for p in os.listdir(parts) if p.startswith("part-")]
    assert 0 < len(survivors) < n_parts_total

    # restart with --resume: must complete (its own timeout)
    r = subprocess.run(cmd + ["--resume"], cwd=REPO, env=env,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert b"resuming after" in r.stderr
    return r.stderr


def test_kill_worker_mid_run_then_resume(fi, tmp_path, monkeypatch):
    """The per-shard loop (one process): killed, resumed, the bytes of an
    uninterrupted port run and of the JAX package's."""
    args, want = fi
    monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", "0")
    ref_out = str(tmp_path / "ref.tsv")
    assert tcli(args + ["--device", "cpu", "-o", ref_out]) == 0
    with open(ref_out) as f:
        assert f.read() == want
    out = str(tmp_path / "hits.tsv")
    cmd = [sys.executable, "-m", "ghostm_tpu_torch"] + args + [
        "--device", "cpu", "-o", out]
    _kill_mid_run_then_resume(cmd, out, 12,
                              dict(os.environ, OMP_NUM_THREADS="1"))
    with open(out) as f:
        assert f.read() == want


def test_kill_grid_mid_run_then_resume(fi, tmp_path):
    """The JAX test's own case: `--cpu 2 --data-axis 1 --db-axis 2` (two
    local ranks, a shard each, rank 0 writing the parts), its whole
    process group killed mid-run, then --resume: the bytes of the JAX
    package's run. A rank's collectives time out after 60 s, so no run
    can hang on a dead peer."""
    args, want = fi
    out = str(tmp_path / "hits.tsv")
    cmd = [sys.executable, "-m", "ghostm_tpu_torch"] + args + [
        "--cpu", "2", "--data-axis", "1", "--db-axis", "2", "-o", out]
    env = dict(os.environ, OMP_NUM_THREADS="1", GHOSTM_TPU_DIST_TIMEOUT="60")
    err = _kill_mid_run_then_resume(cmd, out, 12, env)
    assert b"grid (1x2) rank 1" in err
    with open(out) as f:
        assert f.read() == want


def test_check_mode_clean_golden(tmp_path):
    """--check raises nothing on the config-1 golden and writes its table,
    as the run without it does."""
    prefix = str(tmp_path / "idx")
    assert tcli(["db", "-i", os.path.join(GOLD, "config1_db.fa"), "-o",
                 prefix]) == 0
    base = ["aln", "-d", prefix, "-i", os.path.join(GOLD,
                                                    "config1_reads.fa"),
            "--device", "cpu", "--batch", "128"]
    out1, out2 = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    assert tcli(base + ["-o", out1]) == 0
    assert tcli(base + ["-o", out2, "--check"]) == 0
    with open(out1) as f, open(out2) as g, \
            open(os.path.join(GOLD, "config1_hits.tsv")) as h:
        a = f.read()
        assert a == g.read() == h.read()


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 40-protein index (k = 3) and 16 reads' host-translated frames."""
    d = tmp_path_factory.mktemp("ck")
    db_fa, reads_fa = make_dataset(str(d / "ck"), n_proteins=40,
                                   n_reads=16, read_len=100, seed=4)
    prefix = str(d / "idx")
    assert jcli(["db", "-i", db_fa, "-o", prefix]) == 0
    _, dna, lens = next(read_batches(reads_fa, 16, 120))
    return prefix, dna, lens


# (table mode, the array corrupted, the corruption, the port's raise site
# where both raise)
CORRUPT = {
    "clean": ("direct", None, None, None),
    # packed values past every subject row: the vote clamps the row
    "direct_entry_past_rows": (
        "direct", "tab_main",
        lambda t: np.where(t < tengine.DIRECT_SENT,
                           np.int32(tengine.DIRECT_SENT - 1), t), None),
    # a direct table short of half its rows: unclamped row gathers
    "direct_table_short": (
        "direct", "tab_main", lambda t: t[:len(t) // 2].copy(),
        "propose: direct table row"),
    # seed positions past the buffer (subject-local offsets)
    "csr_position_past_buffer": (
        "csr", "tab_aux", lambda t: (t + (1 << 20)).astype(np.int32), None),
    # bucket bounds out of order: the CSR index is clamped
    "csr_bucket_starts": (
        "csr", "bucket_starts", lambda t: t[::-1].copy(), None),
}


@pytest.mark.parametrize("case", list(CORRUPT))
def test_check_raises_where_jax_raises(small, monkeypatch, case):
    """The same corrupted seed tables in the JAX engine (checkify over its
    XLA phases) and in the port's (the step's route with bounds
    asserts): both raise, or both pass and give the same hits."""
    mode, key, corrupt, site = CORRUPT[case]
    prefix, dna, lens = small
    if mode == "csr":
        for mod in (jengine, tengine):
            monkeypatch.setattr(mod, "_packed_value_bound",
                                lambda *a: 1 << 40)
    jeng = jengine.SearchEngine(JConfig(query_batch=16),
                                jdiskio.load_index(prefix), use_pallas=False)
    teng = tengine.SearchEngine(TConfig(query_batch=16),
                                tdiskio.load_index(prefix), device="cpu")
    assert jeng.table_mode == teng.table_mode == mode
    if key is not None:
        for d, to in ((jeng.shard_dev[0], jnp.asarray),
                      (teng.shard_dev[0], torch.from_numpy)):
            d[key] = to(corrupt(np.asarray(d[key])))
    q = jeng.translate(dna, lens)
    np.testing.assert_array_equal(q, teng.translate(dna, lens))
    try:
        want, jerr = jeng.search_batch_checked(q), None
    except checkify.JaxRuntimeError as e:
        want, jerr = None, e
    try:
        got, terr = teng.search_batch_checked(q), None
    except IndexError as e:
        got, terr = None, e
    assert (jerr is not None) == (site is not None), jerr
    assert (terr is not None) == (site is not None), terr
    if site is not None:
        assert "out-of-bounds" in str(jerr) or "out of bounds" in str(jerr)
        assert site in str(terr)
        return
    for f in ("score", "gsid", "frame", "qend", "s_end", "bend", "g0",
              "srow", "shard"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    if case == "clean":
        assert got.score.max() > 0, "no hits: the comparison is vacuous"
        step = teng.search_packed(torch.from_numpy(q)).numpy()
        np.testing.assert_array_equal(step[0], got.score)


@pytest.mark.parametrize("bad", [100, -7, 32])
def test_codes_outside_the_alphabet_refused(small, bad):
    """Fault F5: a residue code outside [0, 32) indexes past the port's
    score tables (the JAX package's one-hot contractions score it 0 and
    pass --check). The port refuses it: in the frames search_batch_checked
    gets, and in an index buffer at engine init."""
    import dataclasses

    prefix, dna, lens = small
    jeng = jengine.SearchEngine(JConfig(query_batch=16),
                                jdiskio.load_index(prefix), use_pallas=False)
    tidx = tdiskio.load_index(prefix)
    teng = tengine.SearchEngine(TConfig(query_batch=16), tidx, device="cpu")
    q = jeng.translate(dna, lens)
    q[:, :, 5] = np.int8(bad)
    assert jeng.search_batch_checked(q).score.shape == (16, 10)
    with pytest.raises(ValueError, match=r"qcodes holds residue codes"):
        teng.search_batch_checked(q)
    buffers = tidx.buffers.copy()
    buffers[0, 40] = np.int8(bad)
    with pytest.raises(ValueError, match=r"index buffer holds residue"):
        tengine.SearchEngine(TConfig(query_batch=16),
                             dataclasses.replace(tidx, buffers=buffers),
                             device="cpu")
