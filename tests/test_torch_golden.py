"""The port's CLI reproduces the committed config-1 goldens (BLOSUM62 and
BLOSUM50) byte for byte on the CPU (plain versions of the kernels), from an
index built by either package; the distributed flags run or refuse as
the JAX CLI does."""

import os

import jax
import pytest
import torch

from ghostm_tpu import engine as jengine
from ghostm_tpu.cli import main as jcli
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.index import diskio as jdiskio
from ghostm_tpu.parallel.mesh import make_mesh as jmake_mesh
from ghostm_tpu_torch.cli import main as tcli

# One intra-op thread: the suite runs several pytest workers at once and
# torch's spinning OpenMP threads would oversubscribe the cores.
torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
DB = os.path.join(GOLD, "config1_db.fa")
READS = os.path.join(GOLD, "config1_reads.fa")


@pytest.mark.parametrize("db_pkg", ["ghostm_tpu_torch", "ghostm_tpu"])
def test_config1_golden_cpu(tmp_path, db_pkg):
    prefix = str(tmp_path / "idx")
    out = str(tmp_path / "hits.tsv")
    db = tcli if db_pkg == "ghostm_tpu_torch" else jcli
    assert db(["db", "-i", DB, "-o", prefix]) == 0
    assert tcli(["aln", "-d", prefix, "-i", READS, "-o", out, "--device",
                 "cpu", "--no-pallas", "--batch", "128"]) == 0
    with open(out) as f, open(os.path.join(GOLD, "config1_hits.tsv")) as g:
        assert f.read() == g.read(), "port's config-1 hit table differs"


@pytest.mark.parametrize("db_pkg", ["ghostm_tpu_torch", "ghostm_tpu"])
def test_config1_blosum50_golden_cpu(tmp_path, db_pkg):
    """BLOSUM50 / gap 13,2 is outside the fused kernel's nibble range: the
    score-fed path (B5 by rows at 40-residue frames) must reproduce the
    committed BLOSUM50 golden."""
    prefix = str(tmp_path / "idx")
    out = str(tmp_path / "hits.tsv")
    db = tcli if db_pkg == "ghostm_tpu_torch" else jcli
    assert db(["db", "-i", DB, "-o", prefix]) == 0
    assert tcli(["aln", "-d", prefix, "-i", READS, "-o", out, "--device",
                 "cpu", "--batch", "128", "--matrix", "BLOSUM50",
                 "--gap-open", "13", "--gap-extend", "2"]) == 0
    with open(out) as f, open(os.path.join(GOLD,
                                           "config1_b50_hits.tsv")) as g:
        assert f.read() == g.read(), "port's BLOSUM50 hit table differs"


@pytest.mark.parametrize("flags", [
    ["--coordinator", "h:1"], ["--data-axis", "2", "--cpu", "1"],
    ["--num-processes", "2", "--process-id", "0", "--coordinator",
     "127.0.0.1:9"],
    ["--db-axis", "2", "--cpu", "2"], ["--cpu", "2"],
])
def test_cli_rejects_unported_flags(tmp_path, flags):
    """The distributed flags do what the JAX CLI does with them: a
    coordinator without --num-processes is ignored and `--cpu 2` alone
    runs on the CPU (both write the golden); a grid larger than --cpu
    allows, and a db axis that is not the index's shard count, raise the
    JAX package's ValueError; --num-processes 2 without per-batch parts
    raises its message before joining any peer."""
    prefix = str(tmp_path / "idx")
    assert tcli(["db", "-i", DB, "-o", prefix]) == 0
    out = str(tmp_path / "h.tsv")
    args = ["aln", "-d", prefix, "-i", READS, "-o", out, "--device", "cpu",
            "--batch", "128", *flags]
    if flags[0] in ("--coordinator", "--cpu"):
        assert tcli(args) == 0
        with open(out) as f, open(os.path.join(GOLD,
                                               "config1_hits.tsv")) as g:
            assert f.read() == g.read()
        return
    if flags[0] == "--data-axis":
        with pytest.raises(ValueError) as want:
            jmake_mesh(2, 1, jax.devices()[:1])
    elif flags[0] == "--db-axis":
        with pytest.raises(ValueError) as want:
            jengine.SearchEngine(JConfig(query_batch=128),
                                 jdiskio.load_index(prefix), use_pallas=False,
                                 mesh=jmake_mesh(1, 2))
    with pytest.raises(ValueError) as got:
        tcli(args)
    if flags[0] == "--num-processes":
        assert str(got.value) == ("multi-process runs need checkpoint_batches"
                                  " > 0 (per-batch row-addressed result "
                                  "parts)")
    else:
        assert str(got.value) == str(want.value)
    assert not os.path.exists(out)
