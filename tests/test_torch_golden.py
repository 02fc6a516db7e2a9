"""The port's CLI reproduces the committed config-1 goldens (BLOSUM62 and
BLOSUM50) byte for byte on the CPU (plain versions of the kernels), from an
index built by either package; what is not ported yet fails with a clear
error."""

import os

import pytest
import torch

from ghostm_tpu.cli import main as jcli
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
    ["--coordinator", "h:1"], ["--data-axis", "2"], ["--num-processes", "2"],
    ["--db-axis", "2"], ["--cpu", "2"],
])
def test_cli_rejects_unported_flags(tmp_path, capsys, flags):
    with pytest.raises(SystemExit) as e:
        tcli(["aln", "-d", "x", "-i", READS, "-o", str(tmp_path / "h"),
              "--device", "cpu", *flags])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err
