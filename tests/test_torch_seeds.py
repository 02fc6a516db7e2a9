"""The port's seed-bucket truncation (index/seeds.py: bucket_keep, then
buffer_keep into each shard's buffer) against the JAX package's
global_bucket_truncation, and the index `db` writes through each
package's CLI, shard by shard. Tolerance 0: the kept positions and the
written arrays are equal."""

import json
import os

import numpy as np
import pytest

from ghostm_tpu.cli import main as jcli
from ghostm_tpu.index import seeds as jseeds
from ghostm_tpu_torch.cli import main as tcli
from ghostm_tpu_torch.index import seeds as tseeds

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("k,cap", [(2, 5), (3, 2), (4, 1)])
def test_bucket_keep_equals_jax(k, cap):
    """Subjects of 0 to 60 residues (some shorter than k), codes 0-23 (the
    ones >= 20 never seed); a few repeated subjects fill buckets."""
    rng = np.random.default_rng(k * 10 + cap)
    seqs = [rng.integers(0, 24, int(n)).astype(np.int8)
            for n in rng.integers(0, 61, 200)]
    seqs += [seqs[3]] * 6
    want = jseeds.global_bucket_truncation(seqs, k, cap)
    lens = np.array([len(s) for s in seqs], np.int64)
    keep = tseeds.bucket_keep(np.concatenate(seqs), lens, k, cap)
    np.testing.assert_array_equal(keep, np.concatenate(want))
    # a store of every other subject, each after 2 sentinel codes
    ids = np.arange(0, len(seqs), 2)
    starts = np.cumsum(lens[ids] + 2) - lens[ids]
    size = int(starts[-1] + lens[ids][-1] + 2)
    ref = np.zeros(size, bool)
    for r, gi in enumerate(ids):
        ref[starts[r]:starts[r] + len(want[gi])] = want[gi]
    np.testing.assert_array_equal(
        tseeds.buffer_keep(keep, lens, k, ids, starts, size), ref)


@pytest.mark.parametrize("shards", [1, 3])
def test_db_index_equals_jax(tmp_path, shards):
    """config-1's subjects at k = 3 and 2 positions a bucket (the cap
    bites), built by both CLIs: every shard's arrays are equal."""
    cfgf = str(tmp_path / "cfg.json")
    with open(cfgf, "w") as f:
        json.dump({"seed_len": 3, "hits_per_seed": 2}, f)
    args = ["db", "-i", os.path.join(GOLD, "config1_db.fa"), "--config",
            cfgf, "--shards", str(shards)]
    assert tcli([*args, "-o", str(tmp_path / "t")]) == 0
    assert jcli([*args, "-o", str(tmp_path / "j")]) == 0
    for i in range(shards):
        t = np.load(tmp_path / f"t.shard{i}.npz", allow_pickle=True)
        j = np.load(tmp_path / f"j.shard{i}.npz", allow_pickle=True)
        for name in ("buffer", "starts", "subject_ids", "positions",
                     "bucket_starts"):
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)
