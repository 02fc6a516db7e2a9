"""The harness's check against faults planted under the timed path: each
turns `correct` false. The harness's look for a chip is skipped (the
port's CPU engine runs the window); the rest of a run is as on the card."""

import pytest

from portbench import run


def half_batch_left_out(engine):
    step = engine.search_refine_async_dna

    def broken(dna, lens):
        out = step(dna, lens).clone()
        out[:, : out.shape[1] // 2] = 0
        return out
    engine.search_refine_async_dna = broken


def answer_altered(engine):
    step = engine.search_refine_async_dna

    def broken(dna, lens):
        out = step(dna, lens).clone()
        assert out.shape[0] == 6          # the packed transport
        out[1, :, 0] += 1 << 15           # every read's top score + 1
        return out
    engine.search_refine_async_dna = broken


def state_unchanged(engine):
    import numpy as np

    step = engine.search_refine_async_dna
    B, W = engine.cfg.query_batch, 120
    rng = np.random.default_rng(0)
    stale = step(rng.integers(0, 4, (B, W)).astype(np.int8),
                 np.full(B, 100, np.int32))

    def broken(dna, lens):
        return stale                      # every batch: one old answer
    engine.search_refine_async_dna = broken


def batch_raises(engine):
    step = engine.search_refine_async_dna
    n = [0]

    def broken(dna, lens):
        n[0] += 1
        if n[0] == 1:                     # the window's first batch
            raise RuntimeError("planted")
        return step(dna, lens)
    engine.search_refine_async_dna = broken


def shard_left_out(engine):
    """The per-shard loop without its second shard: the proposals, the
    alignments and the rank over the first shard's subjects alone."""
    assert len(engine.shard_dev) == 2
    engine.shard_dev = engine.shard_dev[:1]


@pytest.mark.parametrize("fault", [half_batch_left_out, answer_altered,
                                   state_unchanged, batch_raises])
def test_fault_is_not_correct(short_cell, fault):
    res = run.run_cell(short_cell, 99, 1.5, False, device="cpu",
                       engine_hook=fault)
    res.pop("_records")
    assert not res["correct"], res


def test_sound_run_is_correct(short_cell):
    res = run.run_cell(short_cell, 99, 1.5, False, device="cpu")
    res.pop("_records")
    assert res["correct"], res


@pytest.mark.parametrize("fault", [half_batch_left_out, answer_altered,
                                   state_unchanged, shard_left_out])
def test_fault_is_not_correct_on_two_shards(full_loop_cell, fault):
    res = run.run_cell(full_loop_cell, 98, 1.5, False, device="cpu",
                       engine_hook=fault)
    res.pop("_records")
    assert not res["correct"], res
