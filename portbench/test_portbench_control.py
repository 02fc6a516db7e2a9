"""The control: the reference put in the program's place with its DP held
to 8 bits (saturating at 127, the striped 8-bit pass without its wider
recompute) has to come out not correct through a run's own comparison; a
16-bit DP holds every score of the cell (at most 11 x Lq = 440 at
40-residue frames) and would be no control.

On the card, at the cell's own size and on three seeds:

    python3 -m pytest portbench/test_portbench_control.py -m cuda -s
"""

import json

import pytest

from portbench import check, dbcache, run, spec


def test_control_run_is_not_correct(short_cell):
    res = run.run_cell(short_cell, 2 ** 31 + 9, 1.0, False, device="cpu",
                       control=True)
    res.pop("_records")
    assert not res["correct"], res
    assert res["checks"]["reads_differ"]["value"] > run.LIMITS[
        "reads_differ"]


def test_sixteen_bits_are_no_control(short_cell):
    _, codes, lens, _ = dbcache.ensure(short_cell, run.ROOT)
    pool = run.make_pool(short_cell, codes, lens, 5)
    seq = list(range(short_cell.traffic["pool_batches"]))
    wanted = check.sample(5, len(seq), short_cell.traffic["batch"],
                          short_cell.traffic["check_reads"])
    cfg = short_cell.search_config()
    want = check.reference_rows(pool, wanted, seq, codes, lens, cfg, "cpu")
    wide = check.reference_rows(pool, wanted, seq, codes, lens, cfg, "cpu",
                                saturate=32767)
    assert check.compare(wide, want)["reads_differ"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2001, 2002, 2003])
def test_control_at_the_cells_size(cuda, seed):
    for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())[
            "workloads"]:
        cell = spec.Cell(run.ROOT / "BENCHMARK.json", w["name"])
        res = run.run_cell(cell, seed, 5.0, False, control=True)
        res.pop("_records")
        print(json.dumps(dict(control=cell.name, seed=seed,
                              correct=res["correct"],
                              checks=res["checks"])), flush=True)
        assert not res["correct"], res
