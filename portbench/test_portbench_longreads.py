"""The long-read simulator: deterministic from its seeds, genes that are
what they claim to be, lengths, padding and error rates as the mix states,
and a pool that picks its simulator by the mix's `reads`."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import longreads, run, simulate

HERE = Path(__file__).resolve().parent
CFG = json.loads((HERE / "configs" / "swissprot_k5.json").read_text())
# the HiFi model's numbers (longreads' docstring), the reads cut to 1-3 kbp
HIFI = dict(reads="genomes", max_read_len=3000, read_len_min=1000,
            read_len_max=3000, len_median=2000, len_sigma=0.25,
            homolog_share=0.5, zipf_s=1.0, abundance_seed=11, spacer_min=50,
            spacer_max=200, sub_rate=0.001, ins_rate=0.0005, del_rate=0.0005)
EXACT = dict(HIFI, sub_rate=0.0, ins_rate=0.0, del_rate=0.0)
# (4, 4, 4) codon -> amino-acid code, -1 for a stop
CODON = np.full((4, 4, 4), -1, np.int64)
for _c, _a in simulate._CODON_TABLE.items():
    if _a != "*":
        CODON[tuple("ACGT".index(b) for b in _c)] = \
            simulate.AA_ALPHABET.index(_a)


def small_db(n=500):
    spec = dict(CFG["database"], groups=[dict(name="a", n=n, lo=250,
                                              hi=451)])
    return simulate.database(spec)


def make(seed, n, mix, db=None):
    codes, lens = db or small_db()
    return longreads.reads(simulate.rng_for(seed), codes, lens, n, mix)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -3])
def test_reads_are_deterministic(seed):
    a, b, c = (make(s, 64, HIFI) for s in (seed, seed, seed + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert all(np.array_equal(a[3][k], b[3][k]) for k in a[3])
    assert not np.array_equal(a[0], c[0])


def test_abundance_is_the_mixs_not_the_seeds():
    tops = []
    for seed, abundance in ((1, 11), (2 ** 31 + 1, 11), (1, 12)):
        lay = make(seed, 400, dict(HIFI, abundance_seed=abundance))[3]
        src = lay["source"][lay["source"] >= 0]
        tops.append(set(np.argsort(np.bincount(src, minlength=500))[-3:]))
    assert tops[0] == tops[1] and tops[0] != tops[2]


def test_genes_translate_to_their_source():
    """Without errors, each homologous gene read on its strand and frame
    gives its protein's residues wherever a whole codon of it lies inside
    the read; the genes are laid end to end across the read."""
    codes, lens = small_db()
    dna, rl, src, lay = make(7, 48, EXACT, (codes, lens))
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    checked = 0
    for r, s, strand, a, e in zip(lay["read"], lay["source"], lay["strand"],
                                  lay["start"], lay["end"]):
        assert a < rl[r] and e > 0 and (e - a) % 3 == 0
        if s < 0:
            continue
        assert e - a == 3 * lens[s]
        prot = codes[first[s]:first[s] + lens[s]]
        k = np.arange(lens[s])
        # codon k's bases in read order: plus a + 3k + (0, 1, 2); minus
        # the complement of e - 1 - 3k - (0, 1, 2)
        cols = (a + 3 * k[:, None] + np.arange(3) if strand > 0
                else e - 1 - 3 * k[:, None] - np.arange(3))
        whole = (cols.min(1) >= 0) & (cols.max(1) < rl[r])
        b = dna[r, cols[whole]]
        if strand < 0:
            b = 3 - b
        assert np.array_equal(CODON[b[:, 0], b[:, 1], b[:, 2]], prot[whole])
        checked += int(whole.sum())
    assert checked > 10_000
    assert set(lay["strand"]) == {-1, 1}
    for r in range(48):
        mine = lay["read"] == r
        st, en = lay["start"][mine], lay["end"][mine]
        gap = st[1:] - en[:-1]
        assert st[0] <= 0 and en[-1] > 0 and (gap >= 50).all() \
            and (gap <= 200).all()
        first_h = lay["source"][mine][lay["source"][mine] >= 0]
        assert src[r] == (first_h[0] if len(first_h) else -1)


def test_lengths_padding_rates_and_share():
    dna, rl, _, lay = make(11, 600, HIFI)
    assert rl.min() >= 1000 and rl.max() <= 3000
    pos = np.arange(dna.shape[1])[None, :]
    assert (dna[pos >= rl[:, None]] == 4).all()
    assert (dna[pos < rl[:, None]] < 4).all()
    bases = int(rl.sum())
    for k, rate in (("subs", "sub_rate"), ("ins", "ins_rate"),
                    ("dels", "del_rate")):
        want = HIFI[rate] * bases
        assert abs(lay[k].sum() - want) < 5 * np.sqrt(want), k
    share = (lay["source"] >= 0).mean()
    assert abs(share - 0.5) < 5 * np.sqrt(0.25 / len(lay["source"]))


def test_read_lengths_follow_the_log_normal():
    mix = dict(HIFI, read_len_min=1, read_len_max=10 ** 9, len_median=5000,
               len_sigma=0.3)
    x = longreads.read_lengths(simulate.rng_for(2), 20_000, mix)
    assert abs(np.median(x) / 5000 - 1) < 0.02
    assert abs(np.log(x).std() - 0.3) < 0.01
    cut = longreads.read_lengths(simulate.rng_for(2), 2000, HIFI)
    assert cut.min() >= 1000 and cut.max() <= 3000


@pytest.mark.parametrize("kind", ["sub_rate", "ins_rate", "del_rate"])
def test_errors_follow_the_position_map(kind):
    """Each stretch base lands where the map says, changed only where it was
    substituted; insertions put one base between two stretch bases and
    deletions leave a base out."""
    n, width = 40, 2400
    rng = simulate.rng_for(3)
    stretch = rng.integers(0, 4, (n, width), dtype=np.int8)
    rl = rng.integers(1500, 2001, n)
    need = rl + 300
    mix = dict(EXACT, max_read_len=2100, **{kind: 0.02})
    out, pos, counts = longreads.errors(simulate.rng_for(4), stretch, need,
                                        rl, mix)
    exact, pos0, _ = longreads.errors(simulate.rng_for(4), stretch, need, rl,
                                      dict(mix, **{kind: 0.0}))
    assert np.array_equal(pos0[:, :width], np.broadcast_to(np.arange(width),
                                                           (n, width)))
    assert all(np.array_equal(exact[r, :rl[r]], stretch[r, :rl[r]])
               for r in range(n))
    for r in range(n):
        p = pos[r, :-1]
        step = np.diff(pos[r])
        live = p < rl[r]
        kept = live & (step > 0)
        changed = out[r, p[kept]] != stretch[r, kept]
        assert changed.sum() == counts["subs"][r]
        assert (step[live] == 0).sum() == counts["dels"][r]
        assert (step[live & (p + 1 < rl[r])] == 2).sum() == counts["ins"][r]
        assert (out[r, :rl[r]] < 4).all() and (out[r, rl[r]:] == 4).all()
    k = {"sub_rate": "subs", "ins_rate": "ins", "del_rate": "dels"}[kind]
    want = 0.02 * rl.sum()
    assert abs(counts[k].sum() - want) < 5 * np.sqrt(want)
    assert all(counts[o].sum() == 0 for o in ("subs", "ins", "dels")
               if o != k)


def test_make_pool_picks_the_simulator_by_the_mix(short_cell):
    """reads100 (no `reads`) is simulate.reads' pool, byte for byte; a
    `genomes` mix is longreads.reads'."""
    codes, lens = small_db(n=3000)
    t = short_cell.traffic
    n = t["pool_batches"] * t["batch"]
    pool = run.make_pool(short_cell, codes, lens, 2 ** 31 + 9)
    dna, rl, _ = simulate.reads(simulate.rng_for(2 ** 31 + 9), codes, lens,
                                n, t)
    assert "reads" not in t
    assert np.concatenate([p[1] for p in pool]).tobytes() == dna.tobytes()
    assert np.concatenate([p[2] for p in pool]).tobytes() == rl.tobytes()
    short_cell.traffic = dict(t, **HIFI)
    pool = run.make_pool(short_cell, codes, lens, 5)
    dna, rl = longreads.reads(simulate.rng_for(5), codes, lens, n,
                              short_cell.traffic)[:2]
    assert np.concatenate([p[1] for p in pool]).tobytes() == dna.tobytes()
    assert np.concatenate([p[2] for p in pool]).tobytes() == rl.tobytes()
    short_cell.traffic = dict(t, reads="genome")
    with pytest.raises(KeyError):
        run.make_pool(short_cell, codes, lens, 5)
