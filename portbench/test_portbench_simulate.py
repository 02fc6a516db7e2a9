"""The frozen simulator: deterministic from its seeds, the stated residue
composition, and reads that are what they claim to be."""

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

from portbench import reference, simulate

HERE = Path(__file__).resolve().parent
CFG = json.loads((HERE / "configs" / "swissprot_k5.json").read_text())
MIX = json.loads((HERE / "traffic" / "reads100.json").read_text())


def small_db(seed=7, n=500):
    spec = dict(CFG["database"], seed=seed,
                groups=[dict(name="a", n=n, lo=250, hi=451)])
    return simulate.database(spec)


def test_database_is_deterministic():
    a, b, c = small_db(), small_db(), small_db(seed=8)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[1], c[1])
    assert a[1].min() >= 250 and a[1].max() <= 450
    assert a[0].min() >= 0 and a[0].max() < 20 and len(a[0]) == a[1].sum()


def test_composition_within_sampling_error():
    codes, _ = small_db(n=4000)
    comp = CFG["database"]["composition"]
    p = np.array([comp[a] for a in simulate.AA_ALPHABET[:20]])
    p = p / p.sum()
    got = np.bincount(codes, minlength=20) / len(codes)
    se = np.sqrt(p * (1 - p) / len(codes))
    assert (np.abs(got - p) < 5 * se + 2 ** -16).all()


def family_db(seed=7, n=3000):
    g = dict(CFG["database"]["groups"][0], n=n)
    g["families"] = dict(g["families"], size_max=60)
    return simulate.database(dict(CFG["database"], seed=seed, groups=[g]))


def test_family_sizes_sum_and_follow_the_power_law():
    sz = simulate.family_sizes(simulate.rng_for(1), 100_000, 2.0, 1000)
    assert sz.sum() == 100_000 and sz.min() >= 1 and sz.max() <= 1000
    # P(1) / P(2) = 2^2 for every family but the cut last one
    ratio = (sz == 1).sum() / (sz == 2).sum()
    assert 3.6 < ratio < 4.4


def test_families_are_deterministic_and_diverge_as_stated():
    a, b, c = family_db(), family_db(), family_db(seed=8)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0][:1000], c[0][:1000])
    codes, lens = a
    assert len(codes) == lens.sum() and len(lens) == 3000
    assert lens.min() >= 250 and lens.max() <= 450
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    # proteins of one length are mostly of one family: the closest
    # other protein of a length shares 36-100% (the members' 0-40%
    # redrawn, ~6% equal by chance), an unrelated one ~6%
    same = []
    for L in np.unique(lens)[:40]:
        ids = np.nonzero(lens == L)[0]
        if len(ids) < 2:
            continue
        seqs = np.stack([codes[first[i]:first[i] + L] for i in ids])
        ident = (seqs[:, None, :] == seqs[None, :, :]).mean(-1)
        np.fill_diagonal(ident, 0)
        same.append(ident.max(1))
    best = np.concatenate(same)
    assert best.max() <= 1.0 and np.median(best) > 0.36
    assert ((best > 0.15) | (best < 0.12)).all()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -3])
def test_reads_are_deterministic(seed):
    codes, lens = small_db()
    a = simulate.reads(simulate.rng_for(seed), codes, lens, 256, MIX)
    b = simulate.reads(simulate.rng_for(seed), codes, lens, 256, MIX)
    c = simulate.reads(simulate.rng_for(seed + 1), codes, lens, 256, MIX)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_homologous_reads_translate_to_their_source():
    codes, lens = small_db()
    mix = dict(MIX, sub_rate=0.0, homolog_share=1.0)
    dna, rl, src = simulate.reads(simulate.rng_for(1), codes, lens, 64, mix)
    assert (rl == 100).all() and (dna[:, 100:] == 4).all()
    frames = reference.six_frames(dna, rl, 40)
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for r in range(64):
        prot = codes[first[src[r]]:first[src[r]] + lens[src[r]]].tobytes()
        # the 33-residue window is frame 0, or frame 3 (the reverse
        # complement's first) where the read was reverse-complemented
        assert any(frames[r, f, :33].tobytes() in prot for f in (0, 3))


def test_abundance_is_the_mixs_not_the_seeds():
    codes, lens = small_db()
    mix = dict(MIX, homolog_share=1.0)
    tops = []
    for seed in (1, 2 ** 31 + 1):
        src = simulate.reads(simulate.rng_for(seed), codes, lens, 4000,
                             mix)[2]
        tops.append(np.argsort(np.bincount(src, minlength=500))[-3:])
    assert np.array_equal(tops[0], tops[1])


def test_zipf_skews_towards_few_proteins():
    picks = simulate.zipf_pick(simulate.rng_for(3), 1000, 20000, 1.0)
    counts = np.sort(np.bincount(picks, minlength=1000))[::-1]
    assert counts[0] > 10 * np.median(counts)


def test_fasta_round_trip():
    from ghostm_tpu_torch.io.fasta import iter_fasta
    from ghostm_tpu_torch.ops.encode import encode_aa

    codes, lens = small_db(n=20)
    names = [simulate.subject_name(i) for i in range(20)]
    with tempfile.TemporaryDirectory() as t:
        p = os.path.join(t, "db.fa")
        with open(p, "wb") as f:
            f.write(simulate.fasta_bytes(codes, lens, names))
        recs = list(iter_fasta(p))
    assert [n for n, _ in recs] == names
    assert np.array_equal(np.concatenate([encode_aa(s) for _, s in recs]),
                          codes)
