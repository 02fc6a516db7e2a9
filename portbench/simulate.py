"""The benchmark's own simulator: protein databases and DNA reads.

A frozen copy of the port's `utils/simulate.py` (`fast_proteins`,
`reads_from_proteins`), widened where a deployment needs it and
vectorised: residues drawn from a stated composition, reads drawn
from Zipf-skewed proteins with lengths from a range, and no per-read
Python loop. Imports numpy only, so the program's changes never move the
yardstick.

Codes are the port's: amino acids in NCBI order ARNDCQEGHILKMFPSTWYV...
(0-19 are the 20 standard residues), DNA A=0, C=1, G=2, T=3.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

AA_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
DNA_ALPHABET = "ACGT"

_CODON_TABLE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

# SYN[a, j]: the j-th codon (3 DNA codes) of amino acid a; NSYN[a]: how many
SYN = np.zeros((20, 6, 3), np.int8)
NSYN = np.zeros(20, np.int64)
for _codon, _aa in sorted(_CODON_TABLE.items()):
    if _aa == "*":
        continue
    _a = AA_ALPHABET.index(_aa)
    SYN[_a, NSYN[_a]] = [DNA_ALPHABET.index(c) for c in _codon]
    NSYN[_a] += 1
_COMP = np.array([3, 2, 1, 0], np.int8)   # A<->T, C<->G


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole number (negative ones wrap to 64 bits)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def fast_proteins(rng: np.random.Generator, n: int, lo: int, hi: int,
                  composition: Dict[str, float] | None = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """n proteins as one concatenated int8 code buffer and int64 lengths
    uniform in [lo, hi). Residues are uniform over the 20 standard ones,
    or drawn from `composition` (letter -> share, normalised here)
    through a 65,536-entry table, which holds each share to 2^-16."""
    lens = rng.integers(lo, hi, n).astype(np.int64)
    total = int(lens.sum())
    if composition is None:
        return rng.integers(0, 20, total).astype(np.int8), lens
    p = np.array([composition[a] for a in AA_ALPHABET[:20]], np.float64)
    edges = np.round(np.cumsum(p / p.sum()) * 65536).astype(np.int64)
    lut = np.repeat(np.arange(20, dtype=np.int8),
                    np.diff(np.concatenate([[0], edges])))
    return lut[rng.integers(0, 65536, total, dtype=np.uint16)], lens


def family_sizes(rng: np.random.Generator, n: int, exponent: float,
                 size_max: int) -> np.ndarray:
    """Sizes of protein families that hold n proteins together: each drawn
    with P(s) proportional to s^-exponent over 1..size_max, the last one
    cut so that the sizes sum to n."""
    s = np.arange(1, size_max + 1, dtype=np.float64)
    cdf = np.cumsum(s ** -exponent)
    out, total = [], 0
    while total < n:
        draw = 1 + np.searchsorted(cdf, rng.random(max(n // 4, 16))
                                   * cdf[-1], side="right")
        out.append(np.minimum(draw, size_max))
        total += int(out[-1].sum())
    sizes = np.concatenate(out)
    cut = int(np.searchsorted(np.cumsum(sizes), n))
    sizes = sizes[:cut + 1].copy()
    sizes[-1] -= int(sizes.sum()) - n
    return sizes.astype(np.int64)


def family_proteins(rng: np.random.Generator, n: int, lo: int, hi: int,
                    composition: Dict[str, float] | None, fam: dict
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """n proteins in families: family sizes from `family_sizes`, an
    ancestor a family (fast_proteins: length uniform in [lo, hi)), each
    member the ancestor with a share of its residues redrawn from the
    composition, the share uniform in [divergence_min, divergence_max]
    a member. Members are laid out in a random order, as accessions
    scatter a family over a database. Returns (codes, lengths)."""
    sizes = family_sizes(rng, n, fam["size_exponent"], fam["size_max"])
    anc, alen = fast_proteins(rng, len(sizes), lo, hi, composition)
    afirst = np.concatenate([[0], np.cumsum(alen)[:-1]])
    member_fam = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    lens = alen[member_fam]
    total = int(lens.sum())
    div = rng.uniform(fam["divergence_min"], fam["divergence_max"], n)
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    codes = np.empty(total, np.int8)
    fresh, _ = fast_proteins(rng, 1, total, total + 1, composition)
    step = 1 << 24                       # members a block: bounded memory
    ends = np.cumsum(lens)
    m0 = 0
    while m0 < n:
        m1 = int(np.searchsorted(ends, ends[m0 - 1] + step if m0 else step,
                                 side="right"))
        m1 = max(m1, m0 + 1)
        mlen = lens[m0:m1]
        owner = np.repeat(np.arange(m0, m1), mlen)
        off = np.arange(int(mlen.sum())) - np.repeat(first[m0:m1] -
                                                     first[m0], mlen)
        src = anc[afirst[member_fam[owner]] + off]
        thr = (div[owner] * 65536).astype(np.int64)
        redraw = rng.integers(0, 65536, len(owner), dtype=np.uint16) < thr
        a, b = first[m0], first[m0] + len(owner)
        codes[a:b] = np.where(redraw, fresh[a:b], src)
        m0 = m1
    return codes, lens


def database(spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    """A configuration's protein database from its `database` group:
    each entry of `groups` ({"n", "lo", "hi"}, `hi` exclusive, and
    optionally "families" for family_proteins) in order, every group from
    the one generator seeded by `seed`, residues from `composition`.
    Returns (codes, lengths) in global id order."""
    rng = rng_for(spec["seed"])
    codes, lens = [], []
    for g in spec["groups"]:
        if "families" in g:
            c, ln = family_proteins(rng, g["n"], g["lo"], g["hi"],
                                    spec.get("composition"), g["families"])
        else:
            c, ln = fast_proteins(rng, g["n"], g["lo"], g["hi"],
                                  spec.get("composition"))
        codes.append(c)
        lens.append(ln)
    return np.concatenate(codes), np.concatenate(lens)


def subject_name(i: int) -> str:
    """The database's name of protein i (its FASTA header)."""
    return f"s{i}"


def fasta_bytes(codes: np.ndarray, lens: np.ndarray,
                names: List[str]) -> bytes:
    """The database as FASTA, one line a sequence."""
    letters = np.frombuffer(AA_ALPHABET.encode(), np.uint8)[codes]
    ends = np.cumsum(lens)
    seqs = np.split(letters, ends[:-1])
    return b"".join(b">" + nm.encode() + b"\n" + s.tobytes() + b"\n"
                    for nm, s in zip(names, seqs))


def zipf_pick(rng: np.random.Generator, n_items: int, size: int,
              s: float, order: np.ndarray | None = None) -> np.ndarray:
    """`size` draws over n_items items, item of rank r (1-based) with
    weight r^-s, the ranks laid on the items by `order` (a permutation;
    a random one from rng where None)."""
    w = np.arange(1, n_items + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(w)
    rank = np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")
    if order is None:
        order = rng.permutation(n_items)
    return order[np.minimum(rank, n_items - 1)]


def reads(rng: np.random.Generator, codes: np.ndarray, lens: np.ndarray,
          n: int, mix: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n reads of the traffic `mix` as ((n, max_read_len) int8 DNA codes,
    padded with N = 4; (n,) int32 lengths; (n,) int64 source protein id or
    -1). Lengths uniform in [read_len_min, read_len_max]. A share
    `homolog_share` are homologous: a random window of read_len // 3
    residues of a protein drawn Zipf(`zipf_s`) over all proteins, the
    proteins' abundance ranks fixed by the mix's `abundance_seed` (a
    sample's species; rng draws the reads, so every seed asks for the
    same work), back-translated with random synonymous codons, random
    bases to the read's length, substituted at `sub_rate` (a random base,
    as the port's rule), reverse-complemented with probability 1/2. The
    others are random DNA of the same lengths (the port's
    reads_from_proteins, vectorised)."""
    width = mix["max_read_len"]
    rl = rng.integers(mix["read_len_min"], mix["read_len_max"] + 1,
                      n).astype(np.int64)
    homolog = rng.random(n) < mix["homolog_share"]
    order = rng_for(mix["abundance_seed"]).permutation(len(lens))
    src = np.where(homolog, zipf_pick(rng, len(lens), n, mix["zipf_s"],
                                      order), -1)
    dna = rng.integers(0, 4, (n, width)).astype(np.int8)
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    h = np.nonzero(homolog)[0]
    n_aa = rl[h] // 3
    plen = lens[src[h]]
    if (plen < n_aa).any():
        raise ValueError("a read is longer than its source protein")
    start = (rng.random(len(h)) * np.maximum(plen - n_aa, 1)).astype(np.int64)
    j = np.arange(int(n_aa.max(initial=0)), dtype=np.int64)
    live = j[None, :] < n_aa[:, None]
    aa = codes[np.minimum(first[src[h]][:, None] + start[:, None] + j[None, :],
                          len(codes) - 1)]
    pick = (rng.random(aa.shape) * NSYN[aa]).astype(np.int64)
    cod = SYN[aa, pick].reshape(len(h), -1)           # (h, 3 * max n_aa)
    cols = cod.shape[1]
    d = dna[h, :cols]
    d[:] = np.where(np.repeat(live, 3, axis=1), cod, d)
    dna[h, :cols] = d
    sub = rng.random((n, width)) < mix["sub_rate"]
    dna[sub] = rng.integers(0, 4, int(sub.sum())).astype(np.int8)
    pos = np.arange(width)[None, :]
    inside = pos < rl[:, None]
    rc = rng.random(n) < 0.5
    rev = np.take_along_axis(dna, np.clip(rl[:, None] - 1 - pos, 0,
                                          width - 1), 1)
    dna = np.where(rc[:, None] & inside, _COMP[rev], dna)
    dna[~inside] = 4
    return dna, rl.astype(np.int32), src
