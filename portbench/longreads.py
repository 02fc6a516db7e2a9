"""Long reads over several genes: the benchmark's long-read simulator.

A traffic mix with `"reads": "genomes"` is made here (run.make_pool);
every other mix by simulate.reads, whose pools this module leaves as they
are. Imports numpy and the frozen simulator only, so the program's changes
never move the yardstick.

A read is a window of a genome stretch, built gene by gene until it covers
the read:
- a gene is, with probability `homolog_share`, a database protein drawn
  Zipf(`zipf_s`) over all proteins, the abundance ranks laid on the
  proteins by the mix's `abundance_seed` (a sample's species: the run's
  seed draws the reads, so every seed asks for the same work), as in
  simulate.reads; otherwise a novel gene, its length drawn from the
  database's lengths and its residues from the database's own
  composition;
- each gene is back-translated with random synonymous codons and laid on
  a random strand (reverse-complemented on the minus one), a spacer of
  random bases before the next, its length uniform in [`spacer_min`,
  `spacer_max`];
- the read starts at a random offset into the first gene; its length is
  log-normal (median `len_median`, shape `len_sigma`), drawn again until it
  lies in [`read_len_min`, `read_len_max`];
- errors are made a base of the stretch: a substitution (another base) at
  `sub_rate`, a random base inserted after it at `ins_rate`, the base left
  out at `del_rate`; each one base long and uniform along the read. The
  read keeps its drawn length, and is padded with N = 4 to `max_read_len`.

A PacBio HiFi read of a bacterial metagenome, and where each number comes
from (read: from the source here; recalled: from memory of the source;
assumed: set here):
- read lengths: a 13.5 kb mean (Wenger et al., Nat Biotechnol 37:1155,
  2019; recalled). `len_median` 13,085 bp is the median of the log-normal
  with that mean at `len_sigma` 0.25 (assumed: size-selected libraries);
  `read_len_max` 10,368 bp is three times the longest frame the port has
  run on the card, 3,456 residues (a cut, below the source's mean);
  `read_len_min` 1,000 bp (assumed: long-read mode's shortest reads);
- accuracy 99.8% (Wenger et al. 2019; recalled), split as 0.1%
  substitutions, 0.05% insertions and 0.05% deletions (assumed), uniform
  with no homopolymer bias (assumed);
- spacers of 50-200 bp (assumed), for a coding density near the ~88%
  usually given for bacterial genomes (recalled): ~89% at Swiss-Prot-sized
  genes of ~1,050 bp;
- `homolog_share` 0.5 a gene (assumed, as `reads100` has it a read).

Codes are the simulator's: amino acids 0-19 in NCBI order, DNA A=0, C=1,
G=2, T=3, N=4.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench.simulate import NSYN, SYN, _COMP, rng_for, zipf_pick

N_BASE = 4


def read_lengths(rng: np.random.Generator, n: int, mix: dict) -> np.ndarray:
    """n log-normal lengths (median len_median, shape len_sigma), each drawn
    again until it lies in [read_len_min, read_len_max]."""
    lo, hi = mix["read_len_min"], mix["read_len_max"]
    mu, sigma = np.log(mix["len_median"]), mix["len_sigma"]
    out = np.zeros(n, np.int64)
    todo = np.arange(n)
    for _ in range(10_000):
        x = np.rint(np.exp(rng.normal(mu, sigma, len(todo)))).astype(np.int64)
        ok = (x >= lo) & (x <= hi)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
        if not len(todo):
            return out
    raise ValueError("the read length range holds almost none of the "
                     "log-normal's mass")


def genes(rng: np.random.Generator, lens: np.ndarray, need: np.ndarray,
          mix: dict) -> Dict[str, np.ndarray]:
    """The genes of each read's stretch, laid one a read a round until the
    stretch covers `need` bases from the read's start: per gene its read,
    source protein (-1: novel), residues, strand (+1 / -1) and first base
    relative to the read's start (the first gene's lies at or before 0)."""
    n = len(need)
    order = rng_for(mix["abundance_seed"]).permutation(len(lens))
    parts = []
    end = np.zeros(n, np.int64)
    live = np.arange(n)
    while len(live):
        m = len(live)
        homolog = rng.random(m) < mix["homolog_share"]
        src = np.where(homolog, zipf_pick(rng, len(lens), m, mix["zipf_s"],
                                          order), -1)
        aa = np.where(homolog, lens[np.maximum(src, 0)],
                      lens[rng.integers(0, len(lens), m)])
        strand = np.where(rng.random(m) < 0.5, 1, -1)
        if not parts:                       # a random offset into the first
            start = -(rng.random(m) * 3 * aa).astype(np.int64)
        else:
            start = end[live] + rng.integers(mix["spacer_min"],
                                             mix["spacer_max"] + 1, m)
        end[live] = start + 3 * aa
        parts.append((live, src, aa, strand, start))
        live = live[end[live] < need[live]]
    cols = [np.concatenate(c) for c in zip(*parts)]
    o = np.argsort(cols[0], kind="stable")  # a read's genes in stretch order
    return dict(zip(("read", "source", "aa", "strand", "start"),
                    (c[o].astype(np.int64) for c in cols)))


def stretches(rng: np.random.Generator, codes: np.ndarray, lens: np.ndarray,
              g: Dict[str, np.ndarray], n: int, width: int) -> np.ndarray:
    """(n, width) int8 bases of each read's stretch from the read's start:
    random bases (the spacers) under the genes' back-translated codons."""
    out = rng.integers(0, 4, (n, width), dtype=np.int8)
    aa = g["aa"]
    total = int(aa.sum())
    gi = np.repeat(np.arange(len(aa)), aa)          # the gene of a residue
    j = np.arange(total) - np.repeat(np.cumsum(aa) - aa, aa)
    src = g["source"][gi]
    novel = src < 0
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    res = np.empty(total, np.int64)
    res[~novel] = codes[first[src[~novel]] + j[~novel]]
    res[novel] = codes[rng.integers(0, len(codes), int(novel.sum()))]
    pick = (rng.random(total) * NSYN[res]).astype(np.int64)
    cod = SYN[res, pick]                            # (total, 3)
    plus = g["strand"][gi] > 0
    start = g["start"][gi]
    # codon j's base i lies at start + 3j + i on the plus strand; reversed
    # and complemented at start + 3 aa - 1 - 3j - i on the minus one
    col = (np.where(plus, start + 3 * j, start + 3 * aa[gi] - 1 - 3 * j
                    )[:, None] + np.where(plus, 1, -1)[:, None] * np.arange(3)
           ).ravel()
    val = np.where(plus[:, None], cod, _COMP[cod]).ravel()
    inside = (col >= 0) & (col < width)
    flat = np.repeat(g["read"][gi] * width, 3) + col
    out.reshape(-1)[flat[inside]] = val[inside]
    return out


def errors(rng: np.random.Generator, stretch: np.ndarray, need: np.ndarray,
           rl: np.ndarray, mix: dict
           ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """The reads as sequenced from their stretches: ((n, max_read_len) int8
    bases, N past each read's length; (n, width + 1) int32 read position
    of each stretch base (a left-out base: the next base's), the last column
    the bases made from the whole stretch; per read the substitutions,
    insertions and deletions inside it). The draws do not depend on the
    rates."""
    n, width = stretch.shape
    u = rng.random((n, width), dtype=np.float32)
    alt = rng.integers(1, 4, (n, width), dtype=np.int8)
    ins_base = rng.integers(0, 4, (n, width), dtype=np.int8)
    d, i = mix["del_rate"], mix["ins_rate"]
    dele = u < d
    ins = (u >= d) & (u < d + i)
    sub = (u >= d + i) & (u < d + i + mix["sub_rate"])
    emit = 1 - dele.astype(np.int32) + ins
    pos = np.zeros((n, width + 1), np.int32)
    np.cumsum(emit, axis=1, out=pos[:, 1:])
    made = pos[np.arange(n), np.minimum(need, width)]
    if (made < rl).any():
        raise ValueError("a stretch is shorter than its read")
    base = np.where(sub, (stretch + alt) % 4, stretch).astype(np.int8)
    W = mix["max_read_len"]
    out = np.full(n * W, N_BASE, np.int8)
    at, inside = pos[:, :-1], pos[:, :-1] < rl[:, None].astype(np.int32)
    flat = (at + (np.arange(n, dtype=np.int64) * W)[:, None]).ravel()
    keep = (~dele & inside).ravel()
    out[flat[keep]] = base.ravel()[keep]
    put = ins & (at + 1 < rl[:, None])
    out[flat[put.ravel()] + 1] = ins_base[put]
    counts = dict(subs=(sub & ~dele & inside).sum(1), ins=put.sum(1),
                  dels=(dele & inside).sum(1))
    return out.reshape(n, W), pos, counts


def _margin(rl: np.ndarray, del_rate: float) -> np.ndarray:
    """Stretch bases past a read's length that its deletions may use: twice
    the mean, eight standard deviations and 16 over."""
    m = rl * del_rate
    return (2 * m + 8 * np.sqrt(m) + 16).astype(np.int64)


def reads(rng: np.random.Generator, codes: np.ndarray, lens: np.ndarray,
          n: int, mix: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      Dict[str, np.ndarray]]:
    """n reads of the mix as ((n, max_read_len) int8 DNA codes, padded with
    N = 4; (n,) int32 lengths; (n,) int64 the first homologous gene's source
    protein or -1; the layout). The layout has a row a gene that overlaps
    its read, in stretch order: `read`, `source` (-1: novel), `strand`
    (+1 / -1), `start` and `end`, its first and past-its-last base in the
    read's positions, not cut to the read (a minus-strand gene reads from
    end - 1 down to start); and a row a read: `subs`, `ins`, `dels`, the
    errors inside it."""
    if mix["read_len_max"] > mix["max_read_len"]:
        raise ValueError("read_len_max is past max_read_len")
    rl = read_lengths(rng, n, mix)
    need = rl + _margin(rl, mix["del_rate"])
    g = genes(rng, lens, need, mix)
    width = int(need.max(initial=1))
    st = stretches(rng, codes, lens, g, n, width)
    dna, pos, counts = errors(rng, st, need, rl, mix)
    last = g["start"] + 3 * g["aa"] - 1

    def at(r, t):                           # a stretch base's read position
        inner = pos[r, np.clip(t, 0, width)]
        return np.where(t < 0, t, np.where(t >= width,
                                           pos[r, width] + t - width, inner))

    start, end = at(g["read"], g["start"]), at(g["read"], last) + 1
    over = start < rl[g["read"]]
    layout = dict(read=g["read"][over], source=g["source"][over],
                  strand=g["strand"][over], start=start[over], end=end[over],
                  **counts)
    src = np.full(n, -1, np.int64)
    h = layout["source"] >= 0
    r, k = np.unique(layout["read"][h], return_index=True)
    src[r] = layout["source"][h][k]
    return dna, rl.astype(np.int32), src, layout
