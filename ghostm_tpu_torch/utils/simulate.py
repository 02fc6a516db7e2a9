"""Synthetic benchmark data: random protein databases and metagenomic-style
DNA reads sampled from them (reverse-translated, mutated, random strand).
Deterministic given the numpy Generator. The port's own copy (the repo's
tools/ generators import the JAX package)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ghostm_tpu_torch.ops.encode import AA_ALPHABET, SENTINEL
from ghostm_tpu_torch.ops.translate import _CODON_TABLE

_REV: dict = {}
for _codon, _aa in _CODON_TABLE.items():
    _REV.setdefault(_aa, []).append(_codon)
_COMP = str.maketrans("ACGT", "TGCA")


def fast_proteins(rng: np.random.Generator, n: int, lo: int = 250,
                  hi: int = 450) -> Tuple[np.ndarray, np.ndarray]:
    """n random proteins over the 20 standard residues as one concatenated
    int8 code buffer + int64 lengths in [lo, hi) (vectorised)."""
    lens = rng.integers(lo, hi, n).astype(np.int64)
    codes = rng.integers(0, 20, int(lens.sum())).astype(np.int8)
    return codes, lens


def store_arrays(codes: np.ndarray, lens: np.ndarray, pad: int):
    """(buffer, starts) of a subject store: every subject preceded and
    followed by `pad` SENTINEL codes (index.store's layout), built without
    a per-subject loop."""
    n = len(lens)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1] + pad, out=starts[1:])
    starts += pad
    total = int(starts[-1] + lens[-1] + pad)
    buf = np.full(total, SENTINEL, np.int8)
    first = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=first[1:])
    within = np.arange(len(codes), dtype=np.int64) - np.repeat(first, lens)
    buf[np.repeat(starts, lens) + within] = codes
    return buf, starts


def reads_from_proteins(rng: np.random.Generator, proteins: List[str],
                        n_reads: int, read_len: int = 100,
                        sub_rate: float = 0.02) -> Tuple[List[str], List[str]]:
    """(names, dna reads): a random window of a random protein,
    reverse-translated with random synonymous codons, padded with random
    bases to read_len, substituted at sub_rate, reverse-complemented with
    probability 1/2. The source protein is in the name."""
    names, seqs = [], []
    n_aa = read_len // 3
    for i in range(n_reads):
        pi = int(rng.integers(0, len(proteins)))
        prot = proteins[pi]
        start = int(rng.integers(0, max(1, len(prot) - n_aa)))
        pep = prot[start:start + n_aa]
        dna = "".join(_REV[a][int(rng.integers(0, len(_REV[a])))] for a in pep)
        extra = read_len - len(dna)
        if extra > 0:
            dna += "".join(rng.choice(list("ACGT"), size=extra))
        d = np.frombuffer(dna[:read_len].encode(), np.uint8).copy()
        hit = rng.random(len(d)) < sub_rate
        d[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, hit.sum())]
        dna = d.tobytes().decode()
        if rng.random() < 0.5:
            dna = dna[::-1].translate(_COMP)
        names.append(f"read{i}_from_subj{pi}")
        seqs.append(dna)
    return names, seqs


def decode_protein(codes: np.ndarray) -> str:
    return "".join(AA_ALPHABET[c] for c in codes)
