"""What decides `correct`: the window's m8 rows against the plain reference.

Reads are named `r<batch>_<read>` after their place in the pool, so a
read's rows in the output file belong to the emission (the n-th batch the
window sent) whose run of rows they sit in. Once the window has closed, a
sample of (emission, read) pairs drawn from the run's seed is searched by
the reference (portbench/reference.py), and each read's rows are compared
with the program's, exactly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench import reference, simulate


def read_name(b: int, i: int) -> str:
    return f"r{b}_{i}"


def sample(seed: int, emissions: int, batch: int, n: int
           ) -> List[Tuple[int, int]]:
    """n distinct (emission, read) pairs drawn from the seed (fewer when
    the window sent fewer reads)."""
    rng = simulate.rng_for(seed ^ 0x5EED)
    total = emissions * batch
    flat = rng.choice(total, size=min(n, total), replace=False)
    return sorted((int(f // batch), int(f % batch)) for f in flat)


def program_rows(path: str, sequence: List[int],
                 wanted: List[Tuple[int, int]]) -> Dict[tuple, List[str]]:
    """The rows of each wanted (emission, read) in the m8 file; `sequence`
    is the pool batch of each emission in order. A run of rows of one
    batch is the next emission of that batch (an emission with no rows
    has no run)."""
    want: Dict[int, set] = {}
    for e, r in wanted:
        want.setdefault(e, set()).add(r)
    out: Dict[tuple, List[str]] = {p: [] for p in wanted}
    e, cur = -1, None
    with open(path) as f:
        next(f, None)                       # the header
        for line in f:
            name = line[:line.index("\t")]
            b, r = name[1:].split("_")
            b, r = int(b), int(r)
            if b != cur:
                e += 1
                while e < len(sequence) and sequence[e] != b:
                    e += 1
                if e >= len(sequence):
                    raise ValueError(f"rows of batch {b} past the emissions")
                cur = b
            if r in want.get(e, ()):
                out[(e, r)].append(line.rstrip("\n"))
    return out


def reference_rows(pool, wanted, sequence, db_codes, db_lens, cfg: dict,
                   device, saturate=None) -> Dict[tuple, List[str]]:
    """The reference's rows of each wanted (emission, read)."""
    import torch

    picks = [(sequence[e], r) for e, r in wanted]
    dna = np.stack([pool[b][1][r] for b, r in picks])
    lens = np.array([pool[b][2][r] for b, r in picks], np.int64)
    db = reference.Database(db_codes, db_lens, device)
    sidx = reference.SeedIndex(db_codes, db_lens, cfg["seed_len"],
                               cfg["hits_per_seed"], device)
    hits = reference.search(dna, lens, db, sidx, cfg, saturate=saturate)
    del sidx, db
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {p: reference.m8_rows(read_name(b, r), int(ln), h,
                                 simulate.subject_name, cfg,
                                 int(np.asarray(db_lens, np.int64).sum()),
                                 len(db_lens))
            for p, (b, r), ln, h in zip(wanted, picks, lens, hits)}


def compare(got: Dict[tuple, List[str]], want: Dict[tuple, List[str]]
            ) -> dict:
    """reads_differ: sampled reads whose rows differ; rows_checked: the
    reference's rows over the sample."""
    differ = [p for p in want if got.get(p) != want[p]]
    return dict(reads_differ=len(differ),
                rows_checked=sum(len(v) for v in want.values()),
                first_differ=(None if not differ else
                              dict(read=list(differ[0]),
                                   program=got.get(differ[0]),
                                   reference=want[differ[0]])))
