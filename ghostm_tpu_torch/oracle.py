"""Naive CPU oracles: obviously-correct implementations used as ground truth
(the port's own copy of the JAX package's oracle.py; numpy only).

The port's SW paths (the kernels' plain versions, and the CUDA kernels
through them) must agree with them EXACTLY (integer equality, same
tie-breaks).

Banded-SW cell semantics (shared contract with kernels/sw_xla.py and
kernels/sw_scored.py):

  A candidate is (query q[0:Lq], window start g0). Cell (i, b) with
  i in [0, Lq), b in [0, B) aligns q[i] against subject buffer position
  j = g0 + i + b. Affine gaps cost (open + ext) to open and ext to extend
  (NCBI convention: a gap of length g costs open + g*ext).

    H[i,b] = max(0, H[i-1,b] + s(i,b), E[i,b], F[i,b])
    E[i,b] = max(H[i,b-1] - open - ext, E[i,b-1] - ext)   # gap in query
    F[i,b] = max(H[i-1,b+1] - open - ext, F[i-1,b+1] - ext)  # gap in subject

  Out-of-band predecessors are -inf; H[-1, b] = 0 (local alignment).

Tie-break contract (SURVEY.md §7.2 "Bit-identical ranking"): the reported
endpoint is the max-scoring cell with the SMALLEST i, then SMALLEST b — i.e.
ranking is deterministic and independent of evaluation order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -(1 << 30)


def subst(matrix: np.ndarray, a: int, c: int) -> int:
    return int(matrix[a, c])


def sw_banded(
    q: np.ndarray,
    buf: np.ndarray,
    g0: int,
    band: int,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
) -> Tuple[int, int, int]:
    """Scalar-loop banded SW. Returns (best_score, i_end, b_end).

    (i_end, b_end) = (-1, -1) when best_score == 0 (empty alignment).
    """
    Lq, B = len(q), band
    go1, ge = gap_open + gap_extend, gap_extend
    H = np.zeros(B, dtype=np.int64)
    F = np.full(B, NEG, dtype=np.int64)
    best, bi, bb = 0, -1, -1
    for i in range(Lq):
        newH = np.zeros(B, dtype=np.int64)
        newF = np.full(B, NEG, dtype=np.int64)
        E = NEG
        for b in range(B):
            j = g0 + i + b
            s = subst(matrix, q[i], buf[j]) if 0 <= j < len(buf) else NEG
            newF[b] = max(
                (H[b + 1] - go1) if b + 1 < B else NEG,
                (F[b + 1] - ge) if b + 1 < B else NEG,
            )
            E = max(newH[b - 1] - go1, E - ge) if b > 0 else NEG
            h = max(0, H[b] + s, E, newF[b])
            newH[b] = h
            if h > best:
                best, bi, bb = int(h), i, b
        H, F = newH, newF
    return best, bi, bb


def sw_full(
    q: np.ndarray,
    t: np.ndarray,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
) -> int:
    """Unbanded local SW best score (full O(n*m)); sensitivity reference.

    Textbook Gotoh: E (gap in target) runs HORIZONTALLY within a query
    row; F (gap in query) runs VERTICALLY down each target column, so it
    must be a per-column array carried ACROSS rows (a row-carried F
    re-opens every multi-row gap and admits illegal mixed moves).
    tests/test_torch_sensitivity_oracle.py cross-checks it against an
    independent full-matrix Gotoh and the reference's copy."""
    n, m = len(q), len(t)
    go1, ge = gap_open + gap_extend, gap_extend
    H = np.zeros(m + 1, dtype=np.int64)
    F = np.full(m + 1, NEG, dtype=np.int64)
    best = 0
    for i in range(n):
        diag = 0
        E = NEG
        newH = np.zeros(m + 1, dtype=np.int64)
        for j in range(1, m + 1):
            s = subst(matrix, q[i], t[j - 1])
            E = max(newH[j - 1] - go1, E - ge)
            F[j] = max(H[j] - go1, F[j] - ge)
            h = max(0, diag + s, E, F[j])
            diag = H[j]
            newH[j] = h
            best = max(best, int(h))
        H = newH
    return best


def naive_seed_hits(qcodes: np.ndarray, buf: np.ndarray, k: int) -> list:
    """All (qpos, dbpos) exact k-mer matches — oracle for seed lookup."""
    from ghostm_tpu_torch.index.seeds import NUM_SEED_AA, kmer_keys

    qk = kmer_keys(qcodes, k)
    bk = kmer_keys(buf, k)
    out = []
    for qpos, key in enumerate(qk):
        if key >= NUM_SEED_AA**k:
            continue
        for dbpos in np.nonzero(bk == key)[0]:
            out.append((qpos, int(dbpos)))
    return out
