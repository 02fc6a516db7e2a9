"""Karlin-Altschul statistics: raw score -> bit score and E-value.

Computed on the HOST in float64 (SURVEY.md §2 "E-value": fp64-on-host so the
final ranking stays bit-reproducible across devices and shard counts; ranking
itself uses only the integer raw score + deterministic tie-breaks, E-values
are reported, not sorted on — SURVEY.md §7.2 "Bit-identical ranking").

Gapped (lambda, K, H) come from the published NCBI BLAST tables (the
BLOSUM62 rows of blast_stat.c's BLOSUM62_VALUES); unknown
(matrix, gap_open, gap_extend) combinations are REJECTED rather than
approximated. E-values use BLAST's finite-size correction: the effective
search space (m - l) * (n - num_seqs * l) with the length adjustment l
solved from l = ln(K * m' * n') / H by fixed-point iteration
(BLAST_ComputeLengthAdjustment's converged value).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# (matrix, gap_open, gap_extend) -> (lambda, K, H).
# Values: NCBI BLAST blast_stat.c published gapped tables
# (BLOSUM{45,50,62,80,90}_VALUES, PAM{30,70,250}_VALUES). The reference
# mount is empty (SURVEY.md §0); these are the standard published
# constants, pinned by tests/test_ops.py. All eight matrices ship in
# ops/scoring.MATRICES; the engine's fused Pallas kernel packs scores as
# 4-bit nibbles (score in [-4, 11], BLOSUM62 only) and routes the other
# matrices through the score-fed kernels (tests/test_golden.py pins the
# BLOSUM50 path end-to-end).
GAPPED_PARAMS = {
    ("BLOSUM62", 11, 2): (0.297, 0.082, 0.27),
    ("BLOSUM62", 10, 2): (0.291, 0.075, 0.23),
    ("BLOSUM62", 9, 2): (0.279, 0.058, 0.19),
    ("BLOSUM62", 8, 2): (0.264, 0.045, 0.15),
    ("BLOSUM62", 7, 2): (0.239, 0.027, 0.10),
    ("BLOSUM62", 6, 2): (0.201, 0.012, 0.061),
    ("BLOSUM62", 13, 1): (0.292, 0.071, 0.23),
    ("BLOSUM62", 12, 1): (0.283, 0.059, 0.19),
    ("BLOSUM62", 11, 1): (0.267, 0.041, 0.14),
    ("BLOSUM62", 10, 1): (0.243, 0.024, 0.10),
    ("BLOSUM62", 9, 1): (0.206, 0.010, 0.052),
    # BLOSUM45_VALUES
    ("BLOSUM45", 13, 3): (0.207, 0.049, 0.14),
    ("BLOSUM45", 12, 3): (0.199, 0.039, 0.11),
    ("BLOSUM45", 11, 3): (0.190, 0.031, 0.095),
    ("BLOSUM45", 10, 3): (0.179, 0.023, 0.075),
    ("BLOSUM45", 16, 2): (0.210, 0.051, 0.14),
    ("BLOSUM45", 15, 2): (0.203, 0.041, 0.12),
    ("BLOSUM45", 14, 2): (0.195, 0.032, 0.10),
    ("BLOSUM45", 13, 2): (0.185, 0.024, 0.084),
    ("BLOSUM45", 12, 2): (0.171, 0.016, 0.061),
    ("BLOSUM45", 19, 1): (0.205, 0.040, 0.11),
    ("BLOSUM45", 18, 1): (0.198, 0.032, 0.10),
    ("BLOSUM45", 17, 1): (0.189, 0.024, 0.079),
    ("BLOSUM45", 16, 1): (0.176, 0.016, 0.063),
    # BLOSUM50_VALUES
    ("BLOSUM50", 13, 3): (0.212, 0.063, 0.19),
    ("BLOSUM50", 12, 3): (0.206, 0.055, 0.17),
    ("BLOSUM50", 11, 3): (0.197, 0.042, 0.14),
    ("BLOSUM50", 10, 3): (0.186, 0.031, 0.11),
    ("BLOSUM50", 9, 3): (0.172, 0.022, 0.082),
    ("BLOSUM50", 16, 2): (0.215, 0.066, 0.20),
    ("BLOSUM50", 15, 2): (0.210, 0.058, 0.17),
    ("BLOSUM50", 14, 2): (0.202, 0.045, 0.14),
    ("BLOSUM50", 13, 2): (0.193, 0.035, 0.12),
    ("BLOSUM50", 12, 2): (0.181, 0.025, 0.095),
    ("BLOSUM50", 19, 1): (0.212, 0.057, 0.18),
    ("BLOSUM50", 18, 1): (0.207, 0.050, 0.15),
    ("BLOSUM50", 17, 1): (0.198, 0.037, 0.12),
    ("BLOSUM50", 16, 1): (0.186, 0.025, 0.10),
    ("BLOSUM50", 15, 1): (0.171, 0.015, 0.063),
    # BLOSUM80_VALUES
    ("BLOSUM80", 25, 2): (0.342, 0.17, 0.66),
    ("BLOSUM80", 13, 2): (0.336, 0.15, 0.57),
    ("BLOSUM80", 9, 2): (0.319, 0.11, 0.42),
    ("BLOSUM80", 8, 2): (0.308, 0.090, 0.35),
    ("BLOSUM80", 7, 2): (0.293, 0.070, 0.27),
    ("BLOSUM80", 6, 2): (0.268, 0.045, 0.19),
    ("BLOSUM80", 11, 1): (0.314, 0.095, 0.35),
    ("BLOSUM80", 10, 1): (0.299, 0.071, 0.27),
    ("BLOSUM80", 9, 1): (0.279, 0.048, 0.20),
    # BLOSUM90_VALUES
    ("BLOSUM90", 9, 2): (0.310, 0.12, 0.46),
    ("BLOSUM90", 8, 2): (0.300, 0.099, 0.39),
    ("BLOSUM90", 7, 2): (0.283, 0.072, 0.30),
    ("BLOSUM90", 6, 2): (0.259, 0.048, 0.22),
    ("BLOSUM90", 11, 1): (0.302, 0.093, 0.39),
    ("BLOSUM90", 10, 1): (0.290, 0.075, 0.28),
    ("BLOSUM90", 9, 1): (0.265, 0.044, 0.20),
    # PAM30_VALUES
    ("PAM30", 7, 2): (0.305, 0.15, 0.87),
    ("PAM30", 6, 2): (0.287, 0.11, 0.68),
    ("PAM30", 5, 2): (0.264, 0.079, 0.45),
    ("PAM30", 10, 1): (0.309, 0.15, 0.88),
    ("PAM30", 9, 1): (0.294, 0.11, 0.61),
    ("PAM30", 8, 1): (0.270, 0.072, 0.40),
    # PAM70_VALUES
    ("PAM70", 8, 2): (0.301, 0.12, 0.54),
    ("PAM70", 7, 2): (0.286, 0.093, 0.43),
    ("PAM70", 6, 2): (0.264, 0.064, 0.29),
    ("PAM70", 11, 1): (0.305, 0.12, 0.52),
    ("PAM70", 10, 1): (0.291, 0.091, 0.41),
    ("PAM70", 9, 1): (0.270, 0.060, 0.28),
    # PAM250_VALUES
    ("PAM250", 15, 3): (0.205, 0.049, 0.13),
    ("PAM250", 14, 3): (0.200, 0.043, 0.12),
    ("PAM250", 13, 3): (0.194, 0.036, 0.10),
    ("PAM250", 12, 3): (0.186, 0.029, 0.085),
    ("PAM250", 11, 3): (0.174, 0.020, 0.070),
    ("PAM250", 17, 2): (0.204, 0.047, 0.12),
    ("PAM250", 16, 2): (0.198, 0.038, 0.11),
    ("PAM250", 15, 2): (0.191, 0.031, 0.087),
    ("PAM250", 14, 2): (0.182, 0.024, 0.073),
    ("PAM250", 13, 2): (0.171, 0.017, 0.059),
    ("PAM250", 21, 1): (0.205, 0.045, 0.11),
    ("PAM250", 20, 1): (0.199, 0.037, 0.10),
    ("PAM250", 19, 1): (0.192, 0.029, 0.083),
    ("PAM250", 18, 1): (0.183, 0.021, 0.070),
    ("PAM250", 17, 1): (0.171, 0.014, 0.052),
}
UNGAPPED_PARAMS = {
    "BLOSUM62": (0.3176, 0.134, 0.4012),
    "BLOSUM45": (0.2291, 0.0924, 0.2514),
    "BLOSUM50": (0.2318, 0.112, 0.3362),
    "BLOSUM80": (0.3430, 0.177, 0.6568),
    "BLOSUM90": (0.3346, 0.190, 0.7547),
    "PAM30": (0.3400, 0.283, 1.754),
    "PAM70": (0.3345, 0.229, 1.237),
    "PAM250": (0.2252, 0.0868, 0.2223),
}


def params_for(matrix: str, gap_open: int, gap_extend: int
               ) -> Tuple[float, float, float]:
    """(lambda, K, H) for a (matrix, gap) combination; raises on combos
    with no published Karlin-Altschul fit."""
    key = (matrix, int(gap_open), int(gap_extend))
    if key not in GAPPED_PARAMS:
        known = sorted(k[1:] for k in GAPPED_PARAMS if k[0] == matrix)
        raise ValueError(
            f"no Karlin-Altschul parameters for {key}; known gap params "
            f"for {matrix}: {known or 'none'}"
        )
    return GAPPED_PARAMS[key]


def length_adjustment(
    k: float, h: float, m: np.ndarray, n: float, num_seqs: int
) -> np.ndarray:
    """BLAST finite-size length adjustment l (vectorised over query length
    m): the converged fixed point of l = ln(K (m-l)(n - N l)) / H, clamped
    so effective lengths stay positive (cf. BLAST_ComputeLengthAdjustment).
    l depends on m alone, so the iteration runs once for each distinct m
    and is indexed back to m's shape: the same float64 operations on the
    same values, elementwise, so the same bits as a solve over every m.
    """
    m = np.asarray(m, dtype=np.float64)
    lens, back = np.unique(m, return_inverse=True)
    n = float(n)
    num_seqs = max(int(num_seqs), 1)
    logk = np.log(k)
    floor_len = 1.0 / k   # BLAST floors effective lengths at 1/K
    ell = np.zeros_like(lens)
    for _ in range(20):
        me = np.maximum(lens - ell, floor_len)
        ne = np.maximum(n - num_seqs * ell, floor_len)
        ell = np.clip((logk + np.log(me * ne)) / h, 0.0, None)
    return np.floor(ell)[back].reshape(m.shape)


def adjusted(h: float, db_seqs: int) -> bool:
    """Whether e_value applies the length adjustment: H and the database's
    sequence count are known."""
    return h > 0.0 and db_seqs > 0


def bit_score(raw: np.ndarray, lam: float, k: float) -> np.ndarray:
    raw = np.asarray(raw, dtype=np.float64)
    return (lam * raw - np.log(k)) / np.log(2.0)


def e_value(
    raw: np.ndarray,
    qlen: np.ndarray,
    db_residues: int,
    lam: float,
    k: float,
    h: float = 0.0,
    db_seqs: int = 0,
) -> np.ndarray:
    """E = K * m' * n' * exp(-lambda * S).

    With h > 0 and db_seqs > 0, m'/n' are BLAST effective lengths (length
    adjustment above); otherwise the plain Karlin-Altschul search space.
    qlen broadcasts against raw: a caller with R reads of K hits each
    passes raw (R, K) and qlen (R, 1), so the lengths' terms are formed a
    read and only exp(-lambda * S) a hit.
    """
    raw = np.asarray(raw, dtype=np.float64)
    m = np.asarray(qlen, dtype=np.float64)
    n = float(db_residues)
    if adjusted(h, db_seqs):
        ell = length_adjustment(k, h, m, n, db_seqs)
        m_eff = np.maximum(m - ell, 1.0 / k)
        n_eff = np.maximum(n - db_seqs * ell, 1.0 / k)
        return k * m_eff * n_eff * np.exp(-lam * raw)
    return k * m * n * np.exp(-lam * raw)
