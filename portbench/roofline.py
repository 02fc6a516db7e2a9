"""The least time a kernel's launch could take on one NVIDIA H100 SXM.

Frozen from the port's `chip_smoke.bound` and its operation counts: the
larger of the bytes over the card's memory bandwidth and the operations
over its non-tensor 32-bit rate. Every input byte is counted read once
and every output byte written once, whatever the kernel reads again. The
operations are a logical count, 12 int32 operations a dynamic-programming
cell (the recurrences' adds and maxes and the best-cell tracking), against
the FP32 rate with a fused multiply-add counted as 2: a kernel that does
two cells in one 16-bit DPX instruction could read near 100%, and the
count is then to be revisited before such a kernel is judged. A sort
counts 2 operations a compare-exchange of its bitonic network.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
OPS_PER_S = 67e12           # H100 SXM FP32 outside the tensor cores
OPS_PER_CELL = 12


def bound(nbytes: float, nops: float) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the larger of the two times."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def sw_counts(N: int, Lq: int, band: int) -> Tuple[int, int]:
    """(bytes, operations) of one banded-SW launch over N alignments
    (kernels B3, B5, B6): each query's Lq codes, its window's Lq + band
    codes, its span (8 bytes) in; score, end row and end diagonal (12
    bytes) out; OPS_PER_CELL a cell of N x Lq x band."""
    return N * (Lq + Lq + band + 8 + 12), OPS_PER_CELL * N * Lq * band


def refine_counts(R: int, K: int, Lq: int, band: int) -> Tuple[int, int]:
    """(bytes, operations) of one refine launch (kernel R1) over R reads
    x K hits, N = R * K: the reads' six frames, two packed fields a hit
    (frame, window start), its window and span, the (32, 33) int32 score
    table in; nine int32 stats a hit out; OPS_PER_CELL a cell of the moves
    DP (the walk's steps not counted)."""
    N = R * K
    nbytes = (R * 6 * Lq + 2 * N * 4 + N * (Lq + band) + 2 * N * 4
              + 32 * 33 * 4 + 9 * N * 4)
    return nbytes, OPS_PER_CELL * N * Lq * band


def sort_vote_counts(Q: int, M: int, ncand: int,
                     presorted_run: int = 0) -> Tuple[int, int]:
    """(bytes, operations) of one launch of kernel B2's monolithic entry
    (sort_vote_rank_rows) on a (Q, M) int32 key array: the keys in; ncand
    keys and votes a row out; a row padded to L (a power of two, >= 128)
    sorted by the bitonic network's stages from the first the presorted
    runs leave (2 a compare-exchange, L / 2 of them a pass, s passes in
    stage s), then 1 + 2 ncand a key for the run-length vote and the
    top-ncand."""
    L = max(1 << max(M - 1, 1).bit_length(), 128)
    first = min(max(presorted_run, 1).bit_length(), L.bit_length())
    passes = sum(range(first, L.bit_length()))
    return (Q * M * 4 + 2 * Q * ncand * 4,
            Q * (passes * (L // 2) * 2 + (1 + 2 * ncand) * L))
