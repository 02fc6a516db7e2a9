"""The port's naive CPU oracles (ghostm_tpu_torch/oracle.py, its own copy of
the JAX package's) against the JAX package's and an independent
full-matrix Gotoh, and the port's plain SW paths (B3's, B5's and B6's plain
versions, which the CUDA kernels equal on the card) against them: the
unbanded sw_full score with a band that covers every diagonal of the pair,
and the banded sw_banded (score and endpoint). Tolerance 0."""

import numpy as np
import pytest
import torch

from ghostm_tpu import oracle as joracle
from ghostm_tpu_torch import oracle
from ghostm_tpu_torch.kernels import sw_fused, sw_scored, sw_wave
from ghostm_tpu_torch.ops.encode import SENTINEL
from ghostm_tpu_torch.ops.scoring import padded_matrix

torch.set_num_threads(1)

GO, GE = 11, 1


def _gotoh_matrix(q, t, matrix, go, ge):
    """Independent full-matrix textbook Gotoh (no rolling arrays)."""
    n, m = len(q), len(t)
    NEG = -(1 << 20)
    go1 = go + ge
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    best = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            E[i][j] = max(H[i][j - 1] - go1, E[i][j - 1] - ge)
            F[i][j] = max(H[i - 1][j] - go1, F[i - 1][j] - ge)
            H[i][j] = max(0, H[i - 1][j - 1] + matrix[q[i - 1], t[j - 1]],
                          E[i][j], F[i][j])
            best = max(best, int(H[i][j]))
    return best


def test_sw_full_equals_jax_and_textbook_gotoh(rng):
    matrix = padded_matrix("BLOSUM62", hard_stop=True)
    for _ in range(40):
        n, m = int(rng.integers(2, 26)), int(rng.integers(2, 40))
        q = rng.integers(0, 20, n).astype(np.int64)
        t = rng.integers(0, 20, m).astype(np.int64)
        got = oracle.sw_full(q, t, matrix, GO, GE)
        assert got == joracle.sw_full(q, t, matrix, GO, GE)
        assert got == _gotoh_matrix(q, t, matrix, GO, GE)


def test_sw_banded_and_seed_hits_equal_jax(rng):
    matrix = padded_matrix("BLOSUM62", hard_stop=True)
    for _ in range(20):
        Lq, B = int(rng.integers(4, 24)), int(rng.integers(2, 12))
        q = rng.integers(0, 24, Lq).astype(np.int64)
        buf = rng.integers(0, 24, 80).astype(np.int64)
        g0 = int(rng.integers(-8, 60))
        assert oracle.sw_banded(q, buf, g0, B, matrix, GO, GE) == \
            joracle.sw_banded(q, buf, g0, B, matrix, GO, GE)
    qc = rng.integers(0, 22, 30).astype(np.int8)
    buf = rng.integers(0, 22, 400).astype(np.int8)
    buf[100:130] = qc
    got = oracle.naive_seed_hits(qc, buf, 3)
    assert got == joracle.naive_seed_hits(qc, buf, 3)
    assert (0, 100) in got


# (route, matrix, plain version): B3 reads the score table the engine
# builds; B5 and B6 the code table
ROUTES = [
    ("B3 fused", "BLOSUM62", None),
    ("B5 scored", "BLOSUM50", sw_scored.sw_scored_codes_plain),
    ("B6 wave", "BLOSUM50", sw_wave.sw_wave_codes_plain),
]


def _plain(route, mat, plain, q, w, lo, hi, band):
    m = torch.from_numpy(mat)
    q, w = torch.from_numpy(q), torch.from_numpy(w)
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    if plain is None:
        _, code_limit = sw_fused.build_packed_matrix(mat)
        s, ie, be = sw_fused.sw_fused_plain(q, w, m, lo, hi, GO, GE, band,
                                            code_limit)
    else:
        s, ie, be = plain(q, w, sw_scored.code_table(m, band), lo, hi, GO,
                          GE, band)
    return s.numpy(), ie.numpy(), be.numpy()


@pytest.mark.parametrize("route,name,plain", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_plain_sw_full_band_equals_sw_full(rng, route, name, plain):
    """A band of 64 over a window that holds the subject at offset Lq - 1
    (sentinels around it, outside the span) covers every diagonal of a
    query of up to 24 residues against a subject of up to 40: the banded
    score is the unbanded sw_full score."""
    mat = padded_matrix(name, hard_stop=True)
    Lq, band, N = 24, 64, 24
    q = np.full((N, Lq), 25, np.int8)     # PAD tails
    w = np.full((N, Lq + band), SENTINEL, np.int8)
    lo = np.full(N, Lq - 1, np.int32)
    hi = np.zeros(N, np.int32)
    pairs = []
    for n in range(N):
        ln, m = int(rng.integers(4, Lq + 1)), int(rng.integers(4, 41))
        qq = rng.integers(0, 20, ln).astype(np.int8)
        t = rng.integers(0, 20, m).astype(np.int8)
        if n % 2:   # related pairs: a copy of the query with changes
            k = min(ln, m)
            t[:k] = np.where(rng.random(k) < 0.2, t[:k], qq[:k])
        q[n, :ln] = qq
        w[n, Lq - 1:Lq - 1 + m] = t
        hi[n] = Lq - 1 + m
        pairs.append((qq, t))
    s, _, _ = _plain(route, mat, plain, q, w, lo, hi, band)
    want = [oracle.sw_full(a.astype(np.int64), b.astype(np.int64), mat, GO,
                           GE) for a, b in pairs]
    np.testing.assert_array_equal(s, want)
    assert max(want) > 30


@pytest.mark.parametrize("route,name,plain", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_plain_sw_equals_sw_banded(rng, route, name, plain):
    """Score and endpoint of each alignment, the window all in span: the
    plain version equals the scalar banded oracle ((-1, -1) where the
    score is 0)."""
    mat = padded_matrix(name, hard_stop=True)
    Lq, band, N = 40, 32, 32
    q = rng.integers(0, 20, (N, Lq)).astype(np.int8)
    w = rng.integers(0, 20, (N, Lq + band)).astype(np.int8)
    w[::2, 8:8 + Lq] = q[::2]
    q[3, 30:] = 25                  # a PAD tail
    w[5, 20] = 23                   # a stop (a LOW column)
    lo = np.zeros(N, np.int32)
    hi = np.full(N, Lq + band, np.int32)
    s, ie, be = _plain(route, mat, plain, q, w, lo, hi, band)
    for n in range(N):
        sc, i, b = oracle.sw_banded(q[n].astype(np.int64),
                                    w[n].astype(np.int64), 0, band, mat,
                                    GO, GE)
        assert (s[n], ie[n], be[n]) == ((sc, i, b) if sc > 0
                                        else (0, -1, -1)), n
