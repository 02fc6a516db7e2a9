"""Seeded refine inputs (numpy) shared by tests/test_torch_refine.py (the
plain version against the JAX package on the CPU) and
tests/test_torch_cuda.py (the kernel against the plain version on the
card). Imports neither JAX nor torch."""

import numpy as np

# the (matrix, gap_open, gap_extend) configurations: the engine's two
# defaults, PAM30, and the gap costs whose edge move bits differ (a free
# open: f_open at the band's last diagonal; a free extension: e_open at
# its first)
CONFIGS = {
    "b62": ("BLOSUM62", 11, 1),
    "b50": ("BLOSUM50", 13, 2),
    "pam30": ("PAM30", 9, 1),
    "open0": ("BLOSUM62", 0, 1),
    "ext0": ("BLOSUM62", 5, 0),
}


def make_case(seed: int, R: int, K: int, Lq: int, band: int):
    """(qcodes3 (R, 6, Lq) int8, packed (9, R, K) int32, w (N, Lq + band)
    int8, lo, hi (N,) int32), N = R * K. Hit n's kind is n % 8:
      0 related (its query frame on a random diagonal), the span wide;
      1 related with a deletion, 2 with an insertion (gaps in the walk);
      3 unrelated;
      4 related, the span cutting the window's start and end;
      5 dead: the window wholly outside the span (score 0, i_end -1);
      6 the query copied twice, half a band apart (equal scores on two
        diagonals: the tie-break);
      7 g0 near the int32 maximum, so that g0 + i + b wraps."""
    rng = np.random.default_rng(seed)
    N = R * K
    W = Lq + band
    q3 = rng.integers(0, 24, (R, 6, Lq)).astype(np.int8)
    # rows other than the frame (2) and g0 (6) are not read by refine
    packed = rng.integers(-50, 50, (9, R, K)).astype(np.int32)
    # frames: the engine's rank gives 0..5; 6 is clamped to 5 (as JAX's
    # gather clamps it). No negative frame: JAX wraps -1 to 5 where the
    # port's contract clamps it to 0, and no caller passes one.
    packed[2] = rng.integers(0, 7, (R, K))
    g0 = rng.integers(0, 100_000, N).astype(np.int64)
    w = rng.integers(0, 26, (N, W)).astype(np.int8)
    lo = g0 - rng.integers(0, 8, N)
    hi = g0 + W + rng.integers(-4, 8, N)
    frame = np.clip(packed[2].reshape(-1), 0, 5)
    for n in range(N):
        q = q3[n // K, frame[n]]
        kind = n % 8
        d = int(rng.integers(0, band))
        if kind in (0, 1, 2, 4):
            seg = q.copy()
            if kind in (1, 2) and Lq >= 8:
                cut = int(rng.integers(Lq // 4, 3 * Lq // 4))
                gap = int(rng.integers(1, 4))
                if kind == 1:   # subject lacks `gap` residues of the query
                    seg = np.concatenate([q[:cut], q[cut + gap:]])
                else:           # subject has `gap` extra residues
                    seg = np.concatenate([q[:cut], rng.integers(
                        0, 20, gap).astype(np.int8), q[cut:]])
            seg = seg[:W - d]
            w[n, d:d + len(seg)] = seg
            if kind == 4:
                lo[n] = g0[n] + Lq // 3
                hi[n] = g0[n] + W - band // 2
        elif kind == 5:
            hi[n] = g0[n] - int(rng.integers(0, 3))
        elif kind == 6:
            h = max(band // 2, 1)
            w[n, :Lq] = q
            w[n, h:h + Lq] = q
            lo[n], hi[n] = g0[n] - 1, g0[n] + W + 1
        elif kind == 7:
            g0[n] = (1 << 31) - 1 - int(rng.integers(0, W))
            lo[n], hi[n] = g0[n] - 4, (1 << 31) - 1
            w[n, d:d + Lq] = q
    packed[6] = g0.reshape(R, K)
    return q3, packed, w, lo.astype(np.int32), hi.astype(np.int32)
