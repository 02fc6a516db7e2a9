"""Banded Smith-Waterman in plain PyTorch + traceback support.

Port of the JAX package's kernels/sw_xla.py, same cell semantics and
tie-breaks (the contract of ghostm_tpu.oracle.sw_banded). Three uses:
  1. the plain version of kernel B3 (kernels/sw_fused.py);
  2. the FINAL-HIT path: `sw_banded_moves` records per-cell traceback moves
     so the engine can recover start coordinates and alignment statistics
     for the few reported hits (the plain version of the refine kernel
     R1, kernels/refine.py);
  3. the CPU path of the engine.

The in-row E dependency (gap-in-query) is resolved with an EXACT prefix
max-scan: E[b] = max_{b'<b}(Ht[b'] + b'*ge) - (open+ext) - (b-1)*ge, where Ht
is H computed without E. Opening a gap out of a gap-end cell is dominated
whenever open >= 0, so the scan over Ht is exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

NEG = -(1 << 30)
MASKED_I8 = -128  # int8 sentinel meaning "hard-masked cell" (widens to NEG)


def skewed_windows(windows: torch.Tensor, Lq: int, band: int) -> torch.Tensor:
    """(N, >= Lq + band) -> (N, Lq, band) view with [n, i, b] = w[n, i + b]."""
    return windows.unfold(1, band, 1)[:, :Lq]


def banded_scores(qcodes: torch.Tensor, windows: torch.Tensor,
                  matrix: torch.Tensor, band: int) -> torch.Tensor:
    """(N, Lq, band) int32 with sc[n, i, b] = matrix[q[n, i], w[n, i + b]]
    — a plain gather (the JAX package's one-hot contractions exist only
    because the TPU has no gather). Codes must lie in [0, 32)."""
    Lq = qcodes.shape[1]
    q = qcodes.to(torch.int32)[:, :, None]
    t = skewed_windows(windows, Lq, band).to(torch.int32)
    flat = (q * 32 + t).reshape(-1)
    return matrix.to(torch.int32).reshape(-1)[flat].reshape(t.shape)


def in_span(g0, lo, hi, Lq: int, band: int) -> torch.Tensor:
    """(N, Lq, band) bool: cell (i, b) lies in the subject span, i.e.
    g0 + i + b is in [lo, hi)."""
    dev = g0.device
    iota_ib = (torch.arange(Lq, dtype=torch.int32, device=dev)[:, None]
               + torch.arange(band, dtype=torch.int32, device=dev)[None, :])
    j = g0.to(torch.int32)[:, None, None] + iota_ib[None]
    return (j >= lo.to(torch.int32)[:, None, None]) & (
        j < hi.to(torch.int32)[:, None, None])


def banded_scores_i8(qcodes, windows, matrix, band: int, g0, lo, hi
                     ) -> torch.Tensor:
    """banded_scores + subject-span masking, packed to int8 tiles: cells
    with g0 + i + b outside [lo, hi) and cells whose matrix entry is LOW
    become MASKED_I8; everything else is the raw matrix value."""
    sc = banded_scores(qcodes, windows, matrix, band)
    keep = in_span(g0, lo, hi, qcodes.shape[1], band) & (sc > -100)
    return torch.where(keep, sc.clamp(-100, 127),
                       torch.full_like(sc, MASKED_I8)).to(torch.int8)


def widen_scores(s: torch.Tensor) -> torch.Tensor:
    """int8 masked tile -> int32 DP scores (MASKED_I8 -> NEG); int32 passes
    through unchanged."""
    if s.dtype == torch.int8:
        return torch.where(s == MASKED_I8, torch.full(s.shape, NEG,
                           dtype=torch.int32, device=s.device),
                           s.to(torch.int32))
    return s.to(torch.int32)


def _shl(x: torch.Tensor) -> torch.Tensor:
    """x[:, b + 1], NEG past the last diagonal."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], NEG)], dim=1)


def _consts(B: int, go1: int, ge: int, dev):
    ar = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    return ar * ge, go1 + (ar - 1) * ge   # bext, cvec


def _prefix_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix max along dim 1 by log2(B) shift-and-max steps
    (torch.cummax also computes indices: on the GPU it cost 0.8 ms a row of
    the refine DP, over 10x these steps)."""
    d = 1
    while d < x.shape[1]:
        x = torch.cat([x[:, :d], torch.maximum(x[:, d:], x[:, :-d])], dim=1)
        d *= 2
    return x


def _row(H, F, s, go1: int, ge: int, bext, cvec):
    """One row of the banded DP (sw_xla._row_step) -> (Hn, Fn, E,
    f_open_src, f_ext_src)."""
    f_open_src = _shl(H) - go1
    f_ext_src = _shl(F) - ge
    Fn = torch.maximum(f_open_src, f_ext_src)
    Ht = torch.clamp_min(torch.maximum(H + s, Fn), 0)
    ic = _prefix_max(Ht + bext)
    P = torch.cat([torch.full_like(ic[:, :1], NEG), ic[:, :-1]], dim=1)
    E = P - cvec
    return torch.maximum(Ht, E), Fn, E, f_open_src, f_ext_src


def _finalize(bestH, bestI, band: int):
    """Reduce (N, B) per-diagonal bests to (score, i_end, b_end) with the
    contract tie-break: max score, then min i, then min b."""
    big = torch.full_like(bestH, 1 << 30)
    score = bestH.max(dim=1).values
    m1 = bestH == score[:, None]
    i_end = torch.where(m1, bestI, big).min(dim=1).values
    m2 = m1 & (bestI == i_end[:, None])
    barange = torch.arange(band, dtype=torch.int32,
                           device=bestH.device).expand_as(bestH)
    b_end = torch.where(m2, barange, big).min(dim=1).values
    empty = score <= 0
    neg1 = torch.full_like(i_end, -1)
    return score, torch.where(empty, neg1, i_end), torch.where(empty, neg1,
                                                                 b_end)


def _init(N: int, B: int, dev):
    z = torch.zeros((N, B), dtype=torch.int32, device=dev)
    return z, torch.full_like(z, NEG), z.clone(), z.clone()


def sw_banded(sc: torch.Tensor, gap_open: int, gap_extend: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched banded SW over precomputed scores: sc (N, Lq, B) int32 or
    int8 masked tiles -> (score, i_end, b_end), each (N,) int32."""
    sc = widen_scores(sc)
    N, Lq, B = sc.shape
    go1, ge = gap_open + gap_extend, gap_extend
    bext, cvec = _consts(B, go1, ge, sc.device)
    H, F, bestH, bestI = _init(N, B, sc.device)
    for i in range(Lq):
        H, F, _, _, _ = _row(H, F, sc[:, i], go1, ge, bext, cvec)
        better = H > bestH
        bestH = torch.where(better, H, bestH)
        bestI = torch.where(better, torch.full_like(bestI, i), bestI)
    return _finalize(bestH, bestI, B)


# --- moves variant (final hits only) -------------------------------------
# Move encoding per cell, packed in one uint8:
#   bits 0-1: H choice — 0 stop(0), 1 diag, 2 E(left), 3 F(up)
#   bit  2:   E opened here (came from Ht[b-1]-go1) vs extended
#   bit  3:   F opened here (came from H[i-1,b+1]-go1) vs extended
# Tie priority for H: diag > E > F > stop (deterministic stats).

def sw_banded_moves(sc: torch.Tensor, gap_open: int, gap_extend: int):
    """sw_banded that also records the (N, Lq, B) uint8 move planes."""
    sc = widen_scores(sc)
    N, Lq, B = sc.shape
    go1, ge = gap_open + gap_extend, gap_extend
    bext, cvec = _consts(B, go1, ge, sc.device)
    H, F, bestH, bestI = _init(N, B, sc.device)
    moves = torch.empty((N, Lq, B), dtype=torch.uint8, device=sc.device)
    one, two, three = (torch.full_like(H, v) for v in (1, 2, 3))
    for i in range(Lq):
        s = sc[:, i]
        Hn, Fn, E, f_open_src, f_ext_src = _row(H, F, s, go1, ge, bext, cvec)
        f_open = f_open_src >= f_ext_src
        # E origin: opened from the immediately-left final H, else extension
        h_left = torch.cat([torch.full_like(Hn[:, :1], NEG), Hn[:, :-1]], 1)
        e_open = (h_left - go1) >= E
        hc = torch.where(
            Hn == 0, torch.zeros_like(H),
            torch.where(H + s == Hn, one, torch.where(E == Hn, two, three)),
        )
        moves[:, i] = (hc | (e_open.to(torch.int32) << 2)
                       | (f_open.to(torch.int32) << 3)).to(torch.uint8)
        better = Hn > bestH
        bestH = torch.where(better, Hn, bestH)
        bestI = torch.where(better, torch.full_like(bestI, i), bestI)
        H, F = Hn, Fn
    score, i_end, b_end = _finalize(bestH, bestI, B)
    return score, i_end, b_end, moves


def traceback_stats_device(moves: torch.Tensor, ie: torch.Tensor,
                           be: torch.Tensor, qc: torch.Tensor,
                           w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Vectorised traceback walk on the tensors' device (mirrors
    report.traceback_stats and the JAX package's traceback_stats_device).
    The move byte of the current cell is a gather; bit 4 carries the
    diagonal match bit q[i] == w[i + b]."""
    n, Lq, B = moves.shape
    dev = moves.device
    i = ie.to(torch.int32)
    b = be.to(torch.int32)
    alive = i >= 0
    neg1 = torch.full_like(i, -1)
    st = torch.where(alive, torch.zeros_like(i), torch.full_like(i, 3))
    qstart = torch.where(alive, i, neg1)
    sstart = torch.where(alive, i + b, neg1)
    zeros = torch.zeros_like(i)
    length, matches, mismatch, gapopen = zeros, zeros, zeros, zeros
    eq_plane = (qc.to(torch.int32)[:, :, None]
                == skewed_windows(w, Lq, B).to(torch.int32))
    mvi = (moves.to(torch.int32) | (eq_plane.to(torch.int32) << 4)
           ).reshape(n, Lq * B)
    # the iteration BOUND is 2*(Lq+B)+4; finished rows are no-ops, so
    # stopping once every row is done is bit-identical to the full bound
    bound = 2 * (Lq + B) + 4
    for t in range(bound):
        if t % 8 == 0 and not bool((st < 3).any()):
            break
        ii = i.clamp(0, Lq - 1)
        bb = b.clamp(0, B - 1)
        mv = torch.gather(mvi, 1, (ii * B + bb).to(torch.int64)[:, None])[:, 0]
        inH = st == 0
        c = mv & 3
        stop = inH & ((c == 0) | (i < 0) | (b < 0) | (b >= B))
        go = inH & ~stop
        diag = go & (c == 1)
        toE = go & (c == 2)
        toF = go & (c == 3)
        eq = (((mv >> 4) & 1) == 1) & diag
        matches = matches + eq.to(torch.int32)
        mismatch = mismatch + (diag & ~eq).to(torch.int32)
        length = length + diag.to(torch.int32)
        qstart = torch.where(diag, i, qstart)
        sstart = torch.where(diag, i + b, sstart)
        i = torch.where(diag, i - 1, i)
        st = torch.where(stop, torch.full_like(st, 3), st)
        st = torch.where(toE, torch.ones_like(st), st)
        st = torch.where(toF, torch.full_like(st, 2), st)
        inE = st == 1
        eopen = ((mv >> 2) & 1) == 1
        length = length + inE.to(torch.int32)
        sstart = torch.where(inE, i + b - 1, sstart)
        b = torch.where(inE, b - 1, b)
        gapopen = gapopen + (inE & eopen).to(torch.int32)
        st = torch.where(inE & eopen, torch.zeros_like(st), st)
        inF = st == 2
        fopen = ((mv >> 3) & 1) == 1
        length = length + inF.to(torch.int32)
        qstart = torch.where(inF, i, qstart)
        i = torch.where(inF, i - 1, i)
        b = torch.where(inF, b + 1, b)
        gapopen = gapopen + (inF & fopen).to(torch.int32)
        st = torch.where(inF & fopen, torch.zeros_like(st), st)
        st = torch.where((st == 0) & (i < 0), torch.full_like(st, 3), st)
    empty = ie < 0
    ie32 = ie.to(torch.int32)
    return {
        "qstart": torch.where(empty, neg1, qstart),
        "qend": torch.where(empty, neg1, ie32),
        "sstart": torch.where(empty, neg1, sstart),
        "send": torch.where(empty, neg1, ie32 + be.to(torch.int32)),
        "length": length, "matches": matches,
        "mismatch": mismatch, "gapopen": gapopen,
    }
