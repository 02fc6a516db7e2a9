"""A numpy transcription of csrc/refine.cu's arithmetic, for the CPU tests
(tests/test_torch_refine.py holds it against the plain version): the DP's
lane-split row step in either layout (lanes an alignment x diagonals a
lane: the registers, F and E held plus go1, the shuffles from the next
and the previous lane, the max-plus scan of E over the lanes as a plain
prefix max of a position-shifted value, the edge rules) and the warp
layout's staged walk (its block arithmetic over the alignment-major byte
plane). Vectorised over hits and lanes; a loop over rows and over a
lane's diagonals, in the kernel's order. Imports neither JAX nor torch.
"""

import numpy as np

NEG = -(1 << 30)
INT_MIN = -(1 << 31)
MASK_CODE = 32
WALK_BYTES = 4096


def window_codes(w, g0, lo, hi, P):
    """(N, P) window codes as the kernel reads them (rcode): w & 31, or
    MASK_CODE past the window or where g0 + p (int32, wrapping) lies
    outside [lo, hi)."""
    N, Wl = w.shape
    p = np.arange(P)
    j = (g0.astype(np.int64)[:, None] + p + (1 << 31)) % (1 << 32) - (1 << 31)
    ok = (p < Wl)[None] & (j >= lo[:, None]) & (j < hi[:, None])
    raw = np.zeros((N, P), np.int64)
    raw[:, :min(P, Wl)] = w[:, :P].astype(np.int64) & 31
    return np.where(ok, raw, MASK_CODE)


def lane_split_moves(qc, codes, table, band, go, ge, lanes, diags):
    """The kernel's DP at (lanes, diags): qc (N, Lq) query codes, codes
    (N, >= Lq + lanes * diags) window codes (window_codes), table the
    (32, 33) score table -> (score, i_end, b_end, moves (N, Lq, band)
    uint8)."""
    N, Lq = qc.shape
    G, D = lanes, diags
    go1 = go + ge
    lane = np.arange(G)
    diag = lane[:, None] * D + np.arange(D)          # (G, D): b of a register
    nb = np.clip(band - lane * D, 0, D)              # a lane's diagonals in band
    H = np.zeros((N, G, D), np.int64)
    F = np.full((N, G, D), NEG + go1, np.int64)      # F1 = F + go1
    best = np.zeros((N, G), np.int64)
    bi = np.zeros((N, G), np.int64)
    moves = np.zeros((N, Lq, G * D), np.uint8)
    neg = np.full((N, 1), NEG, np.int64)
    zoff = (lane + 1) * D * ge                       # the scan's position term
    for i in range(Lq):
        s = table[(qc[:, i] & 31)[:, None],
                  codes[:, i + diag.reshape(-1)]].reshape(N, G, D)
        # H and F1 of diagonal b + 1 for a lane's last register: the next
        # lane's first (a shuffle down), NEG at the last lane
        hup = np.concatenate([H[:, 1:, 0], neg], 1)
        fup = np.concatenate([F[:, 1:, 0], neg + go1], 1)
        fo = np.zeros((N, G, D), bool)
        dg = np.zeros((N, G, D), bool)
        acc = np.full((N, G), NEG, np.int64)
        for k in range(D):     # pass 1: F1, f_open, Ht, diag
            hu = H[:, :, k + 1] if k < D - 1 else hup
            fu = F[:, :, k + 1] if k < D - 1 else fup
            past = diag[:, k] + 1 >= band
            hu = np.where(past, NEG, hu)
            fu = np.where(past, NEG + go1, fu)
            fe1 = fu - ge
            fo[:, :, k] = hu >= fe1
            F[:, :, k] = np.maximum(hu, fe1)
            hs = H[:, :, k] + s[:, :, k]
            H[:, :, k] = np.maximum(np.maximum(F[:, :, k] - go1, hs), 0)
            dg[:, :, k] = hs == H[:, :, k]
            acc = np.maximum(acc - ge, H[:, :, k])   # E1 leaving the lane
        x, d = acc + zoff, 1   # a plain prefix max over the lanes
        while d < G:
            y = np.concatenate([x[:, :d], x[:, :-d]], 1)
            x = np.maximum(x, y)
            d *= 2
        e1 = np.concatenate([np.full((N, 1), NEG + ge, np.int64),
                             x[:, :-1] - zoff[:-1]], 1)
        e10 = e1.copy()
        hl = np.full((N, G), NEG, np.int64)
        rk = np.full((N, G), INT_MIN, np.int64)
        byte = np.zeros((N, G, D), np.int64)
        for k in range(D):     # pass 2: Hn, hc, e_open, the row's best
            ht = H[:, :, k]
            e = e1 - go1
            hn = np.maximum(ht, e)
            c = np.where(e == ht, 2, 3)
            c = np.where(dg[:, :, k], 1, c)
            c = np.where(ht >= e, c, 2)
            c = np.where(hn == 0, 0, c)
            byte[:, :, k] = c | (hl >= e1) << 2 | fo[:, :, k] << 3
            e1 = np.maximum(e1 - ge, ht)
            H[:, :, k] = hn
            hl = hn
            rk = np.where(k < nb, np.maximum(rk, hn * 32 + 31 - k), rk)
        # e_open at a lane's first diagonal: the previous lane's final H
        hleft = np.concatenate([neg, H[:, :-1, D - 1]], 1)
        byte[:, :, 0] = byte[:, :, 0] & ~4 | (hleft >= e10) << 2
        moves[:, i] = byte.reshape(N, G * D)
        better = (rk >> 5) > (best >> 5)
        best = np.where(better, rk, best)
        bi = np.where(better, i, bi)
    # sw_finalize over the lanes: max H, then min i, then min b
    bH, bb = best >> 5, lane * D + 31 - (best & 31)
    ok = bb < band
    score = np.maximum(np.where(ok, bH, 0).max(1), 0)
    m1 = ok & (bH == score[:, None])
    ci = np.where(m1, bi, 1 << 30).min(1)
    cb = np.where(m1 & (bi == ci[:, None]), bb, 1 << 30).min(1)
    dead = score <= 0
    return (score, np.where(dead, -1, ci), np.where(dead, -1, cb),
            moves[:, :, :band])


def byte_plane(moves):
    """The warp layout's plane of (N, Lq, band) moves: (N, S) bytes, a row
    round_up(band, 4) bytes, S = Lq * that rounded up to 16."""
    N, Lq, band = moves.shape
    bp = -(-band // 4) * 4
    S = -(-Lq * bp // 16) * 16
    plane = np.zeros((N, S), np.uint8)
    rows = np.zeros((N, Lq, bp), np.uint8)
    rows[:, :, :band] = moves
    plane[:, :Lq * bp] = rows.reshape(N, -1)
    return plane


def staged_walk(plane, ie, be, qraw, wraw, Lq, band, rows=None):
    """The warp layout's walk: for each hit, blocks of T rows (T = the
    walk block's bytes over a row's, a multiple of 4; `rows` overrides
    it) copied from its plane, lane 0's state machine on the block (runs
    of diagonal moves in a tight loop), the block below once the walk
    leaves it. -> the 8 stat rows (N,) each."""
    N = plane.shape[0]
    bp = -(-band // 4) * 4
    T = rows if rows is not None else (WALK_BYTES // bp) & ~3
    TB = T * bp
    bound = 2 * (Lq + band) + 4
    out = np.zeros((8, N), np.int64)
    for n in range(N):
        i, b = int(ie[n]), int(be[n])
        st = 0 if i >= 0 else 3
        qstart, sstart = (i, i + b) if i >= 0 else (-1, -1)
        length = matches = mismatch = gapopen = t = 0
        k = min(i, Lq - 1) // T if st != 3 else 0
        while st != 3:
            blk = plane[n, k * TB:k * TB + TB]
            base = k * T
            while t < bound and st != 3:
                ii, bb = min(max(i, 0), Lq - 1), min(max(b, 0), band - 1)
                if ii < base:
                    break
                mv = int(blk[(ii - base) * bp + bb])
                if st == 0 and mv & 3 == 1 and b == bb:
                    # a run of diagonal moves: up a row while the moves
                    # stay diagonal, the block and the step bound last
                    stop = max(base, i - (bound - t) + 1)
                    c = 1
                    while c == 1:
                        eq = int(qraw[n, i] == wraw[n, i + bb])
                        matches += eq
                        mismatch += 1 - eq
                        length += 1
                        qstart, sstart = i, i + bb
                        i -= 1
                        t += 1
                        c = int(blk[(i - base) * bp + bb]) & 3 \
                            if i >= stop else 0
                    if i < 0:
                        st = 3
                    continue
                if st == 0:
                    c = mv & 3
                    if c == 0 or i < 0 or b < 0 or b >= band:
                        st = 3
                    elif c == 1:
                        eq = int(qraw[n, ii] == wraw[n, ii + bb])
                        matches += eq
                        mismatch += 1 - eq
                        length += 1
                        qstart, sstart = i, i + b
                        i -= 1
                    else:
                        st = 1 if c == 2 else 2
                if st == 1:
                    length += 1
                    sstart = i + b - 1
                    b -= 1
                    if (mv >> 2) & 1:
                        gapopen += 1
                        st = 0
                elif st == 2:
                    length += 1
                    qstart = i
                    i -= 1
                    b += 1
                    if (mv >> 3) & 1:
                        gapopen += 1
                        st = 0
                if st == 0 and i < 0:
                    st = 3
                t += 1
            if t >= bound:
                st = 3
            k -= 1
        e = ie[n] < 0
        out[:, n] = (-1 if e else qstart, ie[n], -1 if e else sstart,
                     -1 if e else ie[n] + be[n], length, matches, mismatch,
                     gapopen)
    return out
