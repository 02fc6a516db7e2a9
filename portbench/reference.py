"""The plain reference of the search: what `aln` has to write for each read.

Plain PyTorch and numpy, importing nothing of the program: a frozen copy
of the semantics of the port's CPU path (the plain versions of its
kernels), cut to what the benchmark's configurations run: one shard
(a sharded index has to write the same rows), every seed position that
`db`'s global bucket cap keeps, the vote on 64-bit keys (any subject
count; with collinear chaining where `chain_gamma` > 0), banded
Smith-Waterman over the subject span, the per-read rank, the moves DP
and traceback, and the m8 columns. It builds its own seed index from
the benchmark's proteins (on the device it is given, by one sort) and
formats its own rows, so it shares no table with the program.

`saturate` (the control): every DP cell is held at or below that value,
as an 8-bit saturating DP that skips the wider recompute would hold it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.simulate import AA_ALPHABET

NFRAMES = 6
BIG = 1 << 30
# the invalid vote key: above every subject * nbins + bin of any database
# (570,000 subjects of 2,205 bins reach 2^30 already)
NO_KEY = 1 << 62
NEG = -(1 << 30)
LOW = -(1 << 20)
PAD = 25
# hit keys a propose pass holds: at long frames (Lq 3,456 x 128 seeds a
# k-mer, 442,368 a frame) 2,048 frames would hold 0.9 G int64 keys, and the
# vote's sort and chain scan several copies of them
PROPOSE_KEYS = 1 << 26
AA_X, AA_STOP = 22, 23

_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""
MATRICES = {"BLOSUM62": np.array([[int(v) for v in r.split()] for r in
                                  _B62.strip().splitlines()], np.int32)}
# NCBI BLAST's published gapped Karlin-Altschul (lambda, K, H)
KA_PARAMS = {("BLOSUM62", 11, 1): (0.267, 0.041, 0.14)}

_CODONS = {
    "F": "TTT TTC", "L": "TTA TTG CTT CTC CTA CTG", "I": "ATT ATC ATA",
    "M": "ATG", "V": "GTT GTC GTA GTG", "S": "TCT TCC TCA TCG AGT AGC",
    "P": "CCT CCC CCA CCG", "T": "ACT ACC ACA ACG", "A": "GCT GCC GCA GCG",
    "Y": "TAT TAC", "*": "TAA TAG TGA", "H": "CAT CAC", "Q": "CAA CAG",
    "N": "AAT AAC", "K": "AAA AAG", "D": "GAT GAC", "E": "GAA GAG",
    "C": "TGT TGC", "W": "TGG", "R": "CGT CGC CGA CGG AGA AGG",
    "G": "GGT GGC GGA GGG",
}


def codon_table() -> np.ndarray:
    """(5, 5, 5) amino-acid code of each codon; any N (4) gives X."""
    t = np.full((5, 5, 5), AA_X, np.int64)
    for aa, cs in _CODONS.items():
        for c in cs.split():
            t["ACGT".index(c[0]), "ACGT".index(c[1]), "ACGT".index(c[2])] = \
                AA_ALPHABET.index(aa)
    return t


def score_matrix(name: str) -> np.ndarray:
    """(32, 32) scores: the matrix, LOW for the sentinel, the query pad and
    the stop codon (an alignment never spans a stop)."""
    m = np.full((32, 32), LOW, np.int32)
    m[:24, :24] = MATRICES[name]
    m[AA_STOP, :] = LOW
    m[:, AA_STOP] = LOW
    return m


# --------------------------------------------------------------------------
# translation
# --------------------------------------------------------------------------

def six_frames(dna: np.ndarray, lens: np.ndarray, Lq: int) -> np.ndarray:
    """(R, W) DNA codes (N = 4 past each read) -> (R, 6, Lq) residue codes:
    frames 0-2 the forward strand from offsets 0-2, 3-5 the reverse
    complement's; codons past the read, and past Lq, are PAD."""
    R, W = dna.shape
    lens = np.asarray(lens, np.int64)
    pos = np.arange(W)[None, :]
    comp = np.array([3, 2, 1, 0, 4], np.int64)
    d = np.clip(dna.astype(np.int64), 0, 4)
    rc = comp[np.take_along_axis(d, np.clip(lens[:, None] - 1 - pos, 0,
                                            W - 1), 1)]
    rc[pos >= lens[:, None]] = 4
    tab = codon_table()
    out = np.full((R, NFRAMES, Lq), PAD, np.int8)
    for s, src in enumerate((d, rc)):
        for off in range(3):
            n = min(Lq, max(0, (W - off) // 3))
            c = src[:, off:off + 3 * n].reshape(R, n, 3)
            aa = tab[c[..., 0], c[..., 1], c[..., 2]]
            ok = np.arange(n)[None, :] < (lens[:, None] - off) // 3
            out[:, 3 * s + off, :n] = np.where(ok, aa, PAD)
    return out


# --------------------------------------------------------------------------
# the seed index: db's global per-k-mer cap, kept positions by k-mer
# --------------------------------------------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    m = 0xFFFFFFFF
    x = x & m
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & m
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & m
    return x ^ (x >> 16)


class SeedIndex:
    """Every k-mer position of the database that `db` keeps: per k-mer
    (20^k keys; windows with a code >= 20 hold none) at most `cap`
    positions, chosen by a hash of (subject id, offset), ties in
    (subject, offset) order. Held as (key, subject, offset) sorted by
    key, with each key's first entry."""

    def __init__(self, codes: np.ndarray, lens: np.ndarray, k: int,
                 cap: int, device):
        dev = torch.device(device)
        lens_t = torch.as_tensor(np.asarray(lens, np.int64), device=dev)
        c = torch.as_tensor(np.asarray(codes, np.int8), device=dev)
        n = len(codes)
        first = torch.cumsum(lens_t, 0) - lens_t
        sid = torch.repeat_interleave(
            torch.arange(len(lens), device=dev), lens_t)
        off = torch.arange(n, device=dev) - first[sid]
        nwin = max(n - k + 1, 0)
        key = torch.zeros(nwin, dtype=torch.int64, device=dev)
        ok = off[:nwin] + k <= lens_t[sid[:nwin]]
        for t in range(k):
            ct = c[t:t + nwin].to(torch.int64)
            key = key * 20 + ct.clamp(0, 19)
            ok &= ct < 20
        key, sid, off = key[ok], sid[:nwin][ok], off[:nwin][ok]
        prio = _mix32(sid * 1_000_003 + off)
        order = torch.sort((key << 32) | prio, stable=True).indices
        key, sid, off = key[order], sid[order], off[order]
        del order, prio, ok
        idx = torch.arange(len(key), device=dev)
        new = torch.ones_like(key, dtype=torch.bool)
        new[1:] = key[1:] != key[:-1]
        head = torch.cummax(torch.where(new, idx, torch.zeros_like(idx)),
                            0).values
        keep = idx - head < cap
        self.key, self.sid = key[keep], sid[keep].to(torch.int32)
        self.off = off[keep].to(torch.int32)
        nb = 20 ** k
        # nb + 2 entries: the invalid key nb reads an empty bucket
        self.starts = torch.searchsorted(
            self.key, torch.arange(nb + 2, device=dev))
        counts = self.starts[1:nb + 1] - self.starts[:nb]
        self.width = int(counts.max()) if len(counts) else 0
        self.k, self.nb = k, nb


def kmer_keys(q: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, Lq) residue codes -> (Q, Lq) k-mer keys, 20^k where a window
    runs off the frame or holds a code >= 20."""
    Q, Lq = q.shape
    nb = 20 ** k
    key = torch.zeros((Q, Lq), dtype=torch.int64, device=q.device)
    ok = torch.ones((Q, Lq), dtype=torch.bool, device=q.device)
    qq = torch.cat([q.to(torch.int64),
                    torch.full((Q, k), 20, dtype=torch.int64,
                               device=q.device)], 1)
    for t in range(k):
        ct = qq[:, t:t + Lq]
        key = key * 20 + ct.clamp(0, 19)
        ok &= ct < 20
    return torch.where(ok, key, torch.full_like(key, nb))


# --------------------------------------------------------------------------
# propose: seed hits, the vote, the top candidates of each frame
# --------------------------------------------------------------------------

def _shift_in(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    head = torch.full((x.shape[0], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:, :-d]], dim=1)


def _chain(k, votes, first, valid, nbins: int, gamma: int):
    """Collinear chain scores: votes[i] + max(0, max over earlier runs j
    of the same subject of (votes of runs j..i-1) - gamma * (k[i] - k[j]))
    by a segmented (max, +) scan."""
    Q, M = k.shape
    zero = torch.zeros_like(k)
    kv = torch.where(valid, k, zero)
    row = k // nbins
    NC = -(1 << 40)
    A = torch.where(valid, votes + gamma * kv, torch.full_like(k, NC))
    B = votes
    F = torch.cat([torch.ones((Q, 1), dtype=torch.bool, device=k.device),
                   row[:, 1:] != row[:, :-1]], dim=1)
    d = 1
    while d < M:
        As, Bs, Fs = _shift_in(A, d, NC), _shift_in(B, d, 0), \
            _shift_in(F, d, True)
        A = torch.maximum(A, torch.where(F, torch.full_like(A, NC), As + B))
        B = torch.where(F, B, Bs + B)
        F = F | Fs
        d *= 2
    same = torch.cat([torch.zeros((Q, 1), dtype=torch.bool, device=k.device),
                      row[:, 1:] == row[:, :-1]], dim=1)
    rm_ex = torch.where(same, _shift_in(A, 1, NC), torch.full_like(A, NC))
    return torch.where(first, votes + (rm_ex - gamma * kv).clamp_min(0), zero)


def vote(keys: torch.Tensor, ncand: int, min_votes: int, nbins: int,
         chain_gamma: int):
    """(Q, M) int64 hit keys subject * nbins + bin (invalid: NO_KEY) ->
    the top ncand (key, votes) of each row by (votes desc, key asc); key
    NO_KEY where votes == 0. A run of one key is its votes, chained where
    chain_gamma > 0; rows below min_votes get none."""
    k = torch.sort(keys, dim=1).values
    Q, M = k.shape
    valid = k < NO_KEY
    first = torch.cat([valid[:, :1], (k[:, 1:] != k[:, :-1]) & valid[:, 1:]],
                      dim=1)
    idx = torch.arange(M, device=k.device).expand(Q, M)
    bnd = first | ~valid
    nxt = torch.cat([torch.where(bnd, idx, torch.full_like(idx, M))[:, 1:],
                     torch.full((Q, 1), M, dtype=idx.dtype,
                                device=k.device)], 1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), 1).values, [1])
    votes = torch.where(first, nxt - idx, torch.zeros_like(idx))
    if chain_gamma > 0:
        votes = _chain(k, votes, first, valid, nbins, chain_gamma)
    votes = torch.where(votes >= max(min_votes, 1), votes,
                        torch.zeros_like(votes))
    # (votes desc, position asc) == (votes desc, key asc) over run starts
    order = torch.sort(votes * (M + 1) + (M - idx), dim=1,
                       descending=True).indices[:, :ncand]
    v = torch.gather(votes, 1, order)
    key = torch.where(v > 0, torch.gather(k, 1, order),
                      torch.full_like(v, NO_KEY))
    return key, v


def propose(frames: torch.Tensor, sidx: SeedIndex, cfg: dict, nbins: int,
            chunk: int = 2048):
    """(Qf, Lq) frames -> (subject, bin), each (Qf, ncand) int64, BIG
    where the candidate has no votes. A seed at query position p and
    subject offset o votes for bin (o + Lq - p) // (band / 2). Frames go
    `chunk` at a time, fewer where their Lq x width hit keys would pass
    PROPOSE_KEYS."""
    Qf, Lq = frames.shape
    half = cfg["band_width"] // 2
    W = sidx.width
    chunk = max(1, min(chunk, PROPOSE_KEYS // max(Lq * W, 1)))
    outs = []
    slots = torch.arange(W, device=frames.device)
    qpos = torch.arange(Lq, device=frames.device)[None, :, None]
    for q in frames.split(chunk):
        kk = kmer_keys(q, sidx.k)
        st = sidx.starts[kk]
        live = slots[None, None, :] < (sidx.starts[kk + 1] - st)[..., None]
        j = (st[..., None] + slots).clamp(max=max(len(sidx.key) - 1, 0))
        sid = sidx.sid[j].to(torch.int64)
        off = sidx.off[j].to(torch.int64)
        keys = torch.where(live, sid * nbins + (off + Lq - qpos) // half,
                           torch.full_like(sid, NO_KEY))
        key, v = vote(keys.reshape(q.shape[0], -1),
                      cfg["candidates_per_frame"], cfg["min_votes"],
                      nbins, cfg.get("chain_gamma", 0))
        none = torch.full_like(key, BIG)
        outs.append((torch.where(v > 0, key // nbins, none),
                     torch.where(v > 0, key % nbins, none)))
    return tuple(torch.cat(x) for x in zip(*outs))


# --------------------------------------------------------------------------
# banded Smith-Waterman (scores, ends) and its moves for the traceback
# --------------------------------------------------------------------------

def _prefix_max(x: torch.Tensor) -> torch.Tensor:
    d = 1
    while d < x.shape[1]:
        x = torch.cat([x[:, :d], torch.maximum(x[:, d:], x[:, :-d])], dim=1)
        d *= 2
    return x


def banded_dp(q: torch.Tensor, w: torch.Tensor, inside: torch.Tensor,
              mat: torch.Tensor, B: int, gap_open: int, gap_extend: int,
              moves: bool, saturate: Optional[int] = None):
    """Banded local alignment of q (N, Lq) against windows w (N, >= Lq +
    B) -> (score, i_end, b_end[, moves (N, Lq, B) uint8]). Cell (i, b)
    pairs query residue i with window residue i + b and scores mat[q, w],
    or minus infinity where the window residue lies outside the subject
    (`inside`) or the entry is the matrix's LOW; F comes from (i - 1,
    b + 1), E along the row. The best cell: max score, then min i, then
    min b; (-1, -1) when the score is <= 0. A move byte: bits 0-1 H's
    choice (0 stop, 1 diag, 2 E, 3 F; diag > E > F on ties), bit 2 E
    opened, bit 3 F opened."""
    N, Lq = q.shape
    dev = q.device
    go1, ge = gap_open + gap_extend, gap_extend
    ar = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    bext, cvec = ar * ge, go1 + (ar - 1) * ge
    H = torch.zeros((N, B), dtype=torch.int64, device=dev)
    F = torch.full_like(H, NEG)
    bestH, bestI = torch.zeros_like(H), torch.zeros_like(H)
    negcol = torch.full_like(H[:, :1], NEG)
    q64 = q.to(torch.int64)
    mv = (torch.empty((N, Lq, B), dtype=torch.uint8, device=dev)
          if moves else None)
    for i in range(Lq):
        s = mat[q64[:, i:i + 1] * 32 + w[:, i:i + B]]
        s = torch.where(inside[:, i:i + B] & (s > -100), s, NEG)
        f_open = torch.cat([H[:, 1:], negcol], 1) - go1
        f_ext = torch.cat([F[:, 1:], negcol], 1) - ge
        Fn = torch.maximum(f_open, f_ext)
        Ht = torch.maximum(H + s, Fn).clamp_min(0)
        if saturate is not None:
            Ht = Ht.clamp_max(saturate)
        E = torch.cat([negcol, _prefix_max(Ht + bext)[:, :-1]], 1) - cvec
        Hn = torch.maximum(Ht, E)
        if moves:
            left = torch.cat([negcol, Hn[:, :-1]], 1)
            hc = torch.where(Hn == 0, 0, torch.where(
                H + s == Hn, 1, torch.where(E == Hn, 2, 3)))
            mv[:, i] = (hc | ((left - go1) >= E).to(torch.int64) << 2
                        | (f_open >= f_ext).to(torch.int64) << 3
                        ).to(torch.uint8)
        better = Hn > bestH
        bestH = torch.where(better, Hn, bestH)
        bestI = torch.where(better, i, bestI)
        H, F = Hn, Fn
    score = bestH.max(1).values
    m1 = bestH == score[:, None]
    ie = torch.where(m1, bestI, BIG).min(1).values
    be = torch.where(m1 & (bestI == ie[:, None]), ar.expand(N, B),
                     BIG).min(1).values
    empty = score <= 0
    ie, be = torch.where(empty, -1, ie), torch.where(empty, -1, be)
    return (score, ie, be, mv) if moves else (score, ie, be)


def traceback(mv: torch.Tensor, ie: torch.Tensor, be: torch.Tensor,
              q: torch.Tensor, w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Walk each alignment's moves back from its end -> qstart, qend,
    sstart, send (window-local, j = i + b), length, matches, mismatch,
    gapopen; -1 coordinates and zero counts where ie < 0."""
    n, Lq, B = mv.shape
    i, b = ie.clone(), be.clone()
    alive = i >= 0
    st = torch.where(alive, 0, 3)
    qstart = torch.where(alive, i, -1)
    sstart = torch.where(alive, i + b, -1)
    z = torch.zeros_like(i)
    length, matches, mism, gapo = z.clone(), z.clone(), z.clone(), z.clone()
    rows = torch.arange(n, device=mv.device)
    for t in range(2 * (Lq + B) + 4):
        if t % 8 == 0 and not bool((st < 3).any()):
            break
        ii, bb = i.clamp(0, Lq - 1), b.clamp(0, B - 1)
        m = mv[rows, ii, bb].to(torch.int64)
        inH = st == 0
        c = m & 3
        stop = inH & ((c == 0) | (i < 0) | (b < 0) | (b >= B))
        go = inH & ~stop
        diag, toE, toF = go & (c == 1), go & (c == 2), go & (c == 3)
        eq = diag & (q[rows, ii].to(torch.int64)
                     == w[rows, (ii + bb).clamp(0, w.shape[1] - 1)]
                     .to(torch.int64))
        matches += eq
        mism += diag & ~eq
        length += diag
        qstart = torch.where(diag, i, qstart)
        sstart = torch.where(diag, i + b, sstart)
        i = torch.where(diag, i - 1, i)
        st = torch.where(stop, 3, st)
        st = torch.where(toE, 1, st)
        st = torch.where(toF, 2, st)
        inE = st == 1
        eo = ((m >> 2) & 1) == 1
        length += inE
        sstart = torch.where(inE, i + b - 1, sstart)
        b = torch.where(inE, b - 1, b)
        gapo += inE & eo
        st = torch.where(inE & eo, 0, st)
        inF = st == 2
        fo = ((m >> 3) & 1) == 1
        length += inF
        qstart = torch.where(inF, i, qstart)
        i = torch.where(inF, i - 1, i)
        b = torch.where(inF, b + 1, b)
        gapo += inF & fo
        st = torch.where(inF & fo, 0, st)
        st = torch.where((st == 0) & (i < 0), 3, st)
    empty = ie < 0
    return dict(qstart=torch.where(empty, -1, qstart),
                qend=torch.where(empty, -1, ie),
                sstart=torch.where(empty, -1, sstart),
                send=torch.where(empty, -1, ie + be),
                length=length, matches=matches, mismatch=mism,
                gapopen=gapo)


class Database:
    """The proteins on the reference's device: the concatenated codes,
    each subject's first code and length."""

    def __init__(self, codes: np.ndarray, lens: np.ndarray, device):
        self.device = torch.device(device)
        self.lens = torch.as_tensor(np.asarray(lens, np.int64),
                                    device=self.device)
        self.first = torch.cumsum(self.lens, 0) - self.lens
        self.codes = torch.as_tensor(np.asarray(codes, np.int8),
                                     device=self.device)
        self.n = len(lens)
        self.residues = int(np.asarray(lens, np.int64).sum())
        self.max_len = int(np.asarray(lens).max())

    def windows(self, sid: torch.Tensor, o0: torch.Tensor, wl: int):
        """(N, wl) codes of subject sid from local offset o0 (24 outside
        the subject) and (N, wl) bool: inside it."""
        o = o0[:, None] + torch.arange(wl, device=self.device)[None, :]
        inside = (o >= 0) & (o < self.lens[sid][:, None])
        g = (self.first[sid][:, None] + o.clamp(min=0)).clamp(
            max=len(self.codes) - 1)
        return torch.where(inside, self.codes[g].to(torch.int64), 24), inside


def search(dna: np.ndarray, lens: np.ndarray, db: Database, sidx: SeedIndex,
           cfg: dict, saturate: Optional[int] = None):
    """The reported hits of each read: per read a list of K dicts (score,
    subject, frame, the refine stats, s_end), ranked by (-score, subject,
    frame, qend, s_end), candidate order last; score-0 entries included."""
    dev = db.device
    Lq, B = cfg["query_frame_len"], cfg["band_width"]
    C, K = cfg["candidates_per_frame"], cfg["max_hits"]
    half = B // 2
    mat = torch.as_tensor(score_matrix(cfg["matrix"]).reshape(-1),
                          dtype=torch.int64, device=dev)
    nbins = (db.max_len + Lq) // half + 2
    go, ge = cfg["gap_open"], cfg["gap_extend"]
    # reads a pass: ~32 M window cells
    chunk = max(1, (1 << 25) // (NFRAMES * C * (Lq + B)))
    out = []
    for r0 in range(0, len(lens), chunk):
        fr = torch.as_tensor(six_frames(dna[r0:r0 + chunk],
                                        lens[r0:r0 + chunk], Lq), device=dev)
        R = fr.shape[0]
        qf = fr.reshape(R * NFRAMES, Lq)
        sid, lbin = propose(qf, sidx, cfg, nbins)
        owned = sid < BIG
        sid0 = torch.where(owned, sid, 0)
        o0 = torch.where(owned, lbin * half - Lq - B // 4, 0).reshape(-1)
        qrep = qf.repeat_interleave(C, 0)
        w, inside = db.windows(sid0.reshape(-1), o0, Lq + B)
        score, ie, be = banded_dp(qrep, w, inside, mat, B, go, ge, False,
                                  saturate)
        score = torch.where(owned.reshape(-1) & (score > 0), score, 0)
        hit = score > 0
        qend = torch.where(hit, ie, 0)
        s_end = torch.where(hit, o0 + ie + be, 0)
        M = NFRAMES * C
        g = torch.where(hit, sid0.reshape(-1), BIG).reshape(R, M)
        frame = torch.arange(NFRAMES, device=dev).repeat_interleave(C)
        keys = [(-score).reshape(R, M), g, frame.expand(R, M),
                qend.reshape(R, M), s_end.reshape(R, M)]
        perm = torch.arange(M, device=dev).expand(R, M)
        for kk in reversed(keys):
            o = torch.sort(torch.gather(kk, 1, perm), dim=1,
                           stable=True).indices
            perm = torch.gather(perm, 1, o)
        perm = perm[:, :K]
        flat = (perm + torch.arange(R, device=dev)[:, None] * M).reshape(-1)
        # refine: the moves DP and the walk on the ranked hits' windows
        qk = qrep[flat]
        wk, ik = w[flat], inside[flat]
        _, ie2, be2, mv = banded_dp(qk, wk, ik, mat, B, go, ge, True,
                                    saturate)
        st = traceback(mv, ie2, be2, qk, wk)
        rows = dict(score=score[flat], subject=sid0.reshape(-1)[flat],
                    frame=torch.div(perm, C, rounding_mode="floor")
                    .reshape(-1), s_end=s_end[flat], **st)
        rows = {k: v.reshape(R, K).cpu().numpy() for k, v in rows.items()}
        out.extend({k: v[r] for k, v in rows.items()} for r in range(R))
    return out


# --------------------------------------------------------------------------
# the m8 rows
# --------------------------------------------------------------------------

def _length_adjustment(k: float, h: float, m: np.ndarray, n: float,
                       num_seqs: int) -> np.ndarray:
    m = np.asarray(m, np.float64)
    num_seqs = max(int(num_seqs), 1)
    logk, floor_len = math.log(k), 1.0 / k
    ell = np.zeros_like(m)
    for _ in range(20):
        me = np.maximum(m - ell, floor_len)
        ne = np.maximum(n - num_seqs * ell, floor_len)
        ell = np.clip((logk + np.log(me * ne)) / h, 0.0, None)
    return np.floor(ell)


def m8_rows(name: str, read_len: int, hits: dict, subject_name,
            cfg: dict, residues: int, nseqs: int) -> List[str]:
    """One read's m8 rows, as `aln` formats them: rank order, score > 0
    and E <= the cutoff; E and the bit score from BLAST's gapped
    Karlin-Altschul constants with its finite-size length adjustment."""
    lam, kk, hh = KA_PARAMS[(cfg["matrix"], cfg["gap_open"],
                             cfg["gap_extend"])]
    sc = hits["score"].astype(np.int64)
    m = np.full(len(sc), max(read_len // 3, 1), np.float64)
    ell = _length_adjustment(kk, hh, m, float(residues), nseqs)
    me = np.maximum(m - ell, 1.0 / kk)
    ne = np.maximum(float(residues) - nseqs * ell, 1.0 / kk)
    e = kk * me * ne * np.exp(-lam * sc.astype(np.float64))
    bits = (lam * sc.astype(np.float64) - np.log(kk)) / np.log(2.0)
    rows = []
    for j in np.nonzero((sc > 0) & (e <= cfg["evalue_cutoff"]))[0]:
        f = int(hits["frame"][j])
        qs, qe = int(hits["qstart"][j]), int(hits["qend"][j])
        o = f % 3
        if f < 3:
            d0, d1 = o + 3 * qs + 1, o + 3 * qe + 3
        else:
            d0, d1 = read_len - (o + 3 * qs), read_len - (o + 3 * qe + 2)
        s1 = int(hits["s_end"][j]) + 1
        s0 = s1 - (int(hits["send"][j]) - int(hits["sstart"][j]))
        length = int(hits["length"][j])
        pid = 100.0 * int(hits["matches"][j]) / max(length, 1)
        rows.append(
            f"{name}\t{subject_name(int(hits['subject'][j]))}\t{pid:.2f}\t"
            f"{length}\t{int(hits['mismatch'][j])}\t{int(hits['gapopen'][j])}"
            f"\t{d0}\t{d1}\t{s0}\t{s1}\t{e[j]:.2e}\t{bits[j]:.1f}")
    return rows
