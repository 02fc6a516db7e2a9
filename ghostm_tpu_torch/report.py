"""Result ranking, traceback statistics, and BLAST-m8 TSV output.

Reference equivalent: GHOSTM's per-query ranked hit table (SURVEY.md §1.1
step 5; m8-style TSV is the family convention — mount empty, SURVEY.md §0).
Columns: qseqid sseqid pident length mismatch gapopen qstart qend sstart
send evalue bitscore. Query coordinates are reported in DNA space with
BLASTX frame convention (qstart > qend on the reverse strand); subject
coordinates are 1-based residue positions.

Ranking is by integer raw score with the deterministic tie-break
(-score, subject_id, frame, qend, subject_end); E-values are computed in
float64 on the host and REPORTED, never sorted on (SURVEY.md §7.2).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, TextIO

import numpy as np

from ghostm_tpu_torch import native
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.ops import evalue as ev
from ghostm_tpu_torch.utils.metrics import span

M8_HEADER = (
    "qseqid\tsseqid\tpident\tlength\tmismatch\tgapopen\t"
    "qstart\tqend\tsstart\tsend\tevalue\tbitscore"
)


def traceback_stats(
    moves: np.ndarray,  # (n, Lq, B) uint8 — encoding in kernels/sw_xla.py
    ie: np.ndarray,
    be: np.ndarray,
    qc: np.ndarray,     # (n, Lq) query codes
    w: np.ndarray,      # (n, Lq + B) window codes
) -> Dict[str, np.ndarray]:
    """Vectorised walk of the move matrices from each endpoint.

    Returns qstart/qend (frame-local aa, inclusive), sstart/send
    (window-local j = i + b, inclusive), length/matches/mismatch/gapopen.
    Entries with ie < 0 (empty alignment) get coords -1 and zero stats.
    """
    n, Lq, B = moves.shape
    i = ie.astype(np.int64).copy()
    b = be.astype(np.int64).copy()
    alive = i >= 0
    st = np.where(alive, 0, 3).astype(np.int8)  # 0=H 1=E 2=F 3=done
    qstart = np.where(alive, i, -1)
    sstart = np.where(alive, i + b, -1)
    length = np.zeros(n, np.int32)
    matches = np.zeros(n, np.int32)
    mismatch = np.zeros(n, np.int32)
    gapopen = np.zeros(n, np.int32)
    ii = np.clip(i, 0, Lq - 1)
    for _ in range(2 * (Lq + B) + 4):
        if not (st < 3).any():
            break
        ii = np.clip(i, 0, Lq - 1)
        bb = np.clip(b, 0, B - 1)
        mv = moves[np.arange(n), ii, bb]
        inH = st == 0
        c = mv & 3
        # H-state transitions
        stop = inH & ((c == 0) | (i < 0) | (b < 0) | (b >= B))
        diag = inH & ~stop & (c == 1)
        toE = inH & ~stop & (c == 2)
        toF = inH & ~stop & (c == 3)
        # diag consumes (i, j)
        qchar = qc[np.arange(n), ii]
        schar = w[np.arange(n), np.clip(ii + bb, 0, Lq + B - 1)]
        eq = (qchar == schar) & diag
        matches += eq
        mismatch += diag & ~eq
        length += diag
        qstart = np.where(diag, i, qstart)
        sstart = np.where(diag, i + b, sstart)
        i = np.where(diag, i - 1, i)
        st = np.where(stop, 3, st)
        st = np.where(toE, 1, st)
        st = np.where(toF, 2, st)
        # E-state: gap in query, consumes subject j; move b-1
        inE = st == 1
        eopen = ((mv >> 2) & 1).astype(bool)
        length += inE
        sstart = np.where(inE, i + b - 1, sstart)
        b = np.where(inE, b - 1, b)
        gapopen += inE & eopen
        st = np.where(inE & eopen, 0, st)
        # F-state: gap in subject, consumes query i; move (i-1, b+1)
        inF = st == 2
        fopen = ((mv >> 3) & 1).astype(bool)
        length += inF
        qstart = np.where(inF, i, qstart)
        i = np.where(inF, i - 1, i)
        b = np.where(inF, b + 1, b)
        gapopen += inF & fopen
        st = np.where(inF & fopen, 0, st)
        # walked off the top => done
        st = np.where((st == 0) & (i < 0), 3, st)
    empty = ie < 0
    out = dict(
        qstart=np.where(empty, -1, qstart).astype(np.int32),
        qend=np.where(empty, -1, ie).astype(np.int32),
        sstart=np.where(empty, -1, sstart).astype(np.int32),
        send=np.where(empty, -1, ie + be).astype(np.int32),
        length=length, matches=matches, mismatch=mismatch, gapopen=gapopen,
    )
    return out


def frame_to_dna_coords(
    frame: np.ndarray, qstart_aa: np.ndarray, qend_aa: np.ndarray,
    read_len: np.ndarray,
):
    """Frame-local aa coords -> 1-based DNA read coords, BLASTX convention.

    Forward frame f in {0,1,2}: residue p covers bases [f+3p, f+3p+2] (0-based)
      -> qstart = f + 3*qstart_aa + 1, qend = f + 3*qend_aa + 3.
    Reverse frame f in {3,4,5} (offset o = f-3 on the revcomp): residue p
    covers revcomp bases [o+3p, o+3p+2] which are original read positions
    [L-1-(o+3p+2), L-1-(o+3p)] -> reported qstart = L - (o + 3*qstart_aa)
    (the larger coordinate), qend = L - (o + 3*qend_aa + 2), qstart > qend.
    """
    f = frame.astype(np.int64)
    L = read_len.astype(np.int64)
    qs, qe = qstart_aa.astype(np.int64), qend_aa.astype(np.int64)
    fwd = f < 3
    o = np.where(fwd, f, f - 3)
    dstart = np.where(fwd, o + 3 * qs + 1, L - (o + 3 * qs))
    dend = np.where(fwd, o + 3 * qe + 3, L - (o + 3 * qe + 2))
    return dstart, dend


class SubjectNames:
    """gsid -> name map with a packed utf-8 arena for the native m8
    formatter (built once a run, not once a batch)."""

    def __init__(self, names: Dict[int, str]):
        self.names = names
        self._arena = None

    def __getitem__(self, gid: int) -> str:
        return self.names[gid]

    def arena(self):
        """(arena bytes, offsets int64[max_gid + 2]): gid g's name spans
        arena[off[g]:off[g + 1]]; unmapped gids get empty names."""
        if self._arena is None:
            hi = max(self.names, default=-1) + 1
            enc = [b""] * hi
            for g, nm in self.names.items():
                enc[g] = nm.encode()
            off = np.zeros(hi + 1, np.int64)
            np.cumsum([len(e) for e in enc], out=off[1:])
            self._arena = (b"".join(enc), off)
        return self._arena


def _name_arena(names: List[str]):
    enc = [nm.encode() for nm in names]
    off = np.zeros(len(enc) + 1, np.int64)
    if enc:
        np.cumsum([len(e) for e in enc], out=off[1:])
    return b"".join(enc), off


def write_hits(
    out: TextIO,
    cfg: Config,
    read_names: List[str],
    read_lens: np.ndarray,
    subject_names: Dict[int, str],
    hits,          # engine.BatchHits
    stats: Dict[str, np.ndarray],
    db_residues: int,
    db_seqs: int = 0,
    timing: Optional[Dict[str, float]] = None,
) -> int:
    """Append m8 rows for one batch; returns number of rows written.

    Stats coords arrive window-local (j = i + b); the engine's s_end is
    subject-local, so subject-local sstart follows from the window span:
    s_start_sub = s_end_sub - (send_window - sstart_window).

    subject_names: a SubjectNames formats the rows in C (native.m8_format,
    when the host library is built); a plain dict, or no library, takes
    the Python loop. Both write the same bytes. timing: when given, the
    seconds of the vectorised columns, the formatting and the write are
    added to its "columns_s", "format_s" and "write_s", and those of the
    e-values (inside the columns) and of the read-name arena (inside the
    formatting) to "evalue_s" and "names_s"; the distinct query lengths
    whose length adjustment was solved are added to "evalue_lengths".
    """
    t0 = time.perf_counter()
    R, K = hits.score.shape
    nR = min(R, len(read_names))
    lam, kk, kh = cfg.ka_params()
    with span("flush.columns"):
        # The e-values over every hit give the filter; the other columns
        # are computed on the kept rows only. All float math is float64 in
        # the same expression order as a per-row loop's, so the formatted
        # text is identical.
        sc = hits.score[:nR].astype(np.int64)
        qlen_aa = np.maximum(read_lens[:nR].astype(np.int64) // 3, 1)
        # BLAST effective-length correction when H and the sequence count
        # are known (ops/evalue.py: solved once for each distinct query
        # length); plain K*m*n search space otherwise.
        with span("flush.evalue"):
            te = time.perf_counter()
            e = ev.e_value(sc, qlen_aa[:, None], db_residues, lam, kk,
                           h=kh, db_seqs=db_seqs)
            if timing is not None and ev.adjusted(kh, db_seqs):
                timing["evalue_lengths"] = (timing.get("evalue_lengths", 0)
                                            + np.unique(qlen_aa).size)
            _add(timing, "evalue_s", te)
        keep = (sc > 0) & (e <= cfg.evalue_cutoff)
        # the kept hits' flat (read, rank) indices, row-major: the rows'
        # order
        kept = np.flatnonzero(keep)
        if kept.size == 0:
            _add(timing, "columns_s", t0)
            return 0
        r_idx = kept // K
        pick = lambda a: np.asarray(a)[:nR].take(kept)
        sc, e = pick(sc), pick(e)
        qs_dna, qe_dna = frame_to_dna_coords(
            pick(hits.frame), pick(stats["qstart"]), pick(stats["qend"]),
            read_lens[r_idx],
        )
        # window span -> subject-local 1-based inclusive coordinates
        s_end_sub = pick(hits.s_end).astype(np.int64) + 1
        s_start_sub = s_end_sub - (pick(stats["send"])
                                   - pick(stats["sstart"]))
        length = pick(stats["length"])
        pident = 100.0 * pick(stats["matches"]) / np.maximum(length, 1)
        bits = ev.bit_score(sc, lam, kk)
        mismatch = pick(stats["mismatch"])
        gapopen = pick(stats["gapopen"])
        gsid = pick(hits.gsid)
        t1 = _add(timing, "columns_s", t0)
    with span("flush.format"):
        text = None
        if isinstance(subject_names, SubjectNames):
            sarena, soff = subject_names.arena()
            with span("flush.names"):
                tn = time.perf_counter()
                qarena, qoff = _name_arena(read_names)
                _add(timing, "names_s", tn)
            text = native.m8_format(
                r_idx, qarena, qoff, gsid, sarena, soff, pident, length,
                mismatch, gapopen, qs_dna, qe_dna, s_start_sub, s_end_sub,
                e, bits,
            )
        if text is not None:
            text = text.decode()
        else:
            text = "".join([
                f"{read_names[r]}\t{subject_names[g]}\t{p:.2f}\t{ln}\t"
                f"{mm}\t{go}\t{qs}\t{qe}\t{ss}\t{se}\t{ev_:.2e}\t{bs:.1f}\n"
                for r, g, p, ln, mm, go, qs, qe, ss, se, ev_, bs in zip(*(
                    c.tolist() for c in (
                        r_idx, gsid, pident, length, mismatch, gapopen,
                        qs_dna, qe_dna, s_start_sub, s_end_sub, e, bits)))
            ])
        t2 = _add(timing, "format_s", t1)
    with span("flush.write"):
        out.write(text)
        _add(timing, "write_s", t2)
    return len(kept)


def _add(timing: Optional[Dict[str, float]], key: str, since: float) -> float:
    """Add the seconds since `since` to timing[key] (when timing is given);
    returns now."""
    now = time.perf_counter()
    if timing is not None:
        timing[key] = timing.get(key, 0.0) + now - since
    return now
