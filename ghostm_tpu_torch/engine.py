"""Search engine: the per-batch device step + host driver (port of the JAX
package's engine.py, loop path: every shard on the one device).

One batch of raw DNA reads runs, on the engine's device:
  1. six-frame translation (ops.translate.six_frame_translate_torch);
  2. PROPOSE, per shard: k-mer keys -> the seed table's hits per k-mer ->
     per query frame a sort, run-length vote and top-ncand (kernels B1,
     B2); in long-read mode (smooth_bins, chain_gamma > 0) B1, then the
     vote with collinear chain scores (kernel R2, the chained vote) or
     neighbour-bin smoothing (the plain vote);
  3. SELECT: the global top-ncand over the shards' proposals (kernel B4 on
     3 keys; the identity with one shard);
  4. ALIGN, per shard: window fetch + banded SW on the candidates the
     shard owns, from the codes and a score table built once per engine:
     kernel B3 for matrices in the fused kernel's nibble range where
     `fused_ok` holds, else the score-fed route (`score_fed_route`: kernel
     B5, or B6 at long frames), one launch a shard a batch; their plain
     versions build score tiles, in chunks;
  5. RANK: the disjoint-mask merge over shards, then per read the top
     max_hits by (-score, gsid, frame, qend, s_end) with the original
     position as the final tie-break (kernel B4);
  6. REFINE: each hit's window from its shard, then the moves DP and
     the traceback walk of every hit in one launch (kernel R1,
     kernels/refine.py);
  7. the packed (6, R, K) transport the pipeline fetches and unpacks.
A CUDA engine launches the kernels; a CPU engine (device="cpu", the tests)
runs their plain versions. Both return the same integers as the JAX
package's engine, on any index it runs on one device.

CUDA graphs (`search_refine_async_dna` on a CUDA engine of one device):
every launch of the step has the batch's fixed shape and none waits for
the host, so each stage of GRAPH_STAGES is captured once a batch shape
and replayed for every later batch: the first batch of a shape runs
eager (each kernel's one-time set-up), the second captures, the rest
replay. A stage is replayed inside the method that runs it (`propose`,
`align`, `refine_packed`, ...), so a caller's wrapper around one of them
still wraps its device work. The stages share one memory pool and always
replay in capture order; the batch's DNA and lengths are copied into the
graph's static inputs through pinned staging (the step does not wait for
the device), and the output is cloned out of the static one, since the
pipeline fetches batch i while batch i + 1 replays. A grid rank, the CPU
engine, the --check pass and the codes entries run eager.
The fetch: search_refine_async_dna on a CUDA engine also starts the
output's copy to pinned host memory, on a copy stream that waits for the
step, from the thread that launched it; `fetch` waits for that copy. A
copy the flush thread enqueued on the one stream would wait behind every
batch launched before it: one or two, as the threads happened to run, so
a batch's latency swung by a whole step.
Counters: graph_captures, graph_replays (stages), graph_eager (stages a
CUDA engine ran eager) and last_graph_stages (stages the last batch
replayed).

Seed tables (`build_key_tables`), one mode for every shard: "direct" (one
table row per k-mer), else "csr" (position-parallel row/offset tables)
where a packed value would reach DIRECT_SENT, as one long subject makes
it, or the table would pass DIRECT_TABLE_CAP (split over the shards). The
JAX package's third layout, bucket-aligned rows, gives the vote CSR's keys
value for value while its row/count word holds every bucket's count (past
that it reads a wrong row and count: fault F8 of the JAX package), so an
index it would take runs on CSR. Shards on one device are merged into one
at init while the merged index still takes the direct table
(`_merge_fits_direct`; GHOSTM_TPU_MERGE_COLOCATED=0 keeps the loop).

A CUDA engine refuses bands above 128, the widest its SW kernels take,
and negative gap costs (NotImplementedError at init).

Pitfalls of the translation from JAX, handled below:
  * gathers: JAX clamps an out-of-range gather index silently (and jnp
    indexing first wraps an index in [-n, -1] to idx + n); torch raises on
    the CPU and faults on CUDA. Every gather index is clamped as JAX would
    clamp it (table rows, seed positions, subject rows, frames).
  * int32: JAX without x64 computes in int32 and torch.arange defaults to
    int64. The packed vote keys, the packed top-k and the transport words
    rely on int32 arithmetic, so every such tensor is made int32 (torch's
    sum of int32 is int64 unless told otherwise).
  * division: `//` and `%` floor in both torch and JAX (the keys are
    non-negative where it matters); the CUDA kernels use no signed
    division.
  * searchsorted: torch's needs a contiguous sorted sequence of the
    values' dtype; its default side (left) is JAX's.

Debug checks (CLI --check, --debug-nans): `search_batch_checked` runs
propose, select, align and rank with `check=True`, which asserts before
each gather that the JAX package runs unclamped (where its checkify pass
fails an out-of-bounds index: the direct table's row and the CSR bucket
gathers of propose) that the index is in bounds, and raises naming the
site. Every stage's floating outputs are checked for NaN there, and in
every step while the process-wide switch `DEBUG_NANS` is on (CLI
--debug-nans); the step computes in integers, so no stage returns a float
today.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.index.diskio import StackedIndex, merge_shards
from ghostm_tpu_torch.kernels import _build
from ghostm_tpu_torch.kernels import candidates as cand_mod
from ghostm_tpu_torch.kernels import refine as refine_mod
from ghostm_tpu_torch.kernels import (
    seed_lookup, sort, sw_fused, sw_scored, sw_wave,
)
from ghostm_tpu_torch.ops.encode import ALPHA, SENTINEL
from ghostm_tpu_torch.ops.scoring import padded_matrix
from ghostm_tpu_torch.ops.translate import (
    six_frame_translate, six_frame_translate_torch,
)
from ghostm_tpu_torch.utils.metrics import span

NFRAMES = 6
# the step's stages as step_dna runs them, each its own CUDA graph
GRAPH_STAGES = ("translate", "propose", "align", "rank", "refine", "pack")
BIG = 1 << 30
SORT_NUM_KEYS = 5  # (-score, gsid, frame, qend, s_end) — the tie-break spec
# Direct-table sentinel: pad slots hold this value; any packed value below
# it is a real position (checked at build).
DIRECT_SENT = 0x7FF00000
# Device budget for the direct tables ((nb + 1) * W * 4 bytes each, nb =
# 20^k buckets, W = pow2 >= max bucket count): k=5/W=128 is 1.64 GB. Every
# shard's table lives on the one device, so build_key_tables splits it
# n_shards ways. The JAX package's default and override (read at import:
# a run that sets GHOSTM_TPU_DIRECT_TABLE_CAP starts a new process).
DIRECT_TABLE_CAP = int(os.environ.get("GHOSTM_TPU_DIRECT_TABLE_CAP", 3 << 30))
# Process-wide NaN check of every stage's floating outputs (CLI
# --debug-nans, the JAX package's jax_debug_nans).
DEBUG_NANS = False


def _check_nans(stage: str, *tensors: torch.Tensor,
                check: bool = False) -> None:
    """Raise FloatingPointError naming `stage` if a floating tensor it
    returned holds a NaN (with check=True or DEBUG_NANS on)."""
    if not (check or DEBUG_NANS):
        return
    for t in tensors:
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in the output of stage {stage}")


def _check_index(idx: torch.Tensor, n: int, site: str) -> None:
    """--check's bounds assert at a gather of `n` rows that the JAX
    package runs unclamped: jnp wraps an index in [-n, -1], and checkify
    fails any other outside [0, n). Raises IndexError naming the site."""
    bad = (idx < -n) | (idx >= n)
    if bool(bad.any()):
        raise IndexError(f"--check: {site}: gather index "
                         f"{int(idx[bad][0])} out of bounds for {n} rows")


def check_codes(codes: np.ndarray, what: str) -> None:
    """Refuse residue codes outside [0, ALPHA) (fault F5): the score
    tables have ALPHA rows and columns, so the plain versions would index
    past them and the CUDA kernels read past them, where the JAX package's
    one-hot contractions score such a code 0."""
    c = np.asarray(codes)
    if c.size and (int(c.min()) < 0 or int(c.max()) >= ALPHA):
        raise ValueError(f"{what} holds residue codes outside [0, {ALPHA})")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_reads(qcodes: np.ndarray, n: int) -> np.ndarray:
    """(R, 6, Lq) frames padded to n reads with inert ones (code-25
    frames: no k-mer, no hit); every read's search is its own, so the
    real rows are unchanged."""
    R = qcodes.shape[0]
    if n <= R:
        return qcodes
    pad = np.full((n - R,) + qcodes.shape[1:], 25, qcodes.dtype)
    return np.concatenate([qcodes, pad])


def lead_pad(cfg: Config) -> int:
    """Sentinel padding prepended to the buffer so window starts
    g0 >= -(qlen + band) always slice in-bounds."""
    return _round_up(cfg.query_frame_len + cfg.band_width, 128)


def pad_buffer(buf: np.ndarray, cfg: Config) -> np.ndarray:
    """Sentinel-pad the shard buffer: `lead_pad` in front, lead + 512
    behind, total a multiple of 256 (the JAX package's layout), so an owned
    candidate's window never clamps."""
    lead = lead_pad(cfg)
    out = np.pad(buf, (lead, lead + 512), constant_values=SENTINEL)
    extra = (-len(out)) % 256
    if extra:
        out = np.pad(out, (0, extra), constant_values=SENTINEL)
    return out


def _packed_value_bound(st, mult: int, Lq: int) -> int:
    """Max packed value (row * mult + localoff + Lq) any seed position in
    this store can take, from per-subject bounds."""
    S = st.num_subjects
    if not S:
        return 0
    starts64 = np.asarray(st.starts, np.int64)
    strides = np.diff(starts64, append=np.int64(len(st.buffer)))
    return int((np.arange(S, dtype=np.int64) * mult + strides - 1 + Lq).max())


def _packed_valmap(st, mult: int, Lq: int) -> np.ndarray:
    """Per-buffer-position packed value row*mult + (pos - start[row]) + Lq
    as ONE int32 array (arange + a repeated per-subject base). The leading
    sentinel pad folds into subject 0's span — no seed positions fall
    there."""
    S = st.num_subjects
    starts64 = np.asarray(st.starts, np.int64)
    base = (
        np.arange(S, dtype=np.int64) * mult - starts64 + Lq
    ).astype(np.int32) if S else np.full(1, Lq, np.int32)
    rep = (
        np.diff(starts64, append=np.int64(len(st.buffer)))
        if S else np.asarray([len(st.buffer)])
    )
    if S:
        rep = rep.copy()
        rep[0] += starts64[0]
    valmap = np.arange(len(st.buffer), dtype=np.int32)
    valmap += np.repeat(base, rep)
    return valmap


def seed_key_tables(index: StackedIndex, shard: int, nbins: int):
    """CSR key tables parallel to the shard's (padded) seed-position array:
    for position positions[j] at subject row r with subject-local offset
    o, rowbase[j] = r * nbins and localoff[j] = o (int32). The row of each
    buffer position comes from a per-subject repeat (as in _packed_valmap)
    in place of the JAX package's searchsorted over every position: the
    same arrays (a pad entry, position 0, takes row 0 either way)."""
    st = index.shards[shard].store
    pos = index.positions[shard].astype(np.int64)
    S = st.num_subjects
    if not S:
        return np.zeros(len(pos), np.int32), pos.astype(np.int32)
    starts64 = np.asarray(st.starts, np.int64)
    rep = np.diff(starts64, append=np.int64(len(st.buffer)))
    rep[0] += starts64[0]
    row = np.repeat(np.arange(S, dtype=np.int32), rep)[pos]
    rowbase = (row.astype(np.int64) * nbins).astype(np.int32)
    localoff = (pos - starts64[row]).astype(np.int32)
    return rowbase, localoff


def direct_key_tables(index: StackedIndex, shard: int, nbins: int, half: int,
                      Lq: int, width: int, cap_bytes: int = DIRECT_TABLE_CAP,
                      build: bool = True):
    """DIRECT-indexed sentinel table: row k of the (nb + 1, width) table
    holds bucket k's packed values (row * nbins * half + localoff + Lq),
    padded with DIRECT_SENT; row nb (the invalid-kmer bucket) is all
    sentinel. Returns (tab2d int32, fits); fits=False when a packed value
    would reach DIRECT_SENT or the table would exceed cap_bytes.
    build=False: only the check, (None, fits)."""
    sd = index.shards[shard].seeds
    st = index.shards[shard].store
    bs = np.asarray(sd.bucket_starts, np.int64)
    pos = np.asarray(sd.positions)
    P = len(pos)
    counts = np.diff(bs)                      # (nb + 1,) incl. overflow
    nrows = len(counts)
    mult = nbins * half
    if nrows * width * 4 > cap_bytes:
        return None, False
    if len(st.buffer) >= (1 << 31) \
            or _packed_value_bound(st, mult, Lq) >= DIRECT_SENT \
            or int(counts.max(initial=0)) > width:
        return None, False
    if not build:
        return None, True
    tab = np.full(nrows * width, DIRECT_SENT, np.int32)
    if P:
        vals = _packed_valmap(st, mult, Lq)[pos]
        dshift = np.arange(nrows, dtype=np.int64) * width - bs[:-1]
        dst = np.arange(P, dtype=np.int64) + np.repeat(dshift, counts)
        tab[dst] = vals
    return tab.reshape(nrows, width), True


def build_key_tables(index: StackedIndex, nbins: int, half: int, Lq: int,
                     expand: int, colocated_shards: bool = True,
                     shards=None):
    """The (tab_main, tab_aux) of each shard in `shards` (default: all)
    and the one layout mode every shard of the index shares: (maps, mode,
    width), width the slots one query position reads. "direct" (row width
    pow2 >= expand, >= 8; tab_aux a 1-element dummy) while every shard's
    table fits its share of DIRECT_TABLE_CAP and the DIRECT_SENT packing;
    else "csr" at width `expand`, each shard's (rowbase, localoff) from
    seed_key_tables. colocated_shards: every shard's table lives on one
    device, so the cap is split n_shards ways; False (a grid: a device a
    shard) gives each shard the whole cap. The mode is decided over every
    shard of the index, whichever are built, so that every rank of a grid
    takes the same one."""
    n_shards = index.buffers.shape[0]
    shards = range(n_shards) if shards is None else list(shards)
    dw = 8
    while dw < expand:
        dw *= 2
    cap = DIRECT_TABLE_CAP // (n_shards if colocated_shards else 1)
    if all(direct_key_tables(index, i, nbins, half, Lq, dw, cap_bytes=cap,
                             build=False)[1] for i in range(n_shards)):
        return [(direct_key_tables(index, i, nbins, half, Lq, dw,
                                   cap_bytes=cap)[0], np.zeros(1, np.int32))
                for i in shards], "direct", dw
    return [seed_key_tables(index, i, nbins) for i in shards], "csr", expand


def diag_bins(cfg: Config, index: StackedIndex) -> int:
    """Subject-local diagonal bins of band / 2 a subject row: enough for
    the longest subject plus a frame."""
    return (int(index.lengths.max() + cfg.query_frame_len)
            // (cfg.band_width // 2) + 2)


def key_tables_for(cfg: Config, index: StackedIndex,
                   colocated_shards: bool = True, shards=None):
    """The (maps, mode, width) triple a SearchEngine on (cfg, index) builds
    (build_key_tables at its bins); `key_table=` of a second engine on the
    same index. A grid rank's engine takes colocated_shards=False and its
    own shard."""
    return build_key_tables(index, diag_bins(cfg, index),
                            cfg.band_width // 2, cfg.query_frame_len,
                            index.expand_width, colocated_shards, shards)


def _merge_fits_direct(index: StackedIndex, cfg: Config) -> bool:
    """Would the MERGED (1-shard) form of this index still take the direct
    table? The packed-value bound over merged global-id-ordered rows, the
    int32 buffer bound and the direct-table byte cap at the merged bucket
    widths, without merging."""
    Lq = cfg.query_frame_len
    mult = diag_bins(cfg, index) * (cfg.band_width // 2)
    lens = np.concatenate(
        [np.asarray(s.store.lengths, np.int64) for s in index.shards])
    ids = np.concatenate(
        [np.asarray(s.store.subject_ids, np.int64) for s in index.shards])
    S = len(lens)
    if not S:
        return False
    pad = int(index.shards[0].store.starts[0])
    total = pad + int((lens + pad).sum())
    if total >= (1 << 31):
        return False
    lens_m = lens[np.argsort(ids, kind="stable")]
    bound = int(
        (np.arange(S, dtype=np.int64) * mult + lens_m + pad - 1 + Lq).max())
    if bound >= DIRECT_SENT:
        return False
    counts_m = sum(np.diff(np.asarray(s.seeds.bucket_starts, np.int64))
                   for s in index.shards)
    nb = index.shards[0].seeds.num_buckets
    expand_m = int(counts_m[:nb].max(initial=1))
    dw = 8
    while dw < expand_m:
        dw *= 2
    return len(counts_m) * dw * 4 <= DIRECT_TABLE_CAP


# --------------------------------------------------------------------------
# Phase 1: propose (seed lookup + voting)
# --------------------------------------------------------------------------

def propose_shard(
    qflat: torch.Tensor,          # (Qf, Lq) int8 translated frames
    bucket_starts: torch.Tensor,  # (nb + 2,) int32 (csr), else unused
    tab_main: torch.Tensor,       # the shard's seed table (see mode)
    tab_aux: torch.Tensor,
    subject_ids: torch.Tensor,
    *,
    seed_len: int,
    expand: int,
    band: int,
    ncand: int,
    min_votes: int,
    nbins: int,
    table_width: int,
    mode: str = "direct",
    presorted_run: int = 0,
    smooth: bool = False,
    chain_gamma: int = 0,
    check: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Qf, ncand) proposals (gsid, lbin, votes) of one shard.

    mode (build_key_tables): "direct" gathers one (table_width,) row of
    packed values a k-mer, valid below DIRECT_SENT, over the first
    Lq - seed_len + 1 positions (the last seed_len - 1 never host a
    k-mer); "csr" reads the bucket's start and count from bucket_starts
    and the keys rowbase + (localoff - qpos + Lq) // half from tab_main
    (rowbase) and tab_aux (localoff) at each of the `expand` slots, over
    every query position, as in the JAX package.

    Chunked over query frames with the JAX package's minimal-pad chunk
    sizing so the expanded (chunk, Lq, width) key tensor stays ~128 MB and
    the kernels see its shapes ((6144, 4608) keys at config-2, direct).

    presorted_run > 1 (direct: table_width): each (qpos, bucket) run of a
    key row is ascending by construction; odd qpos runs are flipped to
    descending so the bitonic kernels skip their first log2(run) stages.
    The sorted row is the same either way.

    check: assert that every index of the gathers the JAX package runs
    unclamped (the direct table row, the CSR bucket bounds) is in bounds
    (`_check_index`)."""
    Qf, Lq = qflat.shape
    dev = qflat.device
    qi = qflat.to(torch.int32)
    direct = mode == "direct"
    per_frame = Lq * (table_width if direct else expand) * 4
    qcap = max(128, min(Qf, (128 << 20) // per_frame // 128 * 128))
    nch = -(-Qf // qcap)
    qchunk = max(128, min(qcap, _round_up(-(-Qf // nch), 128)))
    qpad = _round_up(Qf, qchunk)
    qi_p = torch.cat([qi, torch.full((qpad - Qf, Lq), 25, dtype=torch.int32,
                                     device=dev)])
    half = band // 2
    Lq_eff = max(Lq - seed_len + 1, 1) if direct else Lq
    qpos = torch.arange(Lq_eff, dtype=torch.int32, device=dev)[None, :, None]
    odd = (qpos & 1) == 1
    offs = torch.arange(expand, dtype=torch.int32, device=dev)
    nrows = tab_main.shape[0]
    outs = []
    for qc in qi_p.split(qchunk):
        kmers = seed_lookup.query_kmer_keys(qc, seed_len)[:, :Lq_eff]
        if direct:
            kflat = kmers.reshape(-1)
            if check:
                _check_index(kflat, nrows, "propose: direct table row")
            tg = tab_main[kflat.clamp(0, nrows - 1).to(torch.int64)]
            tg = tg.reshape(qc.shape[0], Lq_eff, table_width)
            keys = torch.where(tg < DIRECT_SENT, (tg - qpos) // half,
                               torch.full_like(tg, BIG))
        else:
            km = kmers.to(torch.int64)
            nbs = bucket_starts.shape[0]
            if check:
                _check_index(km, nbs, "propose: CSR bucket start")
                _check_index(km + 1, nbs, "propose: CSR bucket end")
            start = bucket_starts[km.clamp(0, nbs - 1)]
            count = bucket_starts[(km + 1).clamp(0, nbs - 1)] - start
            idx = (start[..., None] + offs).clamp(0, nrows - 1)
            idx = idx.to(torch.int64)
            lbin = (tab_aux[idx] - qpos + Lq) // half
            keys = torch.where(offs < count[..., None], tab_main[idx] + lbin,
                               torch.full_like(lbin, BIG))
        if presorted_run > 1:
            keys = torch.where(odd, torch.flip(keys, [2]), keys)
        outs.append(cand_mod.vote_and_rank(
            keys.reshape(qc.shape[0], -1), subject_ids,
            ncand, min_votes, smooth=smooth, nbins=nbins,
            presorted_run=presorted_run, chain_gamma=chain_gamma,
        ))
    g, b, v = (torch.cat(x)[:Qf] for x in zip(*outs))
    return g, b, v


# --------------------------------------------------------------------------
# Phase 3: align (subject-bounded banded SW on selected candidates)
# --------------------------------------------------------------------------

def fetch_windows(buf: torch.Tensor, g0: torch.Tensor, lead: int,
                  wlen: int) -> torch.Tensor:
    """(N, wlen) int8 windows buf[g0 + lead : g0 + lead + wlen] — one row
    gather from the buffer's (len - wlen + 1, wlen) sliding view (the JAX
    package's aligned-row gathers and roll networks exist for the TPU).
    Starts clamp into the buffer as JAX's gathers clamp; an owned
    candidate's window never needs it (pad_buffer)."""
    gl = (g0.to(torch.int64) + lead).clamp(0, buf.shape[0] - wlen)
    return buf.unfold(0, wlen, 1)[gl]


def score_fed_route(Lq: int, band: int) -> str:
    """"wave" (kernel B6) or "rows" (kernel B5) for an alignment the fused
    kernel does not take: the JAX engine's use_wave predicate
    (engine.py:709-714), word for word."""
    use_wave = (
        Lq >= 64 and band >= 16 and band % 2 == 0
        # conservative bound on sw_wave's internal packing check
        and 15 * Lq < (1 << (31 - (Lq + 2 * band).bit_length()))
    )
    return "wave" if use_wave else "rows"


def align_shard(
    qflat: torch.Tensor,       # (Qf, Lq) int8
    buffer: torch.Tensor,      # lead-padded shard buffer, int8
    starts: torch.Tensor,
    subject_ids: torch.Tensor,  # (S,) int32 global ids, sorted, BIG-padded
    lengths: torch.Tensor,
    matrix: torch.Tensor,
    sel_gsid: torch.Tensor,    # (Qf, C) global top-N candidates
    sel_lbin: torch.Tensor,    # (Qf, C)
    *,
    band: int,
    gap_open: int,
    gap_extend: int,
    lead: int,
    code_limit: int,
    srow_identity: int,
    route: str = "fused",
    chunk: int = 8192,
    table: torch.Tensor | None = None,
    table_max: int | None = None,
):
    """Returns (score, qend, bend, s_end, g0, srow, owned), each (Qf, C);
    score is 0 for candidates this shard does not own. table: the route's
    score table when the caller keeps one (B3's sw_fused.score_table, or
    sw_scored.code_table for the score-fed route), table_max its largest
    value.

    srow_identity = n > 0: the caller guarantees subject_ids[:n] ==
    arange(n) (every one-shard or merged index), so the gsid -> row map is
    the identity; 0: the row is the searchsorted of gsid in subject_ids
    and the shard owns a candidate whose id is there.

    route (engine.py:698-759 of the JAX package): "fused" runs B3 on the
    codes in one call; "rows" (B5) and "wave" (B6) run on the codes and
    the code table in one call on CUDA. Their plain versions build the
    JAX engine's score tiles (int8 masked tiles when band % 32 == 0, else
    int32 tiles with LOW outside the subject span), so on the CPU they go
    `chunk` alignments at a time."""
    Qf, Lq = qflat.shape
    C = sel_gsid.shape[1]
    S = starts.shape[0]
    if srow_identity:
        srow = sel_gsid.clamp(0, S - 1)
        owned = (sel_gsid >= 0) & (sel_gsid < srow_identity)
    else:
        srow = torch.searchsorted(subject_ids, sel_gsid.contiguous())
        srow = srow.clamp(0, S - 1).to(torch.int32)
        owned = ((subject_ids[srow.to(torch.int64)] == sel_gsid)
                 & (sel_gsid < BIG))
    srow_i = srow.to(torch.int64)
    sub_start = starts[srow_i]
    sub_len = lengths[srow_i]
    half = band // 2
    zero = torch.zeros_like(sel_gsid)
    # lbin is BIG where not owned: select before scaling (int32)
    lbin = torch.where(owned, sel_lbin, zero)
    g0 = torch.where(owned, sub_start + lbin * half - Lq - band // 4, zero)
    lo = torch.where(owned, sub_start, zero)
    hi = lo + torch.where(owned, sub_len, zero)

    N = Qf * C
    qrep = qflat.to(torch.int8).repeat_interleave(C, dim=0)
    g0f = g0.reshape(N)
    w = fetch_windows(buffer, g0f, lead, Lq + band)
    rel_lo = (lo.reshape(N) - g0f).contiguous()
    rel_hi = (hi.reshape(N) - g0f).contiguous()
    if route == "fused":
        s, ie, be = sw_fused.sw_fused(
            qrep, w, matrix, rel_lo, rel_hi, gap_open, gap_extend, band,
            code_limit=code_limit, table=table,
        )
    else:
        sw = (sw_wave.sw_wave_codes if route == "wave"
              else sw_scored.sw_scored_codes)
        if table is None:
            table = sw_scored.code_table(matrix, band)
        step = N if qflat.is_cuda else chunk
        outs = [sw(qrep[c:c + step], w[c:c + step], table,
                   rel_lo[c:c + step], rel_hi[c:c + step], gap_open,
                   gap_extend, band, table_max=table_max)
                for c in range(0, N, step)]
        s, ie, be = (outs[0] if len(outs) == 1
                     else (torch.cat(x) for x in zip(*outs)))
    score = s.reshape(Qf, C)
    score = torch.where(owned & (score > 0), score, zero)
    hit = score > 0
    qend = torch.where(hit, ie.reshape(Qf, C), zero)
    bend = torch.where(hit, be.reshape(Qf, C), zero)
    s_end = torch.where(hit, lbin * half - Lq - band // 4 + qend + bend, zero)
    return score, qend, bend, s_end, g0, srow, owned


def rank_reads(score, gsid, frame, qend, s_end, bend, g0, srow, shard,
               topk: int) -> torch.Tensor:
    """Per-read deterministic top-k over (R, M) fields -> packed (9, R, K):
    ascending on (-score, gsid, frame, qend, s_end), full-key ties broken
    by original position (kernel B4)."""
    g = torch.where(score > 0, gsid, torch.full_like(gsid, BIG))
    fields = torch.stack((-score, g, frame, qend, s_end, bend, g0, srow,
                          shard))
    out = sort.lex_rank_rows(fields, SORT_NUM_KEYS, topk)
    out[0] = -out[0]
    return out


def merge_rank(stacked, sel_g: torch.Tensor, R: int, K: int) -> torch.Tensor:
    """The shards' align outputs, each field stacked (n_shards, Qf, C) ->
    ranked packed (9, R, K) int32 (the JAX package's _merge_rank_jit):
    each field summed over shards where the shard owns a live hit (the
    owners are disjoint), the owning shard's id as the shard field, then
    rank_merged."""
    score, qend, bend, s_end, g0, srow, owned = stacked
    sid = torch.arange(score.shape[0], dtype=torch.int32,
                       device=score.device)[:, None, None]
    fields = live_fields(score, qend, bend, s_end, g0, srow, owned,
                         sid.expand_as(score))
    return rank_merged(fields.sum(1, dtype=torch.int32), sel_g, R, K)


def live_fields(score, qend, bend, s_end, g0, srow, owned,
                shard) -> torch.Tensor:
    """One shard's align outputs as the 7 fields the merge sums over
    shards, stacked on dim 0: the score (align_shard zeroes the scores a
    shard does not own), then qend, bend, s_end, g0, srow and the shard id
    where the shard owns a live hit, else 0."""
    live = owned & (score > 0)
    zero = torch.zeros_like(score)
    return torch.stack([score] + [torch.where(live, f, zero) for f in
                                  (qend, bend, s_end, g0, srow, shard)])


def rank_merged(fields: torch.Tensor, sel_g: torch.Tensor, R: int,
                K: int) -> torch.Tensor:
    """The merged (7, Qf, C) fields (live_fields summed over shards) ->
    ranked packed (9, R, K) int32: per read the top K of its 6 x C
    candidates (rank_reads), each candidate's frame from its column."""
    score, qend, bend, s_end, g0, srow, shard = fields
    C = score.shape[1]
    M = NFRAMES * C
    rs = lambda a: a.reshape(R, M)
    frame = torch.arange(NFRAMES, dtype=torch.int32, device=score.device
                         ).repeat_interleave(C)[None, :].expand(R, M)
    gsid = torch.where(score > 0, sel_g, torch.full_like(sel_g, BIG))
    return rank_reads(
        rs(score), rs(gsid), frame.contiguous(), rs(qend), rs(s_end),
        rs(bend), rs(g0), rs(srow), rs(shard), K,
    )


def check_mesh(cfg: Config, n_shards: int, data: int, db: int) -> None:
    """The JAX package's two refusals of an index and batch for a
    (data, db) grid."""
    if n_shards != db:
        raise ValueError(f"index has {n_shards} shards, mesh db axis is {db}")
    if cfg.query_batch % data:
        raise ValueError("query_batch must divide by mesh data axis")


def refine_stats_packed(
    qcodes3: torch.Tensor,  # (R, 6, Lq) int8 translated frames
    packed: torch.Tensor,   # (9, R, K) int32 ranked hits
    matrix: torch.Tensor,
    w: torch.Tensor,        # (R*K, Lq+band) windows
    lo: torch.Tensor,       # (R*K,) subject span start
    hi: torch.Tensor,       # (R*K,)
    *, band: int, gap_open: int, gap_extend: int,
    table: torch.Tensor | None = None, table_max: int | None = None,
) -> torch.Tensor:
    """Moves DP + traceback on pre-fetched windows -> (9, R, K) stats
    (8 stat fields + score_check): stage R1 (kernels/refine.py), its
    kernel on CUDA tensors, its plain version on CPU ones. table /
    table_max: refine.score_table(matrix) and its largest value, from a
    caller that keeps them."""
    return refine_mod.refine_stats(
        qcodes3, packed, matrix, w, lo, hi, band=band, gap_open=gap_open,
        gap_extend=gap_extend, table=table, table_max=table_max)


@dataclasses.dataclass
class BatchHits:
    """Per-read top-k (host numpy, (R, K) arrays)."""
    score: np.ndarray
    gsid: np.ndarray
    frame: np.ndarray
    qend: np.ndarray
    s_end: np.ndarray
    bend: np.ndarray
    g0: np.ndarray
    srow: np.ndarray
    shard: np.ndarray


def graphs_device(device: torch.device) -> bool:
    """Does a step on `device` run from CUDA graphs? (A CUDA device.)"""
    return device.type == "cuda"


def _signature(args) -> tuple:
    """What a stage's graph baked in of its arguments: each tensor's
    address and shape, any other value as it is."""
    return tuple(
        _signature(a) if isinstance(a, (tuple, list))
        else (a.data_ptr(), tuple(a.shape)) if isinstance(a, torch.Tensor)
        else a for a in args)


@dataclasses.dataclass
class _Stage:
    """One captured stage: its graph, its static outputs and the
    signature of the arguments it was captured on."""
    graph: _build.Replayed
    out: object
    signature: tuple


@dataclasses.dataclass
class StepGraphs:
    """A batch shape's graphed step: its static DNA and lengths (and on a
    CUDA device their pinned host staging, with the event after the last
    copy out of it), its stages' memory pool and graphs."""
    dna: torch.Tensor
    lens: torch.Tensor
    host: tuple = ()
    copied: object = None
    pool: object = None
    stages: Dict[str, _Stage] = dataclasses.field(default_factory=dict)


class SearchEngine:
    """Host driver: owns the device copies of the index (one dict of
    tensors a shard) and runs the batch step on `device` ("cuda" by
    default; "cpu" runs the plain versions)."""

    STAT_KEYS = refine_mod.STAT_KEYS

    def __init__(self, cfg: Config, index: StackedIndex,
                 device: str | torch.device = "cuda",
                 key_table: tuple | None = None, mesh=None):
        """key_table: the (maps, mode, width) triple build_key_tables made
        for this (cfg, index) — a caller that runs two engines over one
        index passes the first engine's `key_table` to skip a second build
        (for an index the engine merges, the merged index's tables).

        mesh: a parallel.mesh.Mesh — this engine is one rank of a
        (data, db) grid (the JAX package's mesh branch): it needs an index
        of `db` shards and a query_batch that divides by `data`, holds only
        shard `mesh.db_index` on its device (its key table from the whole
        direct-table cap, the layout mode decided over every shard), never
        merges shards, and searches through search_batch_stats /
        search_batch_stats_local (parallel.search)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass "
                               "device='cpu' (CLI: --device cpu)")
        if self.device.type == "cuda" and cfg.band_width > sw_fused.MAX_BAND:
            raise NotImplementedError(
                f"band {cfg.band_width} is wider than the CUDA SW kernels "
                f"take ({sw_fused.MAX_BAND})"
            )
        if self.device.type == "cuda" and min(cfg.gap_open,
                                              cfg.gap_extend) < 0:
            # diagonals past a band that is not a multiple of 32 are held
            # at a large negative value, which a negative cost could lift
            raise NotImplementedError(
                f"gap costs {cfg.gap_open}/{cfg.gap_extend}: the CUDA SW "
                "kernels take gap costs >= 0"
            )
        self.mesh = mesh
        if mesh is not None:
            check_mesh(cfg, index.buffers.shape[0], mesh.data, mesh.db)
        # Colocated-shard merge: every shard runs on the one device, so n
        # shards cost ~n x the propose and align work of one. While the
        # merged index still takes the direct table, fold the shards into
        # one at init (the same output by the shard-invariance contract);
        # otherwise (the reason to shard a one-device index) keep the loop.
        # GHOSTM_TPU_MERGE_COLOCATED=0 keeps the loop for coverage. A grid
        # rank holds one shard: nothing to merge.
        self.merged_colocated = False
        if (mesh is None and index.buffers.shape[0] > 1
                and os.environ.get("GHOSTM_TPU_MERGE_COLOCATED", "1") != "0"
                and _merge_fits_direct(index, cfg)):
            index = merge_shards(index)
            self.merged_colocated = True
        mat = padded_matrix(cfg.matrix, hard_stop=True)
        words, self.code_limit = sw_fused.build_packed_matrix(mat)
        Lq, band = cfg.query_frame_len, cfg.band_width
        # align route: the fused kernel B3 for a matrix in its nibble range
        # where fused_ok holds, else the score-fed B6 or B5
        self.route = (
            "fused" if words is not None and sw_fused.fused_ok(Lq, band)
            else score_fed_route(Lq, band)
        )
        # the score-fed plain versions' chunk on the CPU (the JAX engine's
        # rule): a hard cap of 8192 alignments and 128 MB of int32 score
        # tile; a CUDA launch takes the whole batch
        n_sw = cfg.query_batch * NFRAMES * cfg.candidates_per_frame
        mem_cap = max(128, (128 << 20) // (Lq * band * 4))
        self.chunk = max(128, min(8192, _round_up(n_sw, 128),
                                  mem_cap // 128 * 128))
        self.cfg = cfg
        self.index = index
        self.n_shards = index.buffers.shape[0]
        # the index shards this engine holds on its device
        own = (range(self.n_shards) if mesh is None else [mesh.db_index])
        check_codes(index.buffers, "the index buffer")
        self.lead = lead_pad(cfg)
        self.matrix_np = mat
        self.expand = index.expand_width
        self.nbins = diag_bins(cfg, index)
        cand_mod.check_vote_keys(index.subject_ids.shape[1], self.nbins)
        if key_table is None:
            key_table = key_tables_for(cfg, index,
                                       colocated_shards=mesh is None,
                                       shards=own)
        maps, self.table_mode, self.table_width = key_table
        if len(maps) != len(own):
            raise ValueError(f"key_table has {len(maps)} shards, the engine "
                             f"holds {len(own)}")
        self.key_table = key_table
        # the presorted-run stage skip needs runs that tile power-of-two
        # blocks of the key row: direct rows always (run = row width), CSR
        # rows never
        self.presorted_run = (self.table_width
                              if self.table_mode == "direct" else 0)
        dev = self.device
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.matrix = to(mat.astype(np.int32))
        # the align route's score table, once (a wrapper would build it, or
        # read its largest value, every call)
        self.sw_table = (
            sw_fused.score_table(self.matrix, self.code_limit)
            if self.route == "fused" else sw_scored.code_table(self.matrix,
                                                               band)
        )
        self.sw_table_max = int(self.sw_table.max())
        # refine's score table (kernel R1), once
        self.refine_table = refine_mod.score_table(self.matrix)
        self.refine_table_max = int(self.refine_table.max())
        self.shard_dev: List[dict] = []
        for i, (tab_main, tab_aux) in zip(own, maps):
            st = index.shards[i].store
            n = st.num_subjects
            ident = n > 0 and bool(
                (np.asarray(st.subject_ids) == np.arange(n)).all())
            self.shard_dev.append(dict(
                buffer=to(pad_buffer(index.buffers[i], cfg)),
                bucket_starts=(to(index.bucket_starts[i].astype(np.int32))
                               if self.table_mode == "csr" else None),
                starts=to(index.starts[i].astype(np.int32)),
                subject_ids=to(index.subject_ids[i].astype(np.int32)),
                lengths=to(index.lengths[i].astype(np.int32)),
                tab_main=to(tab_main),
                tab_aux=to(tab_aux),
                srow_identity=n if ident else 0,
            ))
        # the step's CUDA graphs, by the batch shape whose eager warm-up
        # batch ran (search_refine_async_dna)
        self._graphs: Dict[tuple, StepGraphs] = {}
        self._graphing: StepGraphs | None = None   # set while a step replays
        self.graph_captures = 0
        self.graph_replays = 0
        self.graph_eager = 0
        self.last_graph_stages = 0
        self._copy_stream = None   # the payloads' copies to the host

    # ------------------------------------------------------------------
    # CUDA graphs of the step's stages (module docstring)

    def _graphs_on(self) -> bool:
        """Does search_refine_async_dna replay graphs? On a CUDA engine of
        one device (a grid rank's step runs collectives between stages)."""
        return graphs_device(self.device) and self.mesh is None

    def _stage(self, name: str, fn, *args):
        """Stage `name` of the step, fn(*args): eager, or inside a graphed
        step replayed from its graph (the graph's static outputs), which
        the stage's first call for the batch shape captures."""
        gs = self._graphing
        if gs is None:
            if graphs_device(self.device):
                self.graph_eager += 1
            return fn(*args)
        sig = _signature(args)
        st = gs.stages.get(name)
        if st is None:
            st = gs.stages[name] = self._capture(gs, fn, args, sig)
        elif st.signature != sig:
            raise RuntimeError(f"step graph {name}: called on other tensors "
                               "than it was captured on")
        with span("step.replay"):
            st.graph.replay()
        self.graph_replays += 1
        return st.out

    def _capture(self, gs: StepGraphs, fn, args, sig) -> _Stage:
        """fn(*args) captured into a new graph in the shape's pool; the
        capture runs nothing (thread-local: the flush thread may fetch
        meanwhile)."""
        if gs.pool is None:
            gs.pool = torch.cuda.graph_pool_handle()
        rg = _build.Replayed(torch.cuda.CUDAGraph())
        with rg.recording(), torch.cuda.graph(
                rg.graph, pool=gs.pool, capture_error_mode="thread_local"):
            out = fn(*args)
        self.graph_captures += 1
        return _Stage(rg, out, sig)

    def _stage_in(self, gs: StepGraphs, dna: np.ndarray,
                  lens: np.ndarray) -> None:
        """The batch's DNA and lengths into the graph's static inputs, on
        the current stream. On a CUDA device through the pinned staging,
        without waiting for the device: the host waits only until the
        previous batch's copy has left the staging. (On the CPU, which
        runs no graph but the tests' stand-in, a plain copy.)"""
        if self.device.type != "cuda":
            gs.dna.copy_(torch.from_numpy(dna))
            gs.lens.copy_(torch.from_numpy(lens))
            return
        if not gs.host:
            gs.host = (torch.empty(dna.shape, dtype=gs.dna.dtype,
                                   pin_memory=True),
                       torch.empty(lens.shape, dtype=gs.lens.dtype,
                                   pin_memory=True))
            gs.copied = torch.cuda.Event()
        gs.copied.synchronize()
        for dst, staged, src in zip((gs.dna, gs.lens), gs.host, (dna, lens)):
            # numpy's copy runs on this thread; torch's would wake its
            # intra-op thread pool, whose threads then spin beside the flush
            np.copyto(staged.numpy(), src)
            dst.copy_(staged, non_blocking=True)
        gs.copied.record()

    def _graphed_step(self, gs: StepGraphs) -> torch.Tensor:
        """step_dna on the shape's static inputs, every stage replayed (or
        captured, then replayed): the static output."""
        replays = self.graph_replays
        self._graphing = gs
        try:
            out = self.step_dna(gs.dna, gs.lens)
        finally:
            self._graphing = None
        self.last_graph_stages = self.graph_replays - replays
        return out

    # ------------------------------------------------------------------
    def propose_one(self, qflat: torch.Tensor, d: dict,
                    check: bool = False):
        """propose_shard on the shard `d` (a shard_dev entry) with this
        engine's statics: its (gsid, lbin, votes), each (R*6, ncand)."""
        cfg = self.cfg
        return propose_shard(
            qflat, d["bucket_starts"], d["tab_main"], d["tab_aux"],
            d["subject_ids"], seed_len=cfg.seed_len, expand=self.expand,
            band=cfg.band_width, ncand=cfg.candidates_per_frame,
            min_votes=cfg.min_votes, nbins=self.nbins,
            table_width=self.table_width, mode=self.table_mode,
            presorted_run=self.presorted_run, smooth=cfg.smooth_bins,
            chain_gamma=cfg.chain_gamma, check=check,
        )

    def propose(self, qflat: torch.Tensor, check: bool = False):
        """(R*6, Lq) frames -> selected (gsid, lbin), each (R*6, ncand):
        every shard's proposals side by side, then the global top-ncand.
        check: propose_shard's bounds asserts and the NaN checks. The
        step's stage "propose"."""
        return self._stage("propose", self._propose, qflat, check)

    def _propose(self, qflat: torch.Tensor, check: bool):
        props = [self.propose_one(qflat, d, check) for d in self.shard_dev]
        pg, pb, pv = (torch.cat(x, dim=1) for x in zip(*props))
        _check_nans("propose", pg, pb, pv, check=check)
        sel_g, sel_b, _ = cand_mod.select_global(
            pg, pb, pv, self.cfg.candidates_per_frame)
        _check_nans("select", sel_g, sel_b, check=check)
        return sel_g, sel_b

    def align_one(self, qflat: torch.Tensor, d: dict, sel_g: torch.Tensor,
                  sel_b: torch.Tensor):
        """align_shard on the shard `d` with this engine's statics."""
        cfg = self.cfg
        return align_shard(
            qflat, d["buffer"], d["starts"], d["subject_ids"], d["lengths"],
            self.matrix, sel_g, sel_b, band=cfg.band_width,
            gap_open=cfg.gap_open, gap_extend=cfg.gap_extend, lead=self.lead,
            code_limit=self.code_limit, srow_identity=d["srow_identity"],
            route=self.route, chunk=self.chunk, table=self.sw_table,
            table_max=self.sw_table_max,
        )

    def align(self, qflat: torch.Tensor, sel_g: torch.Tensor,
              sel_b: torch.Tensor):
        """Each shard's align_shard over the selected candidates, every
        field stacked (n_shards, Qf, C). The step's stage "align"."""
        return self._stage("align", self._align, qflat, sel_g, sel_b)

    def _align(self, qflat: torch.Tensor, sel_g: torch.Tensor,
               sel_b: torch.Tensor):
        outs = [self.align_one(qflat, d, sel_g, sel_b)
                for d in self.shard_dev]
        return tuple(torch.stack(x) for x in zip(*outs))

    def search_packed(self, qcodes3: torch.Tensor,
                      check: bool = False) -> torch.Tensor:
        """propose -> select -> align -> rank on (R, 6, Lq) int8 frames;
        returns the ranked (9, R, K) int32 hits on the device. check: the
        bounds asserts and NaN checks of search_batch_checked."""
        R = qcodes3.shape[0]
        qflat = qcodes3.reshape(R * NFRAMES, self.cfg.query_frame_len)
        with span("step.propose"):
            sel_g, sel_b = self.propose(qflat, check=check)
        with span("step.align"):
            aligned = self.align(qflat, sel_g, sel_b)
            _check_nans("align", *aligned, check=check)
        with span("step.rank"):
            packed = self._stage("rank", merge_rank, aligned, sel_g, R,
                                 self.cfg.max_hits)
            _check_nans("rank", packed, check=check)
        return packed

    def translate(self, dna: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Six-frame translation on the host: (R, 6, Lq) int8 codes."""
        return six_frame_translate(dna, lens, self.cfg.query_frame_len)

    def search_batch_checked(self, qcodes: np.ndarray) -> BatchHits:
        """Debug mode (CLI --check): propose, select, align and rank on
        (R, 6, Lq) int8 frames through the step's own route (the kernels
        on CUDA, their plain versions on the CPU), asserting before each
        gather the JAX package runs unclamped that its index is in bounds,
        and checking every stage's floating outputs for NaN. Raises
        IndexError / FloatingPointError naming the site where the JAX
        package's checkify pass raises; the hits are the step's. Codes
        outside [0, ALPHA) raise ValueError (check_codes)."""
        check_codes(qcodes, "qcodes")
        q3 = torch.from_numpy(np.ascontiguousarray(qcodes)).to(self.device)
        out = self.fetch(self.search_packed(q3, check=True))
        return BatchHits(*(out[i] for i in range(9)))

    def windows_of(self, d: dict, g0: torch.Tensor, srow: torch.Tensor,
                   wlen: int):
        """Each hit's window (int8), span start and end in the shard `d`
        (a shard_dev entry), whichever shard owns the hit."""
        sr = srow.clamp(0, d["starts"].shape[0] - 1).to(torch.int64)
        lo = d["starts"][sr]
        return (fetch_windows(d["buffer"], g0, self.lead, wlen), lo,
                lo + d["lengths"][sr])

    def refine_packed(self, qcodes3: torch.Tensor,
                      packed: torch.Tensor) -> torch.Tensor:
        """Window fetch + moves DP + traceback for the ranked hits ->
        (9, R, K) stats, on the device. Each hit's window, span start and
        end come from the shard in its shard field: on a grid rank, the
        rank fetches those of the hits its shard owns and one all_reduce
        over "db" assembles them (parallel.search.gather_windows). The
        step's stage "refine"."""
        with span("step.refine"):
            return self._stage("refine", self._refine, qcodes3, packed)

    def _refine(self, qcodes3: torch.Tensor,
                packed: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        g0 = packed[6].reshape(-1)
        srow = packed[7].reshape(-1)
        shard = packed[8].reshape(-1)
        wlen = cfg.query_frame_len + cfg.band_width
        if self.mesh is not None:
            from ghostm_tpu_torch.parallel.search import gather_windows

            w, lo, hi = gather_windows(self, g0, srow, shard, wlen)
        else:
            for si, d in enumerate(self.shard_dev):
                w2, lo2, hi2 = self.windows_of(d, g0, srow, wlen)
                if si == 0:
                    w, lo, hi = w2, lo2, hi2
                else:
                    m = shard == si
                    w = torch.where(m[:, None], w2, w)
                    lo = torch.where(m, lo2, lo)
                    hi = torch.where(m, hi2, hi)
        # the kernel takes int8 windows (a grid rank's arrive as int32
        # slices of the all_reduce rows) and contiguous spans
        return refine_stats_packed(
            qcodes3, packed, self.matrix, w.to(torch.int8).contiguous(),
            lo.contiguous(), hi.contiguous(), band=cfg.band_width,
            gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
            table=self.refine_table, table_max=self.refine_table_max,
        )

    def step_dna(self, dna: torch.Tensor, lens: torch.Tensor,
                 pack: bool = True) -> torch.Tensor:
        """The whole batch step on device tensors: translate -> search ->
        refine -> (6, R, K) packed transport (or the (18, R, K) payload
        when the transport cannot hold this config's value ranges, or
        when pack is False)."""
        with span("step.translate"):
            qcodes3 = self._stage("translate", six_frame_translate_torch,
                                  dna, lens, self.cfg.query_frame_len)
            _check_nans("translate", qcodes3)
        packed = self.search_packed(qcodes3)
        stats = self.refine_packed(qcodes3, packed)
        _check_nans("refine", stats)
        with span("step.pack"):
            return self._stage("pack", self._pack, packed, stats, pack)

    def _pack(self, packed: torch.Tensor, stats: torch.Tensor,
              pack: bool) -> torch.Tensor:
        out = torch.cat([packed, stats])
        return self._pack_transport(out) if pack and self._pack_ok else out

    def search_refine_async_dna(self, dna: np.ndarray,
                                lens: np.ndarray) -> torch.Tensor:
        """One batch of raw DNA reads -> the step's output on the device,
        without fetching it (CUDA launches are asynchronous, so the
        pipeline overlaps this batch's device work with the previous
        batch's fetch and TSV write). A tail batch smaller than
        cfg.query_batch is padded with length-0 reads (all-PAD frames,
        inert) and the pad rows sliced off, as in the JAX package. One
        device's engine only (a grid searches through
        search_batch_stats). On a CUDA engine the step's stages replay
        their graphs from the second batch of a shape on (module
        docstring), and the output is a clone of the static one."""
        self._no_mesh("search_refine_async_dna")
        R = dna.shape[0]
        Rb = self.cfg.query_batch
        with span("step.h2d"):
            if R < Rb:
                dna = np.concatenate(
                    [dna, np.full((Rb - R,) + dna.shape[1:], 4, dna.dtype)]
                )
                lens = np.concatenate([lens, np.zeros(Rb - R, lens.dtype)])
            dna = np.ascontiguousarray(dna)
            lens = np.asarray(lens, np.int32)
            key = (dna.shape, dna.dtype)
            gs = self._graphs.get(key) if self._graphs_on() else None
            if gs is None:
                dna_d = torch.from_numpy(dna).to(self.device)
                lens_d = torch.from_numpy(lens).to(self.device)
            else:
                self._stage_in(gs, dna, lens)
        if gs is not None:
            out = self._graphed_step(gs)
            return self._copy_out((out[:, :R] if R < Rb else out).clone())
        out = self.step_dna(dna_d, lens_d)
        self.last_graph_stages = 0
        if self._graphs_on():
            # the shape's warm-up batch ran: the next one captures
            self._graphs[key] = StepGraphs(torch.empty_like(dna_d),
                                           torch.empty_like(lens_d))
        return self._copy_out(out[:, :R] if R < Rb else out)

    def _copy_out(self, payload: torch.Tensor) -> torch.Tensor:
        """Start payload's copy to pinned host memory once the step's
        device work is done, on the engine's copy stream; `fetch` waits
        for it (module docstring). A CPU payload is returned as it is."""
        if payload.device.type != "cuda":
            return payload
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        stream = self._copy_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        host = torch.empty(payload.shape, dtype=payload.dtype,
                           pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(payload, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        payload.record_stream(stream)
        payload.host_copy = (host, done)
        return payload

    # ------------------------------------------------------------------
    # The codes entry: (R, 6, Lq) int8 translated frames from the host
    # (SearchEngine.translate), as the JAX package's engine takes them.

    def _no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise ValueError(f"{what} runs on one device's engine; a grid "
                             "rank searches through search_batch_stats")

    def _codes(self, qcodes: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(qcodes)).to(self.device)

    def search_batch(self, qcodes: np.ndarray) -> BatchHits:
        """The ranked top-k hits of (R, 6, Lq) frames (host numpy). On a
        grid rank: search_batch_stats(qcodes)[0], the whole batch."""
        if self.mesh is not None:
            return self.search_batch_stats(qcodes)[0]
        out = self.fetch(self.search_packed(self._codes(qcodes)))
        return BatchHits(*(out[i] for i in range(9)))

    def _grid_block(self, qcodes: np.ndarray):
        """This rank's row block of the batch through the grid step:
        ((18, Rl, K) on the device, its first row, R). R is padded to a
        multiple of the data axis with inert reads (code-25 frames) first,
        so a tail batch runs (fault F6 of the JAX package's mesh, which
        cannot reshape a block whose read count does not divide)."""
        from ghostm_tpu_torch.parallel.search import distributed_step

        if self.mesh is None:
            raise ValueError("search_batch_stats needs a grid engine "
                             "(mesh=); one device's engine runs "
                             "search_refine_async")
        R = qcodes.shape[0]
        n = self.mesh.data
        Rp = _round_up(max(R, 1), n)
        qcodes = _pad_reads(qcodes, Rp)
        Rl = Rp // n
        st0 = self.mesh.data_index * Rl
        out = distributed_step(self, self._codes(qcodes[st0:st0 + Rl]))
        return out, st0, R

    def search_batch_stats(self, qcodes: np.ndarray):
        """A grid rank's step on (R, 6, Lq) frames: the ranked hits AND
        their refine stats for the WHOLE batch on every rank (the row
        blocks gathered over "data"; no process holds JAX's global array).
        Returns (BatchHits, stats dict with score_check), host numpy."""
        out, _, R = self._grid_block(qcodes)
        full = self.mesh.all_gather(out, "data", "rows")  # (data, 18, Rl, K)
        full = full.permute(1, 0, 2, 3).reshape(out.shape[0], -1,
                                                out.shape[2])
        return self.unpack_results(self.fetch(full[:, :R]))

    def search_batch_stats_local(self, qcodes: np.ndarray):
        """The multi-process form: every rank runs the step, and db rank 0
        of each data row returns its row block, [(row_start, BatchHits,
        stats)] (the JAX package's replica 0); the other ranks return [].
        Each global row comes back from exactly one process."""
        out, st0, R = self._grid_block(qcodes)
        n = min(out.shape[1], R - st0)
        if self.mesh.db_index != 0 or n <= 0:
            return []
        return [(st0, *self.unpack_results(self.fetch(out[:, :n])))]

    def refine(self, qcodes: np.ndarray,
               hits: BatchHits) -> Dict[str, np.ndarray]:
        """Alignment stats of the reported hits (all (R, K), host numpy):
        qstart/qend (frame-local aa, inclusive), sstart/send
        (window-local), length, matches, mismatch, gapopen, -1 coordinates
        on score-0 hits, and score_check (the moves DP's score). The hits
        go to the device and through refine_packed; on a grid every rank
        of a data row calls it with the same hits."""
        packed = np.stack([getattr(hits, f) for f in
                           BatchHits.__dataclass_fields__]).astype(np.int32)
        out = self.fetch(self.refine_packed(self._codes(qcodes),
                                            self._codes(packed)))
        stats = {k: out[j] for j, k in enumerate(self.STAT_KEYS)}
        stats["score_check"] = out[8]
        return stats

    def search_refine_async(self, qcodes: np.ndarray) -> torch.Tensor:
        """search + refine of (R, 6, Lq) frames without fetching: the
        (18, R, K) payload on the device. A batch shorter than
        cfg.query_batch is padded with inert reads (code-25 frames) and
        the pad rows sliced off, as in the JAX package."""
        self._no_mesh("search_refine_async")
        R = qcodes.shape[0]
        Rb = self.cfg.query_batch
        q3 = self._codes(_pad_reads(qcodes, Rb))
        packed = self.search_packed(q3)
        out = torch.cat([packed, self.refine_packed(q3, packed)])
        return out[:, :R] if R < Rb else out

    @staticmethod
    def fetch(payload: torch.Tensor) -> np.ndarray:
        """Device payload -> host numpy (waits for the device): the copy
        search_refine_async_dna started where there is one."""
        started = getattr(payload, "host_copy", None)
        if started is None:
            return payload.cpu().numpy()
        host, done = started
        done.synchronize()
        return host.numpy()

    # ------------------------------------------------------------------
    def _pack_transport(self, out18: torch.Tensor) -> torch.Tensor:
        """(18, R, K) step output -> (6, R, K) int32 transport holding
        exactly the fields report.write_hits consumes. Bounds asserted by
        _pack_ok; bit-exact round trip through unpack_transport."""
        score, gsid, frame = out18[0], out18[1], out18[2]
        s_end = out18[4]
        qs, qe, ss, se = (out18[9] + 1, out18[10] + 1, out18[11] + 1,
                          out18[12] + 1)
        length, matches, mism, gap = (out18[13], out18[14], out18[15],
                                      out18[16])
        w1 = (score << 15) | (frame << 12) | gap
        w2 = (qs << 13) | qe
        w3 = (ss << 13) | se
        w4 = (length << 13) | matches
        w5 = (mism << 19) | s_end
        return torch.stack([gsid, w1, w2, w3, w4, w5])

    @functools.cached_property
    def _pack_ok(self) -> bool:
        """Can the packed transport hold this config's value ranges?
        (score < 2^17, coords+1 < 2^13, subject-local end < 2^19,
        mismatch < 2^13, gapopen < 2^12.)"""
        cfg = self.cfg
        Lq, B = cfg.query_frame_len, cfg.band_width
        max_score = int(self.matrix_np.max()) * Lq
        return bool(
            Lq + B + 2 < (1 << 13)
            and max_score < (1 << 17)
            and Lq < (1 << 12)
            and int(self.index.lengths.max()) + B + Lq < (1 << 19)
        )

    def unpack_transport(self, arr: np.ndarray):
        """(6, R, K) packed transport -> (BatchHits, stats). Fields the
        writer never reads come back as zeros; score_check is omitted."""
        w = arr.astype(np.uint32)
        z = np.zeros_like(arr[0])
        score = (w[1] >> 15).astype(np.int32)
        frame = ((w[1] >> 12) & 7).astype(np.int32)
        gap = (w[1] & 0xFFF).astype(np.int32)
        qs = ((w[2] >> 13) & 0x1FFF).astype(np.int32) - 1
        qe = (w[2] & 0x1FFF).astype(np.int32) - 1
        ss = ((w[3] >> 13) & 0x1FFF).astype(np.int32) - 1
        se = (w[3] & 0x1FFF).astype(np.int32) - 1
        length = ((w[4] >> 13) & 0x1FFF).astype(np.int32)
        matches = (w[4] & 0x1FFF).astype(np.int32)
        mism = (w[5] >> 19).astype(np.int32)
        s_end = (w[5] & 0x7FFFF).astype(np.int32)
        hits = BatchHits(
            score=score, gsid=arr[0], frame=frame, qend=z, s_end=s_end,
            bend=z, g0=z, srow=z, shard=z,
        )
        stats = dict(qstart=qs, qend=qe, sstart=ss, send=se, length=length,
                     matches=matches, mismatch=mism, gapopen=gap)
        return hits, stats

    def unpack_results(self, arr: np.ndarray):
        """Fetched step output -> (BatchHits, stats dict); accepts the full
        (18, R, K) payload or the (6, R, K) packed transport."""
        if arr.shape[0] == 6:
            return self.unpack_transport(arr)
        hits = BatchHits(*(arr[i] for i in range(9)))
        stats: Dict[str, np.ndarray] = {
            k: arr[9 + j] for j, k in enumerate(self.STAT_KEYS)
        }
        stats["score_check"] = arr[17]
        return hits, stats
