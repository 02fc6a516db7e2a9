"""Stage R1, refine: the moves DP and the traceback walk of the ranked hits
as one hand-written kernel (csrc/refine.cu), beside its plain PyTorch
version.

Replaces the JAX package's XLA stage engine.py::_refine_device (banded
scores, the subject-span mask, sw_xla.sw_banded_moves and
sw_xla.traceback_stats_device inside the step's one device program; no
Pallas kernel). The plain version runs those steps in torch: a loop of
Lq rows of small launches, then a walk of up to 2 (Lq + band) + 4 steps.
The kernel runs both in one launch, in one of two layouts that `layout`
picks from the hits an SM and Lq:
  - the thread layout, for N that fills the card (the main path's short
    frames): each alignment on 1, 2 or 4 lanes of 32 diagonals, one score
    table in shared memory, DPX, moves to a word plane coalesced across
    alignments, walked back by the group's lane 0;
  - the warp layout, for few hits or long frames: an alignment on 32
    lanes of 1, 2 or 4 diagonals, its codes staged in shared memory, E by
    a scan over the lanes, moves to an alignment-major byte plane that
    the walk copies back into shared memory a block of rows at a time.
`launch` and `refine_moves` take a layout's lanes to force it (the card
tests run every case in each).

Contract: per hit n of N = R * K, query frame qcodes3[n // K,
clamp(frame, 0, 5)], window w[n], cells with g0 + i + b outside
[lo[n], hi[n]) scored LOW; returns (9, R, K) int32: qstart, qend,
sstart, send, length, matches, mismatch, gapopen (the engine's
STAT_KEYS), then the score (score_check). Hits whose score is <= 0 give
-1 coordinates and zero counts. Equal to the JAX package's
refine_stats_packed on the frames the engine's rank gives (0-5; jnp
wraps a negative frame where this clamps it to 0).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ghostm_tpu_torch.kernels import _build, sw_scored, sw_xla
from ghostm_tpu_torch.ops.scoring import LOW

NFRAMES = 6
STAT_KEYS = ("qstart", "qend", "sstart", "send", "length", "matches",
             "mismatch", "gapopen")
MAX_BAND = sw_scored.MAX_BAND   # csrc/refine.cu: up to 4 lanes of 32
TCOLS = sw_scored.TCOLS         # the table's column 32: outside the span

WARP_MAX_LQ = 65536   # csrc/refine.cu: the warp layout's longest query

_P = ctypes.c_void_p
_I = ctypes.c_int
_SMS: dict = {}


def score_table(matrix: torch.Tensor) -> torch.Tensor:
    """(32, 32) padded scoring matrix -> the kernel's (32, 33) int32 table:
    the matrix as it is (LOW entries included), column 32 LOW (a cell
    outside the subject span)."""
    m = matrix.to(torch.int32)
    return torch.cat([m, torch.full_like(m[:, :1], LOW)], 1).contiguous()


def query_codes(qcodes3: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """(R*K, Lq) query codes of the ranked hits: each hit's frame."""
    R, _, Lq = qcodes3.shape
    K = packed.shape[2]
    frame = packed[2].reshape(-1).clamp(0, NFRAMES - 1).to(torch.int64)
    flat_read = torch.arange(R, device=qcodes3.device).repeat_interleave(K)
    return qcodes3[flat_read, frame]


def moves_plain(qcodes3, packed, matrix, w, lo, hi, *, band: int,
                gap_open: int, gap_extend: int):
    """The DP of the plain version: banded scores, the span mask and
    sw_banded_moves -> (score, i_end, b_end, moves (N, Lq, band) uint8)."""
    Lq = qcodes3.shape[2]
    g0 = packed[6].reshape(-1)
    qc = query_codes(qcodes3, packed).to(torch.int32)
    sc = sw_xla.banded_scores(qc, w, matrix, band)
    sc = torch.where(sw_xla.in_span(g0, lo, hi, Lq, band), sc,
                     torch.full_like(sc, LOW))
    return sw_xla.sw_banded_moves(sc, gap_open, gap_extend)


def refine_stats_plain(qcodes3, packed, matrix, w, lo, hi, *, band: int,
                       gap_open: int, gap_extend: int) -> torch.Tensor:
    """The plain version: moves_plain, then traceback_stats_device ->
    (9, R, K) int32."""
    R, K = packed.shape[1:]
    s2, ie2, be2, moves = moves_plain(
        qcodes3, packed, matrix, w, lo, hi, band=band, gap_open=gap_open,
        gap_extend=gap_extend)
    stats = sw_xla.traceback_stats_device(
        moves, ie2, be2, query_codes(qcodes3, packed), w)
    rows = [stats[k] for k in STAT_KEYS] + [s2]
    return torch.stack([r.reshape(R, K) for r in rows])


def _align16(x: int) -> int:
    return (x + 15) & ~15


def group_lanes(band: int) -> int:
    """The thread layout's lanes an alignment, 32 diagonals each (1, 2 or
    4); also the warp layout's diagonals a lane."""
    return 1 if band <= 32 else 2 if band <= 64 else 4


def layouts(Lq: int, band: int) -> list:
    """Every layout the kernel takes at this shape, as (lanes an
    alignment, diagonals a lane): the thread layout, then the warp layout
    up to WARP_MAX_LQ (its shared memory holds a query that long)."""
    g = group_lanes(band)
    return [(g, 32)] + ([(32, g)] if Lq <= WARP_MAX_LQ else [])


def layout(N: int, Lq: int, band: int, sm_count: int):
    """The layout the kernel runs in -> (lanes an alignment, diagonals a
    lane): the thread layout once the hits an SM, N / sm_count, reach
    56 + Lq / 5 (the main path's 81,920 hits at Lq 40 and 88: 621 an SM),
    the warp layout below that (1,280 hits at 5 kbp: 1,280 warps where
    the thread layout gives 80). The threshold follows where the two
    layouts' device times cross on an H100 (chip_smoke.py --refine-rows's
    sweep, PERF.md section 6): later at longer frames. Both cover the
    band: lanes x diagonals >= band."""
    opts = layouts(Lq, band)
    if N >= (56 + Lq / 5) * sm_count or len(opts) == 1:
        return opts[0]
    return opts[1]


def sm_count(dev: torch.device) -> int:
    """The card's SM count (read once a device)."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def check_args(qcodes3, packed, w, lo, hi, band: int, gap_open: int,
               gap_extend: int, table, table_max: int) -> None:
    """Raise ValueError for what the CUDA kernel does not take: a band
    outside [1, MAX_BAND], a negative gap cost, a query longer than the
    best cell's key holds (sw_scored.max_lq), inputs that are not
    contiguous int8 frames and windows, int32 hits, spans and table, all
    on one device, or shapes that do not fit together."""
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"refine: CUDA band must be in [1, {MAX_BAND}], "
                         f"got {band}")
    if gap_open < 0 or gap_extend < 0:
        raise ValueError(f"refine: CUDA needs gap costs >= 0, got "
                         f"{gap_open}/{gap_extend}")
    R, nf, Lq = qcodes3.shape
    if Lq > sw_scored.max_lq(table_max):
        raise ValueError(f"refine: CUDA takes queries up to "
                         f"{sw_scored.max_lq(table_max)} codes on a table "
                         f"of largest value {table_max}, got {Lq}")
    K = packed.shape[2] if packed.dim() == 3 else 0
    N = R * K
    if nf != NFRAMES or packed.shape != (9, R, K) or K < 1:
        raise ValueError("refine: want (R, 6, Lq) frames and (9, R, K) hits, "
                         f"got {tuple(qcodes3.shape)}, {tuple(packed.shape)}")
    if w.dim() != 2 or w.shape[0] != N or w.shape[1] < Lq + band:
        raise ValueError(f"refine: windows must be ({N}, >= {Lq + band}), "
                         f"got {tuple(w.shape)}")
    if lo.shape != (N,) or hi.shape != (N,):
        raise ValueError(f"refine: lo/hi must be ({N},)")
    if table.shape != (32, TCOLS):
        raise ValueError(f"refine: table must be (32, {TCOLS})")
    for x, dt in ((qcodes3, torch.int8), (packed, torch.int32),
                  (w, torch.int8), (lo, torch.int32), (hi, torch.int32),
                  (table, torch.int32)):
        if x.dtype != dt or not x.is_contiguous() \
                or x.device != qcodes3.device:
            raise ValueError(f"refine inputs: want contiguous {dt} on "
                             f"{qcodes3.device}, got {x.dtype} on {x.device}")


def launch(qcodes3, packed, w, lo, hi, table, *, band: int, gap_open: int,
           gap_extend: int, table_max: Optional[int], walk: bool,
           lanes: Optional[int] = None):
    """Check the inputs, then run csrc/refine.cu over every hit in one
    launch, counting it -> (out, plane): out (9, N) int32 when walk, else
    (3, N) (score, i_end, b_end); plane the moves: in the thread layout
    (Lq, ceil(band / 4), N) int32 words, in the warp layout (N, S) uint8,
    S = Lq * round_up(band, 4) rounded up to 16. lanes: the layout's lanes
    an alignment, one of `layouts` (None: `layout`'s choice)."""
    if table_max is None:
        table_max = int(table.max())
    check_args(qcodes3, packed, w, lo, hi, band, gap_open, gap_extend,
               table, table_max)
    R, _, Lq = qcodes3.shape
    K = packed.shape[2]
    N = R * K
    dev = qcodes3.device
    if lanes is None:
        lanes = layout(N, Lq, band, sm_count(dev))[0]
    if lanes not in [a for a, _ in layouts(Lq, band)]:
        raise ValueError(f"refine: no layout of {lanes} lanes at Lq {Lq}, "
                         f"band {band}; have {layouts(Lq, band)}")
    out = torch.empty((9 if walk else 3, N), dtype=torch.int32, device=dev)
    if lanes == 32:
        plane = torch.empty((N, _align16(Lq * (-(-band // 4) * 4))),
                            dtype=torch.uint8, device=dev)
    else:
        plane = torch.empty((Lq, -(-band // 4), N), dtype=torch.int32,
                            device=dev)
    if N == 0:
        return out, plane
    fn = _build.load("refine").ghostm_refine
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                   _I, _I, _P, _P]
    fn.restype = _I
    _build.check(fn(
        qcodes3.data_ptr(), packed.data_ptr(), w.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), table.data_ptr(), N, K, Lq, w.shape[1], band,
        gap_open, gap_extend, plane.data_ptr(), int(walk), lanes,
        out.data_ptr(), _build.stream_ptr(dev),
    ), "refine")
    _build.count("refine", w.shape)
    return out, plane


def refine_stats(qcodes3: torch.Tensor, packed: torch.Tensor,
                 matrix: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, *, band: int, gap_open: int,
                 gap_extend: int, table: Optional[torch.Tensor] = None,
                 table_max: Optional[int] = None) -> torch.Tensor:
    """Refine the ranked hits (see the module docstring).

    qcodes3 (R, 6, Lq) int8 frames; packed (9, R, K) int32 ranked hits;
    matrix (32, 32) int32 padded scoring table; w (R*K, >= Lq + band)
    int8 windows (the plain version also takes wider integer types); lo /
    hi (R*K,) int32 subject spans; table: score_table(matrix) on the
    device and table_max its largest value, from a caller that launches
    many times (else built and read here, a wait for the device). CPU
    tensors run the plain version, CUDA tensors the kernel. Returns
    (9, R, K) int32."""
    if qcodes3.device.type == "cpu":
        return refine_stats_plain(qcodes3, packed, matrix, w, lo, hi,
                                  band=band, gap_open=gap_open,
                                  gap_extend=gap_extend)
    if table is None:
        table = score_table(matrix.to(qcodes3.device))
    out, _ = launch(qcodes3, packed, w, lo, hi, table, band=band,
                    gap_open=gap_open, gap_extend=gap_extend,
                    table_max=table_max, walk=True)
    return out.view(9, *packed.shape[1:])


def refine_moves(qcodes3, packed, w, lo, hi, table, *, band: int,
                 gap_open: int, gap_extend: int,
                 lanes: Optional[int] = None):
    """The kernel's debug entry: the DP alone, no walk -> (score, i_end,
    b_end, moves) as sw_xla.sw_banded_moves returns them, moves the
    (N, Lq, band) uint8 plane the kernel wrote, whatever its layout
    (lanes: as launch takes it). CUDA tensors only."""
    out, plane = launch(qcodes3, packed, w, lo, hi, table, band=band,
                        gap_open=gap_open, gap_extend=gap_extend,
                        table_max=None, walk=False, lanes=lanes)
    Lq = qcodes3.shape[2]
    bp = -(-band // 4) * 4
    if plane.dtype == torch.uint8:   # the warp layout: (N, S) bytes
        N = plane.shape[0]
        moves = plane[:, :Lq * bp].reshape(N, Lq, bp)
    else:
        _, wpr, N = plane.shape
        moves = plane.view(torch.uint8).view(Lq, wpr, N, 4).permute(
            2, 0, 1, 3).reshape(N, Lq, bp)
    return out[0], out[1], out[2], moves[:, :, :band]
