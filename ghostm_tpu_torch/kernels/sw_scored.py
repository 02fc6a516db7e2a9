"""Kernel B5: banded Smith-Waterman for the score-fed route, from the codes
and an int32 score table (csrc/sw_scored.cu), beside its plain PyTorch
version.

Counterpart of the JAX package's kernels/sw_pallas.py (`sw_banded_pallas`,
the Pallas kernel `_sw_kernel`): the engine's score-fed align path for
matrices outside the fused kernel's nibble range (BLOSUM50, PAM) or bands
`fused_ok` refuses, at frames too short for B6's route. The TPU kernel
reads an (N, Lq, B) score tile that XLA builds beforehand. The CUDA kernel
reads the codes and `code_table`, the tile's cells by (query code, window
code) with column 32 for a cell outside the subject span, so no tile is
built and one launch takes a whole batch; its DP is B3's
(csrc/sw_common.cuh).

The tile route is the JAX engine's (engine.py:737-745), fixed by the band:
  band % 32 == 0: int8 masked tiles (sw_xla.banded_scores_i8): a matrix
    entry <= -100 or a cell outside the span is masked (NEG);
  otherwise: int32 tiles (sw_xla.banded_scores), matrix values as they are
    (LOW entries included) and LOW outside the span.
The plain version builds that tile from the table (`tile_from_table`) and
runs `sw_banded_scored_plain` on it; the tile-fed plain version is also
what the tests hold against the JAX package's Pallas kernel.

Contract (equal to sw_xla.sw_banded on the route's tile): per alignment
(score, i_end, b_end) int32 — max score, then min i, then min b; (-1, -1)
when the score is <= 0. Any N; on CUDA bands 1..MAX_BAND, gap costs >= 0
and Lq up to `max_lq` (the TPU kernel's N % 128 and row-tile padding were
tiling rules of the TPU, and padded rows never change a result).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ghostm_tpu_torch.kernels import _build, sw_fused, sw_xla
from ghostm_tpu_torch.kernels.sw_xla import MASKED_I8, NEG
from ghostm_tpu_torch.ops.scoring import LOW

MAX_BAND = 128   # csrc/sw_common.cuh: up to 4 lanes of 32 diagonals
MASK_CODE = 32   # the table column of a window position outside the span
TCOLS = 33

_P = ctypes.c_void_p
_I = ctypes.c_int


def code_table(matrix: torch.Tensor, band: int) -> torch.Tensor:
    """(32, 32) padded scoring matrix -> the (32, 33) int32 table of the
    band's tile route: entry [q, w] is the tile cell of query code q and
    window code w inside the subject span, column MASK_CODE the cell
    outside it."""
    m = matrix.to(torch.int32)
    if band % 32 == 0:
        m = torch.where(m > -100, m.clamp(max=127), torch.full_like(m, NEG))
        outside = NEG
    else:
        outside = LOW
    return torch.cat([m, torch.full_like(m[:, :1], outside)], 1).contiguous()


def max_lq(table_max: int) -> int:
    """The longest query the CUDA kernel takes on a table whose largest
    value is table_max: its best-cell key H * 32 + (31 - k) fits an int32
    while H <= table_max * Lq < 2^26."""
    return ((1 << 26) - 1) // max(table_max, 1)


def check_code_args(Lq: int, band: int, gap_open: int, gap_extend: int,
                    table_max: int, who: str) -> None:
    """Raise ValueError for what the CUDA score-fed kernels do not take: a
    band outside [1, MAX_BAND], a query longer than max_lq(table_max), a
    negative gap cost (diagonals past a band that is not a multiple of 32
    are held at a large negative value, which a negative cost could
    lift)."""
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"{who}: CUDA band must be in [1, {MAX_BAND}], got "
                         f"{band}")
    if Lq > max_lq(table_max):
        raise ValueError(f"{who}: CUDA takes queries up to "
                         f"{max_lq(table_max)} codes on a table of largest "
                         f"value {table_max}, got {Lq}")
    if gap_open < 0 or gap_extend < 0:
        raise ValueError(f"{who}: CUDA needs gap costs >= 0, got "
                         f"{gap_open}/{gap_extend}")


def tile_from_table(qcodes, windows, table, rel_lo, rel_hi,
                    band: int) -> torch.Tensor:
    """The route's (N, Lq, band) score tile: table[q[i], w[i + b]] where
    window position i + b lies in [rel_lo, rel_hi), table[q[i], MASK_CODE]
    elsewhere; int8 with MASKED_I8 for NEG when band % 32 == 0 (as
    sw_xla.banded_scores_i8 gives it), else int32. Codes lie in [0, 32)."""
    Lq = qcodes.shape[1]
    t = sw_xla.skewed_windows(windows, Lq, band).to(torch.int32)
    inb = sw_xla.in_span(torch.zeros_like(rel_lo), rel_lo, rel_hi, Lq, band)
    col = torch.where(inb, t, torch.full_like(t, MASK_CODE))
    sc = table.reshape(-1)[qcodes.to(torch.int32)[:, :, None] * TCOLS + col]
    if band % 32 == 0:
        sc = torch.where(sc == NEG, torch.full_like(sc, MASKED_I8), sc)
        sc = sc.to(torch.int8)
    return sc


def sw_banded_scored_plain(sc: torch.Tensor, gap_open: int, gap_extend: int):
    """Banded SW on a score tile (int8 masked or int32): sw_xla.sw_banded."""
    return sw_xla.sw_banded(sc, gap_open, gap_extend)


def sw_scored_codes_plain(qcodes, windows, table, rel_lo, rel_hi,
                          gap_open: int, gap_extend: int, band: int):
    """The plain version: the route's tile, then sw_banded_scored_plain."""
    sc = tile_from_table(qcodes, windows, table, rel_lo, rel_hi, band)
    return sw_banded_scored_plain(sc, gap_open, gap_extend)


def launch(name: str, qcodes, windows, table, rel_lo, rel_hi, gap_open: int,
           gap_extend: int, band: int, table_max: Optional[int]):
    """Check the inputs, then run csrc/sw_scored.cu's ghostm_<name> over
    every alignment in one launch, counting it -> (score, i_end, b_end)."""
    N, Lq = qcodes.shape
    if (table.dtype != torch.int32 or table.shape != (32, TCOLS)
            or not table.is_contiguous() or table.device != qcodes.device
            or table.data_ptr() % 16):
        raise ValueError(f"{name} table: want a contiguous, 16-byte aligned "
                         f"(32, {TCOLS}) int32 tensor on {qcodes.device} "
                         "from code_table")
    if table_max is None:
        table_max = int(table.max())
    check_code_args(Lq, band, gap_open, gap_extend, table_max, name)
    sw_fused.check_code_inputs(qcodes, windows, rel_lo, rel_hi, band, name)
    out = torch.empty((3, N), dtype=torch.int32, device=qcodes.device)
    if N == 0:
        return out[0], out[1], out[2]
    fn = getattr(_build.load("sw_scored"), f"ghostm_{name}")
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    _build.check(fn(
        qcodes.data_ptr(), windows.data_ptr(), rel_lo.data_ptr(),
        rel_hi.data_ptr(), table.data_ptr(), N, Lq, windows.shape[1], band,
        gap_open + gap_extend, gap_extend, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), _build.stream_ptr(qcodes.device),
    ), name)
    _build.count(name, (N, Lq, band))
    return out[0], out[1], out[2]


def sw_scored_codes(qcodes: torch.Tensor, windows: torch.Tensor,
                    table: torch.Tensor, rel_lo: torch.Tensor,
                    rel_hi: torch.Tensor, gap_open: int, gap_extend: int,
                    band: int, table_max: Optional[int] = None):
    """Batched banded SW of the score-fed route (see the module docstring).

    qcodes (N, Lq) int8 query codes; windows (N, >= Lq + band) int8 window
    codes; table: code_table(matrix, band) on the same device; rel_lo /
    rel_hi (N,) int32 subject span in window coordinates; table_max: the
    table's largest value, from a caller that launches many times (else
    read here, a wait for the device). CPU tensors run the plain version,
    CUDA tensors kernel B5. Returns (score, i_end, b_end), each (N,)
    int32."""
    if qcodes.device.type == "cpu":
        return sw_scored_codes_plain(qcodes, windows, table, rel_lo, rel_hi,
                                     gap_open, gap_extend, band)
    return launch("sw_scored", qcodes, windows, table, rel_lo, rel_hi,
                  gap_open, gap_extend, band, table_max)
