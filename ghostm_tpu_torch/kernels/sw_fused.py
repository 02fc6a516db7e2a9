"""Kernel B3: banded Smith-Waterman with the substitution scores looked up
inside the kernel (csrc/sw_fused.cu), beside its plain PyTorch version.

Replaces the JAX package's kernels/sw_fused.py::sw_fused_wave. There the
scores came from nibble-packed profile words and select trees because the
TPU has no vector gather; on the GPU the kernel keeps the score table in
shared memory as int32, one copy per lane (no bank conflicts). One thread
walks one alignment's rows with its diagonals' H and F in registers (G = 2
or 4 lanes of 32 diagonals at bands above 32), E carried along the row, the
recurrences in Hopper's DPX instructions and the best cell as a packed key
H * 32 + (31 - k): bound by instruction issue, not bytes. The DP
(csrc/sw_common.cuh) is shared with B5 and B6 on another table. The routing
predicates stay the JAX package's: `fused_ok` (the engine's chunk sizing
and path choice) and `build_packed_matrix` returning None, which is how a
matrix outside the nibble range [-4, 11] (BLOSUM50, PAM30) is detected —
those take the score-fed kernels B5/B6 (kernels/sw_scored.py,
kernels/sw_wave.py). MAX_BAND also bounds B5 and B6; a CUDA engine refuses
wider bands.

Contract (equal to sw_xla.sw_banded(banded_scores_i8(...))): per alignment
(score, i_end, b_end) int32 — max score, then min i, then min b; (-1, -1)
when the score is <= 0. Masked cells: window positions outside
[rel_lo, rel_hi), LOW matrix entries, window codes >= code_limit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ghostm_tpu_torch.kernels import _build, sw_xla
from ghostm_tpu_torch.ops.scoring import LOW

UNROLL = 8
NIBBLE_BIAS = 4  # packed nibble = score + 4; BLOSUM62 scores are in [-4, 11]
MAX_BAND = 128   # csrc/sw_fused.cu: up to 4 lanes of 32 diagonals
# the kernel's best-cell key H * 32 + (31 - k) fits an int32 while
# H <= 127 Lq < 2^26
MAX_LQ = ((1 << 26) - 1) // 127

_P = ctypes.c_void_p
_I = ctypes.c_int


def fused_ok(Lq: int, band: int) -> bool:
    """True when the JAX fused kernel's packed best-tracking covers
    (Lq, band) — kept as the port's routing predicate so both engines take
    the same path for the same config."""
    if band % 2 or band < 16:
        return False
    h = band // 2
    A = Lq + h - 1
    at = -(-(A if A <= 256 else 128) // UNROLL) * UNROLL
    SH = int(-(-A // at) * at + 2 * h).bit_length()
    return 15 * Lq < (1 << (31 - SH))


def check_kernel_args(Lq: int, band: int, gap_open: int,
                      gap_extend: int) -> None:
    """Raise ValueError for what the CUDA kernel does not take: an odd band
    or one outside [16, MAX_BAND], a query longer than MAX_LQ, a negative
    gap cost (diagonals past a band that is not a multiple of 32 are held
    at a large negative value, which a negative cost could lift)."""
    if band % 2 or band < 16 or band > MAX_BAND:
        raise ValueError(f"CUDA fused SW needs an even band in [16, "
                         f"{MAX_BAND}], got {band}")
    if Lq > MAX_LQ:
        raise ValueError(f"CUDA fused SW takes queries up to {MAX_LQ} "
                         f"codes, got {Lq}")
    if gap_open < 0 or gap_extend < 0:
        raise ValueError(f"CUDA fused SW needs gap costs >= 0, got "
                         f"{gap_open}/{gap_extend}")


def check_code_inputs(qcodes, windows, rel_lo, rel_hi, band: int,
                      who: str) -> None:
    """Raise ValueError unless the code-fed SW kernels (B3, B5, B6) can
    take these inputs: contiguous (N, Lq) int8 codes, (N, >= Lq + band)
    int8 windows and (N,) int32 spans, all on one device."""
    N, Lq = qcodes.shape
    if windows.dim() != 2 or windows.shape[0] != N \
            or windows.shape[1] < Lq + band:
        raise ValueError(f"{who}: windows must be (N, >= Lq + band)")
    for x, dt in ((qcodes, torch.int8), (windows, torch.int8),
                  (rel_lo, torch.int32), (rel_hi, torch.int32)):
        if x.dtype != dt or not x.is_contiguous() or x.device != qcodes.device:
            raise ValueError(f"{who} inputs: want contiguous {dt} on "
                             f"{qcodes.device}, got {x.dtype} on {x.device}")
    if rel_lo.shape != (N,) or rel_hi.shape != (N,):
        raise ValueError(f"{who}: rel_lo/rel_hi must be (N,)")


def build_packed_matrix(matrix: np.ndarray) -> Tuple[Optional[tuple], int]:
    """(32, 32) int32 padded scoring table -> ((32, 4) nibble-word tuple,
    code_limit); the words are None when a value falls outside the nibble
    range. code_limit is the first LOW *column*: window codes >= it are
    masked. (Verbatim port of the JAX package's helper: the words are not
    used by the CUDA kernel, the None and code_limit are.)"""
    m = np.asarray(matrix, np.int64)
    assert m.shape == (32, 32)
    row_valid = ~(m <= LOW).all(axis=1)
    col_valid = ~(m <= LOW).all(axis=0)
    code_limit = int(np.nonzero(~col_valid)[0][0]) if (~col_valid).any() else 32
    assert col_valid[:code_limit].all(), "valid codes must be contiguous from 0"
    nib = np.where(m <= LOW, 0, m + NIBBLE_BIAS)
    nib = np.where(row_valid[:, None] & col_valid[None, :], nib, 0)
    if not ((nib >= 0) & (nib <= 15) | ~row_valid[:, None]).all():
        return None, code_limit
    words = np.zeros((32, 4), np.int64)
    for k in range(4):
        for s in range(8):
            words[:, k] |= nib[:, k * 8 + s] << (4 * s)
    words[~row_valid] = 0
    assert (words[row_valid, 0] != 0).all(), (
        "a valid matrix row packed word0 == 0 — row-validity marker broken"
    )
    w32 = ((words + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int64)
    return tuple(tuple(int(v) for v in row) for row in w32), code_limit


def score_table(matrix: torch.Tensor, code_limit: int) -> torch.Tensor:
    """(32, 32) int8 kernel table: the matrix value, or MASKED_I8 where the
    entry is LOW (banded_scores_i8's `sc > -100`) or the column is
    >= code_limit."""
    m = matrix.to(torch.int32)
    col = torch.arange(32, device=m.device)[None, :]
    keep = (m > -100) & (col < code_limit)
    return torch.where(keep, m.clamp(-100, 127),
                       torch.full_like(m, sw_xla.MASKED_I8)).to(torch.int8)


def sw_fused_plain(qcodes, windows, matrix, rel_lo, rel_hi, gap_open: int,
                   gap_extend: int, band: int, code_limit: int = 23):
    """sw_banded(banded_scores_i8(...)) with the window-local span, plus
    the kernel's code_limit column mask."""
    sc = sw_xla.banded_scores_i8(qcodes, windows, matrix, band,
                                 torch.zeros_like(rel_lo), rel_lo, rel_hi)
    t = sw_xla.skewed_windows(windows, qcodes.shape[1], band)
    sc = torch.where(t >= code_limit, torch.full_like(sc, sw_xla.MASKED_I8),
                     sc)
    return sw_xla.sw_banded(sc, gap_open, gap_extend)


def sw_fused(qcodes: torch.Tensor, windows: torch.Tensor,
             matrix: torch.Tensor, rel_lo: torch.Tensor, rel_hi: torch.Tensor,
             gap_open: int, gap_extend: int, band: int, code_limit: int = 23,
             table: Optional[torch.Tensor] = None):
    """Batched banded SW, scores looked up in-kernel.

    qcodes (N, Lq) int8 query codes; windows (N, >= Lq + band) int8 window
    codes; matrix (32, 32) int32 padded scoring table; rel_lo/rel_hi (N,)
    int32 subject span in window coordinates; table: score_table(matrix,
    code_limit) on the device, built once by a caller that launches many
    times (else built here, a few small launches each call). Returns
    (score, i_end, b_end), each (N,) int32."""
    if qcodes.device.type == "cpu":
        return sw_fused_plain(qcodes, windows, matrix, rel_lo, rel_hi,
                              gap_open, gap_extend, band, code_limit)
    N, Lq = qcodes.shape
    check_kernel_args(Lq, band, gap_open, gap_extend)
    check_code_inputs(qcodes, windows, rel_lo, rel_hi, band, "sw_fused")
    if table is None:
        table = score_table(matrix.to(qcodes.device), code_limit)
    if (table.dtype != torch.int8 or table.shape != (32, 32)
            or not table.is_contiguous() or table.device != qcodes.device):
        raise ValueError("sw_fused table: want a contiguous (32, 32) int8 "
                         f"tensor on {qcodes.device} from score_table")
    out = torch.empty((3, N), dtype=torch.int32, device=qcodes.device)
    if N == 0:
        return out[0], out[1], out[2]
    lib = _build.load("sw_fused")
    fn = lib.ghostm_sw_fused
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    _build.check(fn(
        qcodes.data_ptr(), windows.data_ptr(), rel_lo.data_ptr(),
        rel_hi.data_ptr(), table.data_ptr(), N, Lq, windows.shape[1], band,
        gap_open + gap_extend, gap_extend, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), _build.stream_ptr(qcodes.device),
    ), "sw_fused")
    _build.count("sw_fused", qcodes.shape)
    return out[0], out[1], out[2]
