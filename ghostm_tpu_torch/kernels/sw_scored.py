"""Kernel B5: banded Smith-Waterman by rows on a precomputed score tile
(csrc/sw_scored.cu), beside its plain PyTorch version.

Counterpart of the JAX package's kernels/sw_pallas.py (`sw_banded_pallas`,
the Pallas kernel `_sw_kernel`): the engine's score-fed align path for
matrices outside the fused kernel's nibble range (BLOSUM50, PAM) or bands
`fused_ok` refuses, at frames too short for the wavefront kernel B6.

Contract (equal to sw_xla.sw_banded on the same tile): sc (N, Lq, B) is an
int8 masked tile (sw_xla.banded_scores_i8, MASKED_I8 = masked cell) or an
int32 tile (values taken as they are, LOW cells included); per alignment
(score, i_end, b_end) int32 — max score, then min i, then min b; (-1, -1)
when the score is <= 0. Any N, any Lq, bands 1..128: the TPU kernel's
N % 128 and row-tile padding were tiling rules of the TPU, and padded rows
never change a result.
"""

from __future__ import annotations

import ctypes

import torch

from ghostm_tpu_torch.kernels import _build, sw_xla

MAX_BAND = 128   # csrc/sw_scored.cu: up to 4 diagonals per lane

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_tile(sc: torch.Tensor, who: str) -> None:
    """What the CUDA score-fed kernels take: a contiguous (N, Lq, B) int8
    or int32 tile with 1 <= B <= MAX_BAND."""
    if sc.dim() != 3 or sc.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"{who}: want an (N, Lq, B) int8 or int32 tile, got "
                         f"{tuple(sc.shape)} {sc.dtype}")
    if not 1 <= sc.shape[2] <= MAX_BAND:
        raise ValueError(f"{who}: CUDA band must be in [1, {MAX_BAND}], got "
                         f"{sc.shape[2]}")
    if not sc.is_contiguous():
        raise ValueError(f"{who}: the tile must be contiguous")


def launch(name: str, sc: torch.Tensor, gap_open: int, gap_extend: int):
    """Run csrc/<name>.cu's ghostm_<name>(sc, ...) -> (score, i_end,
    b_end), counting the launch."""
    N, Lq, B = sc.shape
    out = torch.empty((3, N), dtype=torch.int32, device=sc.device)
    if N == 0:
        return out[0], out[1], out[2]
    fn = getattr(_build.load(name), f"ghostm_{name}")
    fn.argtypes = [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    _build.check(fn(
        sc.data_ptr(), int(sc.dtype == torch.int8), N, Lq, B,
        gap_open + gap_extend, gap_extend, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), _build.stream_ptr(sc.device),
    ), name)
    _build.count(name, sc.shape)
    return out[0], out[1], out[2]


def sw_banded_scored_plain(sc: torch.Tensor, gap_open: int, gap_extend: int):
    """The plain version: sw_xla.sw_banded on the same tile."""
    return sw_xla.sw_banded(sc, gap_open, gap_extend)


def sw_banded_scored(sc: torch.Tensor, gap_open: int, gap_extend: int):
    """Batched banded SW on a score tile (see the module docstring). A CPU
    tile runs the plain version; a CUDA tile launches kernel B5."""
    if sc.device.type == "cpu":
        return sw_banded_scored_plain(sc, gap_open, gap_extend)
    check_tile(sc, "sw_banded_scored")
    return launch("sw_scored", sc, gap_open, gap_extend)
