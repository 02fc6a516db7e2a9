"""Kernel B6: the score-fed route's banded Smith-Waterman at frames of 64
residues and more, from the codes and an int32 score table (the
ghostm_sw_wave entry of csrc/sw_scored.cu), beside its plain PyTorch
version, an anti-diagonal wavefront on the score tile.

Counterpart of the JAX package's kernels/sw_wave.py (`sw_banded_wave`, the
Pallas kernel `_wave_kernel`), the route `engine.score_fed_route` names
"wave". Same inputs, function and contract as B5 (kernels/sw_scored.py);
the input checks are the JAX entry's: an even band >= 16, and Lq within
its packed best-cell bound. The TPU needed the wavefront because a row
tile could not carry the in-row E dependency without a prefix scan; on the
card one thread walks an alignment's rows with E in a register, so B6's
entry runs B5's DP (csrc/sw_common.cuh) and keeps its own C entry and
launch count.

The plain version's wavefront: the band's diagonals pair up as (2m, 2m + 1);
at step a both sit at row a - m. A step advances the evens from the odds'
carried state, then the odds from the new evens, so each Gotoh dependency
is the same pair or a neighbouring one and no in-row prefix scan is
needed. The TPU kernel fed it pre-skewed slabs (`skew_tiles`); the plain
version indexes the unskewed tile, reading the mask value outside rows
[0, Lq).
"""

from __future__ import annotations

from typing import Optional

import torch

from ghostm_tpu_torch.kernels import sw_scored, sw_xla
from ghostm_tpu_torch.kernels.sw_xla import NEG

UNROLL = 4   # the JAX kernel's step unroll: its a-tile, hence its bound


def pack_shift(Lq: int, band: int) -> int:
    """SH of the JAX kernel's packed (H << SH | inv-row) best cell, from its
    a-tile (A if A <= 256 else 128, rounded up to UNROLL) and padded A."""
    A = Lq + band // 2 - 1
    atile = A if A <= 256 else 128
    atile = -(-atile // UNROLL) * UNROLL
    return int(A + (-A % atile) + band).bit_length()


def check_wave(Lq: int, band: int) -> None:
    """The JAX entry's input checks (sw_wave.py:175-199), as ValueError."""
    if band % 2 or band < 16:
        raise ValueError("wavefront kernel needs an even band >= 16")
    SH = pack_shift(Lq, band)
    if 15 * Lq >= (1 << (31 - SH)):
        raise ValueError(f"Lq={Lq} too long for packed best-tracking "
                         f"(SH={SH}); use sw_scored_codes")


def sw_banded_wave_plain(sc: torch.Tensor, gap_open: int, gap_extend: int):
    """The wavefront recurrence over (N, B / 2) pairs, step by step: each
    diagonal's best cell is the first row reaching its maximum; then
    sw_xla._finalize."""
    s = sw_xla.widen_scores(sc)
    N, Lq, B = s.shape
    h = B // 2
    go1, ge = gap_open + gap_extend, gap_extend
    dev = s.device
    m = torch.arange(h, device=dev)
    even, odd = 2 * m, 2 * m + 1
    z = torch.zeros((N, h), dtype=torch.int32, device=dev)
    negv = torch.full_like(z, NEG)
    neg1 = negv[:, :1]
    He, Ho, Eo, Fo = z, z, negv, negv
    bHe, bIe, bHo, bIo = z, z, z, z
    for a in range(Lq + h - 1):
        row = a - m
        ok = (row >= 0) & (row < Lq)
        rc = row.clamp(0, max(Lq - 1, 0))
        se = torch.where(ok, s[:, rc, even], negv) if Lq else negv
        so = torch.where(ok, s[:, rc, odd], negv) if Lq else negv
        row32 = row.to(torch.int32).expand(N, h)
        # even half-step (diagonals 2m at row a - m)
        t = torch.maximum(Ho - go1, Eo - ge)
        Ee = torch.cat([neg1, t[:, :-1]], dim=1)
        Fe = torch.maximum(Ho - go1, Fo - ge)
        He = torch.maximum(torch.clamp_min(He + se, 0),
                           torch.maximum(Ee, Fe))
        better = ok & (He > bHe)
        bHe = torch.where(better, He, bHe)
        bIe = torch.where(better, row32, bIe)
        # odd half-step (diagonals 2m + 1 at row a - m, from the new evens)
        u = torch.maximum(He - go1, Fe - ge)
        Eo = torch.maximum(He - go1, Ee - ge)
        Fo = torch.cat([u[:, 1:], neg1], dim=1)
        Ho = torch.maximum(torch.clamp_min(Ho + so, 0),
                           torch.maximum(Eo, Fo))
        better = ok & (Ho > bHo)
        bHo = torch.where(better, Ho, bHo)
        bIo = torch.where(better, row32, bIo)
    bH = torch.stack([bHe, bHo], dim=2).reshape(N, B)
    bI = torch.stack([bIe, bIo], dim=2).reshape(N, B)
    return sw_xla._finalize(bH, bI, B)


def sw_wave_codes_plain(qcodes, windows, table, rel_lo, rel_hi,
                        gap_open: int, gap_extend: int, band: int):
    """The plain version: the route's tile (sw_scored.tile_from_table),
    then sw_banded_wave_plain."""
    sc = sw_scored.tile_from_table(qcodes, windows, table, rel_lo, rel_hi,
                                   band)
    return sw_banded_wave_plain(sc, gap_open, gap_extend)


def sw_wave_codes(qcodes: torch.Tensor, windows: torch.Tensor,
                  table: torch.Tensor, rel_lo: torch.Tensor,
                  rel_hi: torch.Tensor, gap_open: int, gap_extend: int,
                  band: int, table_max: Optional[int] = None):
    """Batched banded SW of the score-fed route at long frames: the inputs
    and result of sw_scored.sw_scored_codes, after the JAX entry's checks.
    CPU tensors run the plain version, CUDA tensors kernel B6."""
    check_wave(qcodes.shape[1], band)
    if qcodes.device.type == "cpu":
        return sw_wave_codes_plain(qcodes, windows, table, rel_lo, rel_hi,
                                   gap_open, gap_extend, band)
    return sw_scored.launch("sw_wave", qcodes, windows, table, rel_lo,
                            rel_hi, gap_open, gap_extend, band, table_max)
