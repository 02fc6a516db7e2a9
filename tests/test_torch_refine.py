"""Stage R1, refine: the port's plain version (kernels/refine.py, the path
a CPU tensor takes) against the JAX package's refine_stats_packed (XLA on
the CPU), and the engine's entry against the wrapper. Tolerance 0: every
output is an int32.

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against this plain version (-k refine there). Here: its layout rule, and
a numpy transcription of its arithmetic (tests/refine_transcript.py: the
lane-split row step in each layout, the staged walk's blocks) against the
plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ghostm_tpu import engine as jeng
from ghostm_tpu.ops.scoring import padded_matrix
from ghostm_tpu_torch import engine as teng
from ghostm_tpu_torch.kernels import refine
from ghostm_tpu_torch.ops.scoring import LOW

from refine_cases import CONFIGS, make_case
from refine_transcript import (byte_plane, lane_split_moves, staged_walk,
                               window_codes)

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)

SHAPES = [(40, 32), (88, 32), (24, 16), (60, 64), (50, 128), (300, 64)]


def _jax(q3, packed, mat, w, lo, hi, band, go, ge):
    out = jeng.refine_stats_packed(
        jnp.asarray(q3), jnp.asarray(packed), jnp.asarray(mat),
        jnp.asarray(w.astype(np.int32)), jnp.asarray(lo), jnp.asarray(hi),
        band=band, gap_open=go, gap_extend=ge)
    return np.asarray(out)


def _plain(q3, packed, mat, w, lo, hi, band, go, ge):
    t = torch.from_numpy
    return refine.refine_stats_plain(
        t(q3), t(packed), t(mat), t(w), t(lo), t(hi), band=band,
        gap_open=go, gap_extend=ge).numpy()


CASES = [
    *((lq, band, "b62") for lq, band in SHAPES),
    *((lq, band, c) for c in ("b50", "pam30", "open0", "ext0")
      for lq, band in ((40, 32), (60, 64))),
]


@pytest.mark.parametrize("lq,band,cfg", CASES)
def test_refine_plain_matches_jax(lq, band, cfg):
    """Every hit kind of refine_cases.make_case (related, gapped, unrelated,
    cut and empty spans, ties, g0 + i + b wrapping) at each listed shape
    and matrix / gap cost: exactly the JAX package's stats."""
    name, go, ge = CONFIGS[cfg]
    mat = padded_matrix(name, hard_stop=True).astype(np.int32)
    R, K = (2, 8) if lq < 200 else (1, 8)
    case = make_case(lq * 1000 + band, R, K, lq, band)
    got = _plain(*case[:2], mat, *case[2:], band, go, ge)
    want = _jax(*case[:2], mat, *case[2:], band, go, ge)
    assert got.shape == (9, R, K) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the cases reach what they are meant to: hits with gaps, dead hits
    score, gapopen, qstart = got[8].reshape(-1), got[7].reshape(-1), \
        got[0].reshape(-1)
    assert (score > 0).any() and (gapopen > 0).any()
    assert ((score == 0) & (qstart == -1)).any()


def test_refine_plain_takes_int32_windows():
    """The plain version widens int8 windows itself: int8 and int32
    windows give the same stats."""
    q3, packed, w, lo, hi = make_case(5, 2, 8, 40, 32)
    mat = padded_matrix("BLOSUM62").astype(np.int32)
    a = _plain(q3, packed, mat, w, lo, hi, 32, 11, 1)
    b = _plain(q3, packed, mat, w.astype(np.int32), lo, hi, 32, 11, 1)
    np.testing.assert_array_equal(a, b)


def test_engine_refine_is_the_wrapper():
    """engine.refine_stats_packed (the entry tests, the grid and the
    engine call) equals refine.refine_stats on CPU tensors, with and
    without the engine's table."""
    t = torch.from_numpy
    q3, packed, w, lo, hi = (t(a) for a in make_case(7, 3, 5, 24, 16))
    mat = t(padded_matrix("BLOSUM62").astype(np.int32))
    kw = dict(band=16, gap_open=11, gap_extend=1)
    want = refine.refine_stats(q3, packed, mat, w, lo, hi, **kw)
    got = teng.refine_stats_packed(q3, packed, mat, w, lo, hi, **kw)
    tab = refine.score_table(mat)
    again = teng.refine_stats_packed(q3, packed, mat, w, lo, hi, table=tab,
                                     table_max=int(tab.max()), **kw)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert teng.SearchEngine.STAT_KEYS == refine.STAT_KEYS


def test_score_table():
    """The kernel's table: the matrix as it is, LOW entries included, and
    a 33rd column of LOW (the cell outside the subject span)."""
    m = padded_matrix("BLOSUM62", hard_stop=True).astype(np.int32)
    tab = refine.score_table(torch.from_numpy(m))
    assert tab.shape == (32, 33) and tab.dtype == torch.int32
    assert tab.is_contiguous()
    np.testing.assert_array_equal(tab[:, :32].numpy(), m)
    assert (tab[:, 32] == LOW).all()


def test_query_codes():
    """Each hit's frame of its read, frames clamped to [0, 5]."""
    q3, packed, *_ = make_case(3, 3, 4, 24, 16)
    got = refine.query_codes(torch.from_numpy(q3),
                             torch.from_numpy(packed)).numpy()
    fr = np.clip(packed[2].reshape(-1), 0, 5)
    want = q3[np.repeat(np.arange(3), 4), fr]
    np.testing.assert_array_equal(got, want)


def _args(R=2, K=3, Lq=24, band=16):
    t = torch.from_numpy
    q3, packed, w, lo, hi = (t(a) for a in make_case(1, R, K, Lq, band))
    tab = refine.score_table(t(padded_matrix("BLOSUM62").astype(np.int32)))
    return q3, packed, w, lo, hi, tab


@pytest.mark.parametrize("change,match", [
    (dict(band=0), "band must be in"),
    (dict(band=130), "band must be in"),
    (dict(gap_open=-1), "gap costs >= 0"),
    (dict(gap_extend=-1), "gap costs >= 0"),
    (dict(table_max=1 << 25), "takes queries up to"),
    (dict(w=lambda a: a[:, :-1]), "windows must be"),
    (dict(w=lambda a: a.to(torch.int32)), "want contiguous"),
    (dict(w=lambda a: a.t().contiguous().t()), "want contiguous"),
    (dict(lo=lambda a: a[:-1]), "lo/hi must be"),
    (dict(hi=lambda a: a.to(torch.int64)), "want contiguous"),
    (dict(packed=lambda a: a[:8]), "hits"),
    (dict(q3=lambda a: a.to(torch.int32)), "want contiguous"),
    (dict(table=lambda a: a[:, :32]), "table must be"),
])
def test_kernel_args_check(change, match):
    """What the CUDA kernel refuses is refused before any launch (the
    checks run on any device, so they are tested here)."""
    q3, packed, w, lo, hi, tab = _args()
    a = dict(q3=q3, packed=packed, w=w, lo=lo, hi=hi, table=tab, band=16,
             gap_open=11, gap_extend=1, table_max=11)
    for k, v in change.items():
        a[k] = v(a[k]) if callable(v) else v
    with pytest.raises(ValueError, match=match):
        refine.check_args(a["q3"], a["packed"], a["w"], a["lo"], a["hi"],
                          a["band"], a["gap_open"], a["gap_extend"],
                          a["table"], a["table_max"])


def test_kernel_args_check_passes():
    """The engine's inputs pass, at every band the kernel takes."""
    for band in (1, 16, 32, 48, 64, 128):
        q3, packed, w, lo, hi, tab = _args(band=band)
        refine.check_args(q3, packed, w, lo, hi, band, 11, 1, tab, 11)


@pytest.mark.parametrize("lq,band,cfg", CASES)
def test_refine_transcript_matches_plain(lq, band, cfg):
    """The kernel's arithmetic, transcribed: the lane-split row step in
    every layout the kernel takes at the shape (the thread layout's 1-4
    lanes of 32 diagonals, the warp layout's 32 lanes of 1-4; the edge
    rules: f_open at b = B - 1, e_open at b = 0, NEG from above at the
    band's last diagonal, lanes past the band) gives moves_plain's score,
    i_end, b_end and move plane; the staged walk over the byte plane, in
    the kernel's blocks and in blocks of 4 rows, gives
    refine_stats_plain's stats. Exact."""
    name, go, ge = CONFIGS[cfg]
    mat = padded_matrix(name, hard_stop=True).astype(np.int32)
    R, K = (2, 8) if lq < 200 else (1, 8)
    q3, packed, w, lo, hi = make_case(lq * 1000 + band, R, K, lq, band)
    t = torch.from_numpy
    args = (t(q3), t(packed), t(mat), t(w), t(lo), t(hi))
    kw = dict(band=band, gap_open=go, gap_extend=ge)
    want = [x.numpy() for x in refine.moves_plain(*args, **kw)]
    stats = refine.refine_stats_plain(*args, **kw).numpy().reshape(9, -1)
    qc = refine.query_codes(t(q3), t(packed)).numpy()
    table = refine.score_table(t(mat)).numpy().astype(np.int64)
    g0 = packed[6].reshape(-1)
    opts = refine.layouts(lq, band)
    assert [a for a, _ in opts] == [refine.group_lanes(band), 32]
    for lanes, diags in opts:
        codes = window_codes(w, g0, lo, hi, lq + lanes * diags)
        got = lane_split_moves(qc.astype(np.int64), codes, table, band, go,
                               ge, lanes, diags)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x, err_msg=f"{lanes} lanes")
    np.testing.assert_array_equal(got[0], stats[8])
    plane = byte_plane(got[3])
    for rows in (None, 4):   # the kernel's block rows, and 4
        walked = staged_walk(plane, got[1], got[2], qc, w, lq, band, rows)
        np.testing.assert_array_equal(walked, stats[:8], err_msg=str(rows))


@pytest.mark.parametrize("N,lq,band,want", [
    (81_920, 40, 32, (1, 32)),      # scale, scale_b50
    (81_920, 88, 32, (1, 32)),      # scale_b50_250bp
    (40_960, 40, 32, (1, 32)),      # a rank of mesh_scale_2x1
    (8_448, 40, 32, (1, 32)),       # 64 hits an SM: the thread layout
    (8_447, 40, 32, (32, 1)),
    (17_952, 400, 32, (1, 32)),     # 136 an SM at Lq 400
    (17_951, 400, 32, (32, 1)),
    (1_280, 1728, 64, (32, 2)),     # longread_5kbp
    (640, 3456, 128, (32, 4)),      # 10 kbp
    (81_920, 40, 128, (4, 32)),
    (1_280, 40, 32, (32, 1)),       # the config-1 golden's batch
    (120, 1728, 64, (32, 2)),       # the long-read golden's
    (1, 40, 1, (32, 1)),
    (1, 40, 128, (32, 4)),
    (1, 65_536, 128, (32, 4)),
    (1, 80_000, 64, (2, 32)),       # past the warp layout's longest query
])
def test_layout_rule(N, lq, band, want):
    """refine.layout on a 132-SM card: the thread layout once the hits an
    SM reach 56 + Lq / 5 (the main path's short frames), the warp layout
    below (long frames, few hits), the thread layout past the warp
    layout's longest query."""
    assert refine.layout(N, lq, band, 132) == want


def test_layouts_cover_the_band():
    """Every layout the kernel takes, at every band, covers the band with
    lanes of a power of two up to 32, and the rule picks one of them."""
    for band in range(1, refine.MAX_BAND + 1):
        for lq in (1, 40, 1728, 3456):
            opts = refine.layouts(lq, band)
            assert len(opts) == 2
            for lanes, diags in opts:
                assert lanes * diags >= band and lanes * diags < 2 * band + 32
                assert lanes in (1, 2, 4, 32) and diags in (1, 2, 4, 32)
            for N in (1, 1_000, 100_000):
                assert refine.layout(N, lq, band, 132) in opts
    assert refine.layouts(refine.WARP_MAX_LQ, 128)[1] == (32, 4)
    assert refine.layouts(refine.WARP_MAX_LQ + 1, 1) == [(1, 32)]


def test_launch_refuses_a_layout():
    """A lane count no layout has is refused before any launch."""
    q3, packed, w, lo, hi, tab = _args()
    for lanes in (2, 8, 16, 64):
        with pytest.raises(ValueError, match="no layout"):
            refine.launch(q3, packed, w, lo, hi, tab, band=16, gap_open=11,
                          gap_extend=1, table_max=11, walk=True, lanes=lanes)
