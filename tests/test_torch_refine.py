"""Stage R1, refine: the port's plain version (kernels/refine.py, the path
a CPU tensor takes) against the JAX package's refine_stats_packed (XLA on
the CPU), and the engine's entry against the wrapper. Tolerance 0: every
output is an int32.

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against this plain version (-k refine there)."""

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


@pytest.mark.parametrize("lq,band,cfg", [
    *((lq, band, "b62") for lq, band in SHAPES),
    *((lq, band, c) for c in ("b50", "pam30", "open0", "ext0")
      for lq, band in ((40, 32), (60, 64))),
])
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
