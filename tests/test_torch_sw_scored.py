"""Port kernels B5 (kernels/sw_scored.py) and B6 (kernels/sw_wave.py): the
code table against the score tiles it replaces, the code-fed entries' plain
versions (the path CPU tensors take) and the tile-fed plain versions
against the JAX package's tile build, Pallas kernels in interpret mode and
XLA reference, the wavefront's input checks, the CUDA argument checks and
the engine's score-fed route predicate. Tolerance 0: every value is an
int32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ghostm_tpu.kernels import sw_pallas as jpallas
from ghostm_tpu.kernels import sw_wave as jwave
from ghostm_tpu.kernels import sw_xla as jxla
from ghostm_tpu.ops.scoring import padded_matrix
from ghostm_tpu_torch.engine import score_fed_route
from ghostm_tpu_torch.kernels import sw_scored, sw_wave
from ghostm_tpu_torch.kernels import sw_xla as txla

# One intra-op thread: the suite runs several pytest workers at once and
# torch's spinning OpenMP threads would oversubscribe the cores.
torch.set_num_threads(1)

B50 = padded_matrix("BLOSUM50", hard_stop=True)
GO, GE = 13, 2
LOW = -(1 << 20)
NEG = -(1 << 30)


def _tile(seed, n, lq, band, dtype):
    """(n, lq, band) BLOSUM50 score tile of related and unrelated pairs, as
    the engine builds it: int8 masked (banded_scores_i8, span-masked) or
    int32 with LOW outside the subject span."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 26, (n, lq)).astype(np.int32)
    ws = rng.integers(0, 26, (n, lq + band)).astype(np.int32)
    for r in range(0, n, 2):   # related pairs: the query on a diagonal
        d = int(rng.integers(0, band))
        ws[r, d:d + lq] = qs[r]
    g0 = np.zeros(n, np.int32)
    lo = rng.integers(0, 8, n).astype(np.int32)
    hi = rng.integers(lq // 2, lq + band, n).astype(np.int32)
    j = lambda a: jnp.asarray(a)
    if dtype == "int8":
        sc = jxla.banded_scores_i8(j(qs), j(ws), j(B50), band, j(g0), j(lo),
                                   j(hi))
        return np.array(sc)
    sc = np.array(jxla.banded_scores(j(qs), j(ws), j(B50), band))
    cell = np.arange(lq)[:, None] + np.arange(band)[None, :]
    inb = (cell[None] >= lo[:, None, None]) & (cell[None] < hi[:, None, None])
    return np.where(inb, sc, LOW).astype(np.int32)


def _eq(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,lq,band,dtype,row_tile", [
    (0, 40, 32, "int8", 40),      # BLOSUM50 at the default frame: int8 rows
    (1, 40, 24, "int32", 40),     # band % 32 != 0: int32 with LOW cells
    (2, 40, 8, "int32", 40),      # a band the fused kernel refuses
    (3, 60, 32, "int8", 24),      # Lq not a multiple of the row tile
    (4, 60, 24, "int32", 24),
])
def test_scored_plain_matches_jax(seed, lq, band, dtype, row_tile):
    sc = _tile(seed, 128, lq, band, dtype)
    got = sw_scored.sw_banded_scored_plain(torch.from_numpy(sc), GO, GE)
    assert int(got[0].max()) > 0, "no alignment scored: vacuous"
    # the JAX kernel takes Lq padded to its row tile, with the mask value
    # (engine.py:751-754); the port takes the unpadded tile
    pad = -lq % row_tile
    fill = jxla.MASKED_I8 if dtype == "int8" else NEG
    padded = np.pad(sc, ((0, 0), (0, pad), (0, 0)), constant_values=fill)
    pallas = jpallas.sw_banded_pallas(jnp.asarray(padded), GO, GE,
                                      row_tile=row_tile, interpret=True)
    ref = jxla.sw_banded(jnp.asarray(sc), GO, GE)
    _eq(got, pallas, ref)


@pytest.mark.parametrize("seed,lq,band,dtype", [
    (5, 64, 32, "int8"), (6, 72, 24, "int32"), (7, 96, 16, "int32"),
])
def test_wave_plain_matches_jax(seed, lq, band, dtype):
    sc = _tile(seed, 128, lq, band, dtype)
    got = sw_wave.sw_banded_wave_plain(torch.from_numpy(sc), GO, GE)
    assert int(got[0].max()) > 0, "no alignment scored: vacuous"
    wave = jwave.sw_banded_wave(jnp.asarray(sc), GO, GE, interpret=True)
    ref = jxla.sw_banded(jnp.asarray(sc), GO, GE)
    _eq(got, wave, ref)


@pytest.mark.parametrize("fn", ["scored", "wave"])
@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_allmasked_and_empty_tiles(fn, dtype):
    """A tile with every cell masked, and one with no rows, give
    (0, -1, -1) for every alignment."""
    f = (sw_scored.sw_banded_scored_plain if fn == "scored"
         else sw_wave.sw_banded_wave_plain)
    dt = torch.int8 if dtype == "int8" else torch.int32
    fill = -128 if dtype == "int8" else LOW
    for lq in (40, 0):
        sc = torch.full((128, lq, 32), fill, dtype=dt)
        s, i, b = f(sc, GO, GE)
        assert s.dtype == i.dtype == b.dtype == torch.int32
        assert s.tolist() == [0] * 128
        assert i.tolist() == [-1] * 128 and b.tolist() == [-1] * 128


@pytest.mark.parametrize("lq,band,route", [
    (40, 32, "rows"), (64, 32, "wave"), (88, 32, "wave"), (64, 8, "rows"),
    (1728, 64, "wave"), (63, 32, "rows"), (64, 18, "wave"),
    (20000, 32, "rows"),   # fails the packing bound: 15 * Lq >= 2^16
])
def test_score_fed_route(lq, band, route):
    """engine.py:709-714's use_wave, written out by hand."""
    assert score_fed_route(lq, band) == route


@pytest.mark.parametrize("lq,band", [
    (64, 24), (64, 14), (64, 8), (40, 18), (20000, 32), (4000, 64),
])
def test_wave_raises_where_jax_does(lq, band):
    """JAX's checks run while it traces: eval_shape finds them without
    running the kernel."""
    try:
        jax.eval_shape(
            lambda x: jwave.sw_banded_wave(x, GO, GE, interpret=True),
            jax.ShapeDtypeStruct((128, lq, band), jnp.int32))
        jax_raises = False
    except ValueError:
        jax_raises = True
    assert jax_raises == (band % 2 == 1 or band < 16 or lq >= 20000)
    q = torch.zeros((1, lq), dtype=torch.int8)
    w = torch.zeros((1, lq + band), dtype=torch.int8)
    span = torch.zeros(1, dtype=torch.int32)
    table = sw_scored.code_table(torch.from_numpy(B50), band)
    if jax_raises:
        with pytest.raises(ValueError):
            sw_wave.sw_wave_codes(q, w, table, span, span, GO, GE, band)
    else:
        sw_wave.check_wave(lq, band)


def _codes(seed, n, lq, band):
    """Codes of related and unrelated pairs with window-local spans: every
    code 0..31 occurs (hard-stop rows 23-25, columns >= code_limit), half
    the windows hold their query on a diagonal, spans start before the
    window and end past it, and a sixteenth are empty."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 32, (n, lq)).astype(np.int8)
    ws = rng.integers(0, 32, (n, lq + band + 5)).astype(np.int8)
    qs[::2] = rng.integers(0, 20, (len(qs[::2]), lq))
    for r in range(0, n, 2):
        d = int(rng.integers(0, band))
        ws[r, d:d + lq] = qs[r]
    lo = rng.integers(-4, 12, n).astype(np.int32)
    hi = rng.integers(lq // 2, lq + band + 8, n).astype(np.int32)
    hi[1::16] = lo[1::16]   # empty spans: every cell masked
    return qs, ws, lo, hi


def _jax_tile(qs, ws, lo, hi, mat, band):
    """The JAX engine's score tile (engine.py:737-745): int8 masked when
    band % 32 == 0, else int32 with LOW outside the span."""
    j = jnp.asarray
    g0 = jnp.zeros(len(lo), jnp.int32)
    if band % 32 == 0:
        return np.array(jxla.banded_scores_i8(j(qs), j(ws), j(mat), band, g0,
                                              j(lo), j(hi)))
    sc = np.array(jxla.banded_scores(j(qs), j(ws), j(mat), band))
    cell = np.arange(qs.shape[1])[:, None] + np.arange(band)[None, :]
    inb = (cell[None] >= lo[:, None, None]) & (cell[None] < hi[:, None, None])
    return np.where(inb, sc, LOW).astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("matrix,band", [
    ("BLOSUM50", 32), ("BLOSUM50", 24), ("PAM30", 32), ("BLOSUM45", 24),
    ("BLOSUM50", 9), ("PAM30", 128),
])
def test_code_table_equals_tile(matrix, band):
    """table[q, w if rel_lo <= i + b < rel_hi else 32], cell by cell, is
    the tile the engine fed B5/B6 (the port's sw_xla and the JAX
    package's): hard-stop rows and LOW columns included, masked cells as
    NEG in the int8 route and as LOW in the int32 route."""
    mat = padded_matrix(matrix, hard_stop=True)
    qs, ws, lo, hi = _codes(band, 64, 40, band)
    tq, tw, tlo, thi, tmat = _torch(qs, ws, lo, hi, mat)
    table = sw_scored.code_table(tmat, band)
    assert table.shape == (32, 33) and table.dtype == torch.int32
    pos = np.arange(40)[:, None] + np.arange(band)[None, :]
    inb = (pos >= lo[:, None, None]) & (pos < hi[:, None, None])
    look = table.numpy()[qs[:, :, None], np.where(inb, ws[:, pos], 32)]
    want = _jax_tile(qs, ws, lo, hi, mat, band)
    if band % 32 == 0:
        port = txla.banded_scores_i8(tq, tw, tmat, band, torch.zeros_like(tlo),
                                     tlo, thi)
        np.testing.assert_array_equal(
            look, np.where(want == -128, NEG, want.astype(np.int32)))
        assert (look == NEG).any() and not (look == LOW).any()
    else:
        port = txla.banded_scores(tq, tw, tmat, band)
        port = torch.where(txla.in_span(torch.zeros_like(tlo), tlo, thi, 40,
                                        band), port, torch.full_like(port, LOW))
        np.testing.assert_array_equal(look, want)
        assert (look == LOW).any() and not (look == NEG).any()
    assert (look > 0).any()
    np.testing.assert_array_equal(port.numpy(), want)
    tile = sw_scored.tile_from_table(tq, tw, table, tlo, thi, band)
    assert tile.dtype == port.dtype
    np.testing.assert_array_equal(tile.numpy(), want)


SW_CASES = [(40, 32), (40, 24), (40, 9), (72, 32), (88, 32), (64, 128)]


@pytest.mark.parametrize("lq,band", SW_CASES)
def test_scored_codes_plain_matches_jax(lq, band):
    """B5's code-fed entry on CPU tensors (its plain version) against the
    JAX package's tile build + sw_banded_pallas in interpret mode."""
    qs, ws, lo, hi = _codes(lq + band, 128, lq, band)
    tq, tw, tlo, thi = _torch(qs, ws, lo, hi)
    table = sw_scored.code_table(torch.from_numpy(B50), band)
    got = sw_scored.sw_scored_codes(tq, tw, table, tlo, thi, GO, GE, band)
    assert int(got[0].max()) > 0, "no alignment scored: vacuous"
    assert (got[1] == -1).any(), "every alignment scored: masks untested"
    sc = _jax_tile(qs, ws, lo, hi, B50, band)
    pallas = jpallas.sw_banded_pallas(jnp.asarray(sc), GO, GE, row_tile=lq,
                                      interpret=True)
    _eq(got, pallas)


@pytest.mark.parametrize("lq,band", [c for c in SW_CASES if c[1] % 2 == 0
                                     and c[1] >= 16])
def test_wave_codes_plain_matches_jax(lq, band):
    """B6's code-fed entry on CPU tensors (its plain version, the
    wavefront) against the JAX package's tile build + sw_banded_wave in
    interpret mode."""
    qs, ws, lo, hi = _codes(lq * band, 128, lq, band)
    tq, tw, tlo, thi = _torch(qs, ws, lo, hi)
    table = sw_scored.code_table(torch.from_numpy(B50), band)
    got = sw_wave.sw_wave_codes(tq, tw, table, tlo, thi, GO, GE, band)
    assert int(got[0].max()) > 0, "no alignment scored: vacuous"
    sc = _jax_tile(qs, ws, lo, hi, B50, band)
    wave = jwave.sw_banded_wave(jnp.asarray(sc), GO, GE, interpret=True)
    _eq(got, wave)


@pytest.mark.parametrize("lq,band,gaps,table_max,ok", [
    (40, 32, (13, 2), 15, True), (40, 1, (13, 2), 15, True),
    (40, 9, (13, 2), 15, True), (40, 128, (0, 0), 15, True),
    (40, 0, (13, 2), 15, False), (40, 129, (13, 2), 15, False),
    (40, 32, (-1, 2), 15, False), (40, 32, (13, -1), 15, False),
    (4473924, 32, (13, 2), 15, True), (4473925, 32, (13, 2), 15, False),
    # a table value past 127 (the int32 route takes any matrix value)
    (63, 24, (13, 2), 1 << 20, True), (64, 24, (13, 2), 1 << 20, False),
])
def test_code_args_check(lq, band, gaps, table_max, ok):
    """What the CUDA entries of B5 and B6 refuse before a launch: a band
    outside 1..128, a negative gap cost, and Lq past the best-cell key's
    range for the table's largest value (2^26 / table_max)."""
    if ok:
        sw_scored.check_code_args(lq, band, *gaps, table_max, "sw_scored")
    else:
        with pytest.raises(ValueError):
            sw_scored.check_code_args(lq, band, *gaps, table_max,
                                      "sw_scored")
