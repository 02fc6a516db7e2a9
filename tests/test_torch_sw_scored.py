"""Port kernels B5 (kernels/sw_scored.py) and B6 (kernels/sw_wave.py): their
plain PyTorch versions (the path a CPU tile takes) against the JAX package's
Pallas kernels in interpret mode and its XLA reference, the wavefront's
input checks, and the engine's score-fed route predicate. Tolerance 0:
every value is an int32."""

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
    got = sw_scored.sw_banded_scored(torch.from_numpy(sc), GO, GE)
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
    _eq(sw_scored.sw_banded_scored_plain(torch.from_numpy(sc), GO, GE), ref)


@pytest.mark.parametrize("seed,lq,band,dtype", [
    (5, 64, 32, "int8"), (6, 72, 24, "int32"), (7, 96, 16, "int32"),
])
def test_wave_plain_matches_jax(seed, lq, band, dtype):
    sc = _tile(seed, 128, lq, band, dtype)
    got = sw_wave.sw_banded_wave(torch.from_numpy(sc), GO, GE)
    assert int(got[0].max()) > 0, "no alignment scored: vacuous"
    wave = jwave.sw_banded_wave(jnp.asarray(sc), GO, GE, interpret=True)
    ref = jxla.sw_banded(jnp.asarray(sc), GO, GE)
    _eq(got, wave, ref)
    _eq(sw_wave.sw_banded_wave_plain(torch.from_numpy(sc), GO, GE), ref)


@pytest.mark.parametrize("fn", ["scored", "wave"])
@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_allmasked_and_empty_tiles(fn, dtype):
    """A tile with every cell masked, and one with no rows, give
    (0, -1, -1) for every alignment."""
    f = (sw_scored.sw_banded_scored if fn == "scored"
         else sw_wave.sw_banded_wave)
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
    sc = torch.zeros((1, lq, band), dtype=torch.int32)
    if jax_raises:
        with pytest.raises(ValueError):
            sw_wave.sw_banded_wave(sc, GO, GE)
    else:
        sw_wave.check_wave(lq, band)
