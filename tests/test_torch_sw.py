"""Port kernel B3's plain PyTorch version (the path a CPU tensor takes) and
the plain refine DP/traceback against the JAX package: the fused Pallas
kernel in interpret mode and the XLA reference path. Tolerance 0: every
value is an int32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ghostm_tpu.kernels import sw_fused as jfused
from ghostm_tpu.kernels import sw_xla as jxla
from ghostm_tpu.ops.scoring import padded_matrix
from ghostm_tpu_torch.kernels import sw_fused as tfused
from ghostm_tpu_torch.kernels import sw_xla as txla

# One intra-op thread: the suite runs several pytest workers at once and
# torch's spinning OpenMP threads would oversubscribe the cores.
torch.set_num_threads(1)

MAT = padded_matrix(hard_stop=True)
GO, GE = 11, 1


def _case(seed, n, lq, band, kind="rand"):
    """Random codes, spans inside the window (the earlier cases), or a kind
    that stresses the kernel: "repeat" (one code in query and window: equal
    maxima everywhere), "periodic" (query and window of one period-6
    pattern: ties across diagonals), "copied" (the query copied into the
    window twice), "span" (rel_lo < 0, rel_hi past Lq + band)."""
    rng = np.random.default_rng(seed)
    # codes include stop(23)/sentinel(24)/pad(25) to exercise masking
    qs = rng.integers(0, 26, (n, lq)).astype(np.int8)
    ws = rng.integers(0, 26, (n, lq + band)).astype(np.int8)
    lo = rng.integers(0, 8, n).astype(np.int32)
    hi = rng.integers(lq // 2, lq + band, n).astype(np.int32)
    if kind == "repeat":
        qs[:] = 18                       # W: 11 against itself
        ws[:] = 18
        lo[::2], hi[::2] = 0, lq + band  # every cell live in half the rows
    elif kind == "periodic":
        pat = rng.integers(0, 20, (n, 6)).astype(np.int8)
        qs[:] = np.tile(pat, -(-lq // 6))[:, :lq]
        ws[:] = np.tile(pat, -(-(lq + band + 3) // 6))[:, 3:3 + lq + band]
    elif kind == "copied":
        for r in range(n):
            d = int(rng.integers(0, band // 2))
            ws[r, d:d + lq] = qs[r]
            ws[r, d + band // 2:d + band // 2 + lq] = qs[r]
    elif kind == "span":
        lo = rng.integers(-4, 8, n).astype(np.int32)
        hi = rng.integers(lq // 2, lq + band + 5, n).astype(np.int32)
    return qs, ws, lo, hi


def _port(qs, ws, lo, hi, band, climit):
    t = lambda a: torch.from_numpy(a)
    return tfused.sw_fused(t(qs), t(ws), t(MAT.astype(np.int32)), t(lo),
                           t(hi), GO, GE, band, code_limit=climit)


@pytest.mark.parametrize("seed,n,lq,band,kind", [
    # the earlier cases, their ids unchanged
    *(pytest.param(*c, "rand", id="-".join(map(str, c)))
      for c in ((0, 128, 40, 32), (3, 128, 40, 16), (5, 128, 24, 64))),
    (7, 128, 40, 32, "repeat"), (8, 128, 40, 32, "periodic"),
    (9, 128, 40, 32, "copied"), (10, 128, 40, 32, "span"),
    (11, 128, 24, 64, "periodic"), (12, 128, 40, 128, "rand"),
    (13, 128, 40, 18, "rand"), (14, 128, 96, 32, "rand"),
])
def test_fused_plain_matches_jax(seed, n, lq, band, kind):
    qs, ws, lo, hi = _case(seed, n, lq, band, kind)
    words, climit = jfused.build_packed_matrix(MAT)
    got = _port(qs, ws, lo, hi, band, climit)
    j = lambda a: jnp.asarray(a.astype(np.int32))
    fused = jfused.sw_fused_wave(j(qs), j(ws), words, j(lo), j(hi), GO, GE,
                                 band, code_limit=climit, interpret=True)
    ref = jxla.sw_banded(jxla.banded_scores_i8(
        j(qs), j(ws), jnp.asarray(MAT), band, jnp.zeros(n, jnp.int32),
        j(lo), j(hi)), GO, GE)
    for g, f, r in zip(got, fused, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(f))
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[0].max()) > 0


def test_kernel_args_check():
    """The CUDA wrapper's input check (a pure predicate: no card needed)."""
    tfused.check_kernel_args(40, 32, 11, 1)
    tfused.check_kernel_args(tfused.MAX_LQ, 128, 0, 0)
    assert 127 * tfused.MAX_LQ * 32 + 31 < 1 << 31
    assert 127 * (tfused.MAX_LQ + 1) * 32 + 31 >= 1 << 31
    for lq, band, go, ge in ((40, 14, 11, 1), (40, 33, 11, 1),
                             (40, 130, 11, 1), (tfused.MAX_LQ + 1, 32, 11, 1),
                             (40, 32, -1, 1), (40, 32, 11, -1)):
        with pytest.raises(ValueError):
            tfused.check_kernel_args(lq, band, go, ge)


def test_fused_plain_empty_and_allmasked():
    n, lq, band = 128, 24, 32
    qs = np.full((n, lq), 25, np.int8)          # all pad
    ws = np.zeros((n, lq + band), np.int8)
    lo = np.zeros(n, np.int32)
    hi = np.full(n, lq + band, np.int32)
    s, i, b = _port(qs, ws, lo, hi, band, 23)
    assert int(s.max()) == 0
    assert int(i.max()) == -1 and int(b.max()) == -1
    # live codes but an empty span: every cell masked
    qs = np.random.default_rng(1).integers(0, 20, (n, lq)).astype(np.int8)
    s, i, b = _port(qs, ws, hi, hi, band, 23)
    assert int(s.max()) == 0 and int(i.min()) == -1 and int(b.min()) == -1


def test_build_packed_matrix_and_fused_ok_match_jax():
    for name in ("BLOSUM62", "BLOSUM50", "PAM30"):
        m = padded_matrix(name, hard_stop=True)
        assert tfused.build_packed_matrix(m) == jfused.build_packed_matrix(m)
    for lq in (24, 40, 96, 300, 1728, 3456):
        for band in (14, 16, 31, 32, 64):
            assert tfused.fused_ok(lq, band) == jfused.fused_ok(lq, band)


def test_banded_scores_match_jax(rng):
    n, lq, band = 16, 40, 32
    qs = rng.integers(0, 26, (n, lq)).astype(np.int32)
    ws = rng.integers(0, 26, (n, lq + band)).astype(np.int32)
    g0 = rng.integers(0, 50, n).astype(np.int32)
    lo = (g0 + rng.integers(0, 10, n)).astype(np.int32)
    hi = (lo + rng.integers(20, 80, n)).astype(np.int32)
    t = torch.from_numpy
    got = txla.banded_scores(t(qs), t(ws), t(MAT.astype(np.int32)), band)
    want = jxla.banded_scores(jnp.asarray(qs), jnp.asarray(ws),
                              jnp.asarray(MAT), band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got8 = txla.banded_scores_i8(t(qs), t(ws), t(MAT.astype(np.int32)), band,
                                 t(g0), t(lo), t(hi))
    want8 = jxla.banded_scores_i8(jnp.asarray(qs), jnp.asarray(ws),
                                  jnp.asarray(MAT), band, jnp.asarray(g0),
                                  jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))


@pytest.mark.parametrize("lq,band", [(24, 16), (40, 32)])
def test_moves_and_traceback_match_jax(rng, lq, band):
    """sw_banded_moves + traceback_stats_device, the refine step, on LOW-
    masked int32 scores of related and unrelated pairs."""
    n = 32
    qs = rng.integers(0, 20, (n, lq)).astype(np.int32)
    ws = rng.integers(0, 26, (n, lq + band)).astype(np.int32)
    for r in range(0, n, 2):   # related pairs: the query sits on a diagonal
        d = int(rng.integers(0, band))
        ws[r, d:d + lq] = qs[r]
    sc = np.array(jxla.banded_scores(jnp.asarray(qs), jnp.asarray(ws),
                                     jnp.asarray(MAT), band))
    sc[:, :, -2:] = -(1 << 20)   # LOW-masked cells, as the engine's refine
    t = torch.from_numpy
    got = txla.sw_banded_moves(t(sc), GO, GE)
    want = jxla.sw_banded_moves(jnp.asarray(sc), GO, GE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gs = txla.sw_banded(t(sc), GO, GE)
    for g, w in zip(gs, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    st = txla.traceback_stats_device(got[3], got[1], got[2], t(qs), t(ws))
    ws_ = jxla.traceback_stats_device(want[3], want[1], want[2],
                                      jnp.asarray(qs), jnp.asarray(ws))
    assert st.keys() == ws_.keys()
    for k in st:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(ws_[k]),
                                      err_msg=k)
