"""Port kernels B1/B2/B4 (plain PyTorch versions, the path a CPU tensor
takes) against the JAX package's Pallas kernels in interpret mode, and the
port's vote_and_rank against the JAX one. Tolerance 0: int32 throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from ghostm_tpu.kernels import candidates as jcand
from ghostm_tpu.kernels import sort as jsort
from ghostm_tpu_torch.kernels import candidates as tcand
from ghostm_tpu_torch.kernels import sort as tsort

# One intra-op thread: the suite runs several pytest workers at once and
# torch's spinning OpenMP threads would oversubscribe the cores.
torch.set_num_threads(1)

BIG = 1 << 30


def _presorted(keys, run):
    """Even runs ascending, odd runs descending (the bitonic stage-skip
    precondition the engine builds)."""
    q, m = keys.shape
    k3 = np.sort(keys.reshape(q, m // run, run), axis=2)
    k3[:, 1::2] = k3[:, 1::2, ::-1]
    return np.ascontiguousarray(k3.reshape(q, m))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _cases(old, new):
    """The earlier cases (random rows, their ids unchanged) and new ones
    whose last field names the kind of row (_fill)."""
    return ([pytest.param(*c, "rand", id="-".join(map(str, c))) for c in old]
            + [pytest.param(*c) for c in new])


def _fill(keys, kind, rng):
    """Rows that a register or merge-path design gets wrong: one value
    (one run over the whole row), only BIG, only PAD, fewer distinct keys
    than candidates (long runs across threads, warps and the a/b split),
    every key exactly twice (vote ties broken by key)."""
    q, m = keys.shape
    if kind == "equal":
        keys[:] = 12345
    elif kind == "big":
        keys[:] = BIG
    elif kind == "pad":
        keys[:] = tsort.PAD
    elif kind == "few":
        keys[:] = rng.integers(0, 5, (q, m))
        keys[rng.random((q, m)) < 0.2] = BIG
    elif kind == "ties":
        keys[:] = np.stack([rng.permutation(np.arange(m) // 2)
                            for _ in range(q)])
    return keys


@pytest.mark.parametrize("q,m,run,kind", _cases([
    (8, 128, 0), (16, 100, 0), (5, 7, 0), (128, 1, 0),
    (8, 256, 16), (8, 512, 512), (4, 640, 128),
], [
    (4, 300, 0, "equal"), (4, 256, 16, "big"), (3, 640, 128, "pad"),
    (3, 1000, 0, "rand"), (2, 2560, 128, "few"), (2, 16384, 128, "rand"),
]))
def test_sort_rows_matches_jax(rng, q, m, run, kind):
    x = rng.integers(-(1 << 30), 1 << 30, (q, m)).astype(np.int32)
    if run:
        x[rng.random((q, m)) < 0.3] = BIG
    x = _fill(x, kind, rng)
    if run:
        x = _presorted(x, run)
    got = tsort.sort_rows(torch.from_numpy(x), presorted_run=run)
    _eq(got, jsort.sort_rows(jnp.asarray(x), presorted_run=run,
                             interpret=True))


@pytest.mark.parametrize("m", [
    16_385, 2 * 16_384, 27_600, 55_248, 3_452 * 128, 32 * 16_384,
    32 * 16_384 + 1, 64 * 16_384, 64 * 16_384 + 1, 100 * 16_384 + 7,
    256 * 16_384, 256 * 16_384 + 1, 336 * 16_384, 336 * 16_384 + 1,
    512 * 16_384 + 1, 1_000 * 16_384,
])
def test_long_plan(m):
    """B1's launch plan past one block (kernel launches need a GPU; the plan
    is host arithmetic): up to KWAY_MAX tiles one k-way merge after the
    tiles (two trips through device memory); more tiles, pairwise passes
    until KWAY_MAX runs remain, then the k-way merge while its block fits
    in shared memory; longer rows pairwise to the end. The k-way's buckets
    cover the row's samples, and a bucket's (g + K) x S keys fit its
    shared memory."""
    T = tsort.TILE
    tiles = -(-m // T)
    passes, kway = tsort.long_plan(m)
    if tiles <= tsort.KWAY_MAX:
        assert (passes, kway) == (0, 1)
    if kway:
        width = T << passes
        K, g, nb, smem = tsort._kway_shape(m, width)
        assert 2 <= K <= tsort.KWAY_MAX
        if passes:   # one pass fewer would leave too many runs
            assert -(-m // (width >> 1)) > tsort.KWAY_MAX
        assert K == -(-tiles // (1 << passes))
        S = width // tsort.KWAY_SAMPLES
        ns = (K - 1) * tsort.KWAY_SAMPLES + -(-(m - (K - 1) * width) // S)
        assert (nb - 1) * g < ns <= nb * g
        cap = (g + K) * S
        assert smem == 8 * (cap + 1) <= tsort.KWAY_SMEM
    else:
        assert tiles > 336 and passes == (tiles - 1).bit_length()
        width = T << (-(-tiles // tsort.KWAY_MAX) - 1).bit_length()
        assert tsort._kway_shape(m, width)[3] > tsort.KWAY_SMEM


@pytest.mark.parametrize("q,m,run,minv,kind", _cases([
    (8, 640, 128, 2), (8, 96, 1, 1), (4, 608, 16, 1),
], [
    (4, 608, 16, 1, "equal"), (4, 608, 16, 1, "big"), (4, 640, 128, 1, "pad"),
    (4, 608, 16, 1, "few"), (4, 608, 16, 1, "ties"),
    (4, 608, 16, 1000, "rand"),
    (3, 4096, 128, 1, "rand"),   # 36-residue frames: 32 runs of 128
]))
def test_sort_vote_rank_rows_matches_jax(rng, q, m, run, minv, kind):
    """(4, 608, run 16) is the golden config-1 shape (L = 1024); (3, 4096,
    run 128) a power-of-two run count, which takes the monolithic entry
    (36-residue frames at hits_per_seed 128)."""
    keys = rng.integers(0, 40 * 128, (q, m)).astype(np.int32)
    keys[rng.random((q, m)) < 0.4] = BIG
    keys = _fill(keys, kind, rng)
    if run > 1:
        keys = _presorted(keys, run)
    gk, gv = tsort.sort_vote_rank_rows(torch.from_numpy(keys), 8, minv,
                                       presorted_run=run)
    wk, wv = jsort.sort_vote_rank_rows(jnp.asarray(keys), 8, minv,
                                       presorted_run=run, interpret=True)
    _eq(gk, wk)
    _eq(gv, wv)


@pytest.mark.parametrize("q,nruns,run,minv,kind", _cases([
    (4, 36, 128, 1), (6, 6, 256, 2), (4, 5, 1024, 1),
], [
    (3, 129, 1, 1, "rand"),          # Mb = 1
    (3, 2, 128, 1, "halves"),        # Mb = La
    (3, 36, 128, 1, "equal"), (3, 36, 128, 1, "big_a"),
    (3, 36, 128, 1, "pad"), (3, 36, 128, 1, "few"),
    (3, 36, 128, 1, "ties"), (3, 36, 128, 1, "invalid_b"),
    (3, 36, 128, 1000, "rand"),      # min_votes above every run
]))
def test_merge_vote_rank_rows_matches_jax(rng, q, nruns, run, minv, kind):
    """(36 runs of 128) is config-2's split: (Q, 4096) + (Q, 512)."""
    m = nruns * run
    keys = rng.integers(0, 1 << 24, (q, m)).astype(np.int32)
    keys[rng.random((q, m)) < 0.4] = BIG
    keys[rng.random((q, m)) < 0.3] = 12345   # votes stack across runs
    keys = _presorted(_fill(keys, kind, rng), run)
    m1 = m // 2 if kind == "halves" else run << (nruns.bit_length() - 1)
    a = np.sort(keys[:, :m1], axis=1)
    b = np.sort(keys[:, m1:], axis=1)
    if kind == "big_a":
        a[:] = BIG
    elif kind == "invalid_b":
        b[:] = BIG
    gk, gv = tsort.merge_vote_rank_rows(torch.from_numpy(a),
                                        torch.from_numpy(b), 8, minv)
    wk, wv = jsort.merge_vote_rank_rows(jnp.asarray(a), jnp.asarray(b), 8,
                                        minv, interpret=True)
    _eq(gk, wk)
    _eq(gv, wv)


_I32 = np.iinfo(np.int32)


def _lex_keys(rng, kind, nk, q, m):
    """Key operands: "rand" (the last key a permutation: few full ties),
    "ties" (values 0..2: full-key ties with differing payloads — both
    sides are stable, so the payload association must match exactly),
    "sentinel" (INT32_MIN, INT32_MAX = PAD and values beside them, ties
    across all of them)."""
    if kind == "ties":
        return [rng.integers(0, 3, (q, m)) for _ in range(nk)]
    if kind == "sentinel":
        vals = np.array([_I32.min, _I32.max, tsort.PAD, -1, 0, 1], np.int64)
        return [rng.choice(vals, (q, m)) for _ in range(nk)]
    return ([rng.integers(0, 6, (q, m)) for _ in range(nk - 1)]
            + [np.stack([rng.permutation(m) for _ in range(q)])])


@pytest.mark.parametrize("q,m,nk,nops,topk,kind", [
    # the earlier cases, their ids unchanged (ties True -> "ties")
    *(pytest.param(*c[:5], "ties" if c[5] else "rand",
                   id="-".join(map(str, c)))
      for c in ((16, 48, 5, 9, 10, False), (8, 16, 3, 3, 8, False),
                (8, 100, 2, 4, 100, False), (8, 64, 3, 7, 64, True))),
    (4, 48, 5, 9, 10, "sentinel"),
    (4, 16, 3, 3, 8, "ties"),         # num_keys == nops: no payload
    (4, 40, 1, 3, 10, "ties"),        # num_keys == 1
    (4, 1, 3, 4, 10, "rand"), (4, 2, 2, 4, 10, "ties"),   # M 1 and 2
    # rows past a warp's 64 columns, and past the old 48 KB cap (held
    # against lax.sort alone, the reference's non-kernel path)
    (4, 65, 5, 9, 10, "sentinel"), (3, 1026, 5, 9, 10, "ties"),
])
def test_lex_rank_rows_matches_jax(rng, q, m, nk, nops, topk, kind):
    ops = _lex_keys(rng, kind, nk, q, m)
    ops += [rng.integers(-50, 1000, (q, m)) for _ in range(nops - nk)]
    ops = np.stack(ops).astype(np.int32)
    got = tsort.lex_rank_rows(torch.from_numpy(ops), nk, topk)
    assert got.shape == (nops, q, min(topk, m))
    if m <= 100:   # the Pallas kernel in interpret mode: ~10 s at M 65
        want = jsort.lex_rank_rows(tuple(jnp.asarray(o) for o in ops), nk,
                                   topk, interpret=True)
        for g, w in zip(got, want):
            _eq(g, w)
    ref = lax.sort(tuple(jnp.asarray(o) for o in ops), num_keys=nk)
    for g, w in zip(got, ref):
        _eq(g, np.asarray(w)[:, :topk])


@pytest.mark.parametrize("q,nruns,run,nbins", [
    (6, 36, 128, 1 << 12),   # split sort -> merge entry (config-2 shape)
    (8, 38, 16, 256),        # monolithic entry (golden shape, M = 608)
    (16, 96, 1, 64),         # no presorted runs
])
def test_vote_and_rank_matches_jax(rng, q, nruns, run, nbins):
    m = nruns * run
    S = 40
    keys = rng.integers(0, S * nbins // 4, (q, m)).astype(np.int32)
    keys[rng.random((q, m)) < 0.3] = BIG
    if run > 1:
        keys = _presorted(keys, run)
    sid = np.arange(S, dtype=np.int32)
    g, b, v = tcand.vote_and_rank(torch.from_numpy(keys),
                                  torch.from_numpy(sid), 8, 1, nbins=nbins,
                                  presorted_run=run)
    wg, wb, wv = jcand.vote_and_rank(jnp.asarray(keys), jnp.asarray(sid), 8,
                                     1, False, nbins)
    _eq(g, wg)
    _eq(b, wb)
    _eq(v, wv)


def test_select_global_identity_and_multishard_raises():
    g = torch.tensor([[3, 5]], dtype=torch.int32)
    b = torch.tensor([[1, 2]], dtype=torch.int32)
    v = torch.tensor([[2, 0]], dtype=torch.int32)
    sg, sb, sv = tcand.select_global(g, b, v, 2)
    assert sg.tolist() == [[3, BIG]] and sb.tolist() == [[1, BIG]]
    # the multi-shard merge is ported: two proposals into the top 1 equal
    # the JAX function's
    got = tcand.select_global(g, b, v, 1)
    want = jcand.select_global(jnp.asarray(g.numpy()), jnp.asarray(b.numpy()),
                               jnp.asarray(v.numpy()), 1)
    assert got[0].tolist() == [[3]]
    for t, j in zip(got, want):
        _eq(t, j)
    # chained voting is ported: it equals the JAX function
    keys = torch.tensor([[1, 1, 2, 2, 2, 5, BIG, BIG]], dtype=torch.int32)
    sid = torch.arange(4, dtype=torch.int32)
    got = tcand.vote_and_rank(keys, sid, 2, 1, nbins=4, chain_gamma=2)
    want = jcand.vote_and_rank(jnp.asarray(keys.numpy()),
                               jnp.asarray(sid.numpy()), 2, 1, False, 4,
                               chain_gamma=2)
    for t, j in zip(got, want):
        _eq(t, j)
