"""Long-read voting in the port (kernels/sort.py::vote_top with collinear
chaining and neighbour-bin smoothing, candidates.vote_and_rank's routing,
B1's plain version at long-read rows) against the JAX package: its
candidates._per_query, vote_and_rank and sort_rows (Pallas interpreted),
and the O(M^2) chain oracle of tests/test_chain.py. Integer outputs:
tolerance 0 (equal)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghostm_tpu.kernels import candidates as jcand
from ghostm_tpu.kernels import sort as jsort
from ghostm_tpu_torch.kernels import candidates as tcand
from ghostm_tpu_torch.kernels import sort as tsort

# One intra-op thread: the suite runs several pytest workers at once and
# torch's spinning OpenMP threads would oversubscribe the cores.
torch.set_num_threads(1)

BIG = 1 << 30


def _presorted(keys, run):
    """Even runs ascending, odd runs descending (propose_shard's rows)."""
    q, m = keys.shape
    k3 = np.sort(keys.reshape(q, m // run, run), axis=2)
    k3[:, 1::2] = k3[:, 1::2, ::-1]
    return np.ascontiguousarray(k3.reshape(q, m))


def _sorted_rows(rng, q, m, hi, big_frac):
    k = rng.integers(0, hi, (q, m)).astype(np.int32)
    k[rng.random((q, m)) < big_frac] = BIG
    return np.sort(k, axis=1)


def _vote(sorted_keys, nbins, gamma, ncand=8, smooth=False, min_votes=1):
    k, v = tsort.vote_top(torch.from_numpy(np.atleast_2d(sorted_keys)),
                          ncand, min_votes, nbins=nbins, smooth=smooth,
                          chain_gamma=gamma)
    return k[0].numpy(), v[0].numpy()


# ---------------------------------------------------------------------------
# the chain DP (port versions of tests/test_chain.py)
# ---------------------------------------------------------------------------

def oracle_chain(keys, votes, nbins, gamma):
    """O(M^2) reference: C[i] = v[i] + max(0, max_{j<i, same subject}
    (C[j] - gamma * (key[i]-key[j])))."""
    M = len(keys)
    C = np.zeros(M, np.int64)
    for i in range(M):
        best = 0
        for j in range(i):
            if keys[j] // nbins == keys[i] // nbins:
                best = max(best, C[j] - gamma * (keys[i] - keys[j]))
        C[i] = votes[i] + best
    return C


def test_chain_matches_oracle_random():
    rng = np.random.default_rng(0)
    nbins = 64
    for trial in range(20):
        nsubj = rng.integers(1, 6)
        M = 128
        raw = np.sort(rng.integers(0, nsubj * nbins, M)).astype(np.int32)
        n_invalid = rng.integers(0, 30)
        keys = np.concatenate([raw[: M - n_invalid],
                               np.full(n_invalid, BIG, np.int32)])
        ek, ev = np.unique(keys[keys < BIG], return_counts=True)
        C = oracle_chain(ek, ev, nbins, 2)
        want = dict(zip(ek.tolist(), C.tolist()))
        tk, tv = _vote(keys, nbins, 2, ncand=len(ek) + 2)
        got = {int(a): int(b) for a, b in zip(tk, tv) if a < BIG}
        assert got == want, trial
        # the top-ncand by (C desc, key asc) is the oracle's order
        order = sorted(want, key=lambda x: (-want[x], x))
        assert list(tk[: len(order)]) == order


def test_chain_drifting_hits_concentrate():
    """A long-read alignment drifting across 5 bins: chaining ranks its
    end bin above an isolated 4-vote bin elsewhere (raw votes would tie)."""
    nbins = 1024
    row = 3
    keys = []
    for b in [100, 101, 103, 106, 110]:        # drifts over 10 bins
        keys += [row * nbins + b] * 3           # 3 votes each
    keys += [7 * nbins + 500] * 4               # isolated competitor
    keys = np.sort(np.array(keys, np.int32))
    keys = np.concatenate([keys, np.full(64 - len(keys), BIG, np.int32)])
    tk, tv = _vote(keys, nbins, 1)
    # C(100)=3, C(101)=5, C(103)=6, C(106)=6, C(110)=5
    assert int(tk[0]) == row * nbins + 103 and int(tv[0]) == 6


def test_chain_never_spans_subjects():
    nbins = 8  # tiny: cross-subject key gaps are small enough to tempt
    keys = np.array([0 * nbins + 6] * 5 + [1 * nbins + 0] * 5, np.int32)
    keys = np.concatenate([keys, np.full(22, BIG, np.int32)])
    tk, tv = _vote(keys, nbins, 1)
    got = {int(a): int(b) for a, b in zip(tk, tv) if a < BIG}
    assert got == {6: 5, 8: 5}


def test_chain_shard_invariance_of_scores():
    """The same subject on different shard rows -> the same chain scores."""
    nbins = 256
    for row in (0, 5, 117):
        keys = []
        for b, v in zip([10, 11, 40, 41], [2, 3, 1, 4]):
            keys += [row * nbins + b] * v
        keys = np.sort(np.array(keys, np.int32))
        keys = np.concatenate([keys, np.full(16 - len(keys), BIG, np.int32)])
        tk, tv = _vote(keys, nbins, 1)
        got = sorted((int(a) - row * nbins, int(b))
                     for a, b in zip(tk, tv) if a < BIG)
        # C(10)=2, C(11)=3+max(0,2-1)=4, C(40)=1, C(41)=4+max(0,1-1)=4
        assert got == [(10, 2), (11, 4), (40, 1), (41, 4)], row


# ---------------------------------------------------------------------------
# the row-batched vote against the JAX _per_query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,m,nsubj,nbins,smooth,gamma,minv,ncand", [
    (6, 1024, 4, 64, False, 2, 1, 8),      # chain
    (6, 1024, 4, 64, True, 0, 1, 8),       # smooth
    (6, 1024, 4, 64, True, 2, 1, 8),       # both
    (5, 608, 40, 113, True, 2, 3, 4),      # min_votes above most runs
    (4, 2048, 2, 16, True, 1, 1, 32),      # dense rows: long chains, ties
    (3, 1725 * 16, 571, 113, True, 2, 1, 4),   # a 5 kbp row, packed top-k
    (2, 33_000, 300, 113, True, 2, 1, 4),  # 2 * 16 bits > 31: two reductions
    (2, 33_000, 300, 113, False, 2, 2, 6),
])
def test_vote_top_matches_jax_per_query(rng, q, m, nsubj, nbins, smooth,
                                        gamma, minv, ncand):
    k = _sorted_rows(rng, q, m, nsubj * nbins, 0.3)
    fn = functools.partial(jcand._per_query, nbins=nbins, ncand=ncand,
                           min_votes=minv, smooth=smooth, chain_gamma=gamma)
    wk, wv = jax.vmap(fn)(jnp.asarray(k))
    gk, gv = tsort.vote_top(torch.from_numpy(k), ncand, minv, nbins=nbins,
                            smooth=smooth, chain_gamma=gamma)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert int(gv.max()) > 0


@pytest.mark.parametrize("smooth,gamma,nbins", [
    (True, 0, 64), (False, 2, 64), (True, 2, 113),
])
def test_vote_and_rank_long_read_matches_jax(rng, smooth, gamma, nbins):
    """Presorted runs of 16 (a 16-wide seed table): the port routes the
    chained and smoothed rows to B1 + the row-batched vote, the JAX
    function to sort + _per_query; the proposals are equal."""
    q, run, S = 6, 16, 30
    m = 64 * run
    keys = rng.integers(0, S * nbins // 3, (q, m)).astype(np.int32)
    keys[rng.random((q, m)) < 0.3] = BIG
    keys = _presorted(keys, run)
    sid = np.arange(S, dtype=np.int32)
    got = tcand.vote_and_rank(torch.from_numpy(keys), torch.from_numpy(sid),
                              4, 1, smooth=smooth, nbins=nbins,
                              presorted_run=run, chain_gamma=gamma)
    want = jcand.vote_and_rank(jnp.asarray(keys), jnp.asarray(sid), 4, 1,
                               smooth, nbins, chain_gamma=gamma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("gamma,ncand,nbins,S", [
    (1, 4, 64, 30), (2, 8, 113, 30), (4, 1, 32, 30),
    (2, 4, 1 << 20, 600),   # gamma * S * nbins past 2^30: int32 wraps
    (2, 40, 64, 30),        # ncand past R2's top lists
])
def test_vote_and_rank_chained_cpu_takes_the_plain_vote(
        rng, monkeypatch, gamma, ncand, nbins, S):
    """Every unsmoothed chained vote goes through sort.chain_vote_rank_rows
    (kernel R2's wrapper), whose CPU version is the plain vote_top: no
    launch counted, and the proposals equal the JAX package's."""
    from ghostm_tpu_torch.kernels import _build

    calls = []
    wrapper = tsort.chain_vote_rank_rows
    monkeypatch.setattr(tsort, "chain_vote_rank_rows",
                        lambda *a: calls.append(a) or wrapper(*a))
    q, run = 6, 16
    m = 64 * run
    keys = rng.integers(0, min(S * nbins, BIG) // 3, (q, m)).astype(np.int32)
    keys[rng.random((q, m)) < 0.3] = BIG
    keys = _presorted(keys, run)
    sid = np.arange(S, dtype=np.int32)
    before = dict(_build.LAUNCHES)
    got = tcand.vote_and_rank(torch.from_numpy(keys), torch.from_numpy(sid),
                              ncand, 1, nbins=nbins, presorted_run=run,
                              chain_gamma=gamma)
    assert _build.LAUNCHES == before
    assert len(calls) == 1
    want = jcand.vote_and_rank(jnp.asarray(keys), jnp.asarray(sid), ncand,
                               1, False, nbins, chain_gamma=gamma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].max()) > 0


def test_vote_and_rank_chain_overflow_raises():
    """gamma * S * nbins + M must stay below 2^31, as in the reference."""
    keys = torch.full((1, 128), BIG, dtype=torch.int32)
    sid = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows the"):
        tcand.vote_and_rank(keys, sid, 4, 1, nbins=1 << 28, chain_gamma=2)


# ---------------------------------------------------------------------------
# B1's plain version at long-read rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,m", [(4, 1725 * 16), (2, 3453 * 16)])
def test_sort_rows_long_matches_jax(rng, q, m):
    """5 kbp and 10 kbp key rows with runs of 16, against the Pallas
    kernel interpreted (L 32768 and 65536)."""
    x = rng.integers(0, 1 << 26, (q, m)).astype(np.int32)
    x[rng.random((q, m)) < 0.2] = BIG
    x = _presorted(x, 16)
    got = tsort.sort_rows(torch.from_numpy(x), presorted_run=16)
    want = jsort.sort_rows(jnp.asarray(x), presorted_run=16, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
