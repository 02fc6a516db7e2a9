"""The port's CUDA kernels against their plain PyTorch versions on the card
(integer outputs: equal), and the CUDA engine against the CPU engine.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU with
nvcc and skips without one. Run on the card with
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from ghostm_tpu_torch.kernels import _build, refine, sw_fused, sw_scored
from ghostm_tpu_torch.kernels import sort as S
from ghostm_tpu_torch.kernels import sw_wave, sw_xla
from ghostm_tpu_torch.ops.scoring import padded_matrix
from refine_cases import CONFIGS, make_case

pytestmark = pytest.mark.cuda
BIG = 1 << 30


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _presorted(k, run):
    """Runs of `run` sorted, odd runs descending (the stage-skip input)."""
    q, m = k.shape
    k = torch.sort(k.view(q, m // run, run), dim=2).values
    k[:, 1::2] = torch.flip(k[:, 1::2], [2])
    return k.reshape(q, m).contiguous()


def _keys(gen, q, m, run, hi, dev, big_frac=0.4):
    k = torch.randint(0, hi, (q, m), generator=gen, dtype=torch.int32)
    k[torch.rand((q, m), generator=gen) < big_frac] = BIG
    if run > 1:
        k = _presorted(k, run)
    return k.to(dev)


def _cases(old, new):
    """The earlier cases (random rows, their ids unchanged) and new ones
    whose last field names the kind of row (_fill)."""
    return ([pytest.param(*c, "rand", id="-".join(map(str, c))) for c in old]
            + [pytest.param(*c) for c in new])


def _fill(k, kind, gen):
    """Rows that a register network or a merge path gets wrong: one value
    (a run over the whole row, across threads, warps and the a/b split),
    only BIG, only PAD, fewer distinct keys than candidates, every key
    exactly twice (vote ties across warps, broken by key)."""
    q, m = k.shape
    if kind == "equal":
        k[:] = 12345
    elif kind == "big":
        k[:] = BIG
    elif kind == "pad":
        k[:] = S.PAD
    elif kind == "few":
        k[:] = torch.randint(0, 5, (q, m), generator=gen, dtype=torch.int32)
        k[torch.rand((q, m), generator=gen) < 0.2] = BIG
    elif kind == "ties":
        k[:] = torch.stack([torch.randperm(m, generator=gen) // 2
                            for _ in range(q)]).to(torch.int32)
    return k


def _unaligned(x):
    """A contiguous copy of x whose data starts 4 bytes past 16-byte
    alignment: the kernels' scalar load and store edge."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("q,m,run,kind", _cases([
    (5, 7, 0), (128, 1, 0), (33, 300, 0), (64, 4096, 128), (64, 512, 128),
    (8, 8192, 0), (16, 2048, 2048), (6, 16384, 128),
], [
    (9, 128, 0, "rand"), (3, 16384, 0, "rand"), (7, 5000, 0, "rand"),
    (65, 2560, 128, "rand"), (31, 1024, 16, "rand"), (5, 256, 0, "rand"),
    (10, 4096, 128, "equal"), (10, 4096, 128, "big"), (10, 512, 128, "pad"),
    (12, 640, 128, "few"), (4, 16384, 128, "few"),
    (40, 4096, 128, "unaligned"), (40, 300, 0, "unaligned"),
]))
def test_sort_rows_kernel(dev, q, m, run, kind):
    gen = torch.Generator().manual_seed(q * m)
    x = _keys(gen, q, m, run or 1, 1 << 30, dev, 0.0)
    if run == 0:
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (q, m), generator=gen,
                          dtype=torch.int32).to(dev)
    if kind in ("equal", "big", "pad", "few"):
        x = _fill(x.cpu(), kind, gen)
        if run > 1:   # re-establish the presorted runs
            x = _presorted(x, run)
        x = x.to(dev)
    elif kind == "unaligned":
        x = _unaligned(x)
    got = _launched("sort_rows", lambda: S.sort_rows(x, presorted_run=run))
    assert torch.equal(got, S.sort_rows_plain(x, presorted_run=run))


@pytest.mark.parametrize("q,m,run,kind", [
    (768, 1725 * 16, 16, "rand"),   # the 5 kbp propose row: 2 tiles
    (384, 3453 * 16, 16, "rand"),   # 10 kbp: 4 tiles
    (3, 16385, 0, "rand"),          # one key past a tile (scalar edge)
    (5, 16384 + 16, 16, "rand"),    # one run past a tile
    (2, 3 * 16384, 16, "rand"),     # 3 tiles
    (1, 5 * 16384 + 100, 0, "rand"),   # Q = 1, 6 tiles
    (1, 1725 * 128, 128, "rand"),   # k = 5, hits_per_seed 128: 14 tiles
    (2, 32768, 8192, "rand"),       # runs of half a tile: its last stage
    (2, 32768, 16384, "rand"),      # runs as long as a tile: full tile sort
    (2, 65536, 32768, "rand"),      # runs longer than a tile
    (3, 1725 * 16, 16, "big"), (2, 3453 * 16, 16, "few"),
    (2, 3453 * 16, 16, "ties"), (3, 1725 * 16, 16, "equal"),
    (4, 1725 * 16, 16, "unaligned"), (3, 16385 * 2, 0, "unaligned"),
    # the k-way merge: the longread_k5.hifi10k cell's rows (3,452 k-mers x
    # 128 seeds, runs of 128, ~54% BIG: 27 tiles, the last short), K = 2
    # to KMAX = 32, KMAX + 1 and 64 + 1 tiles (pairwise passes first), the
    # cell's rows all BIG, all equal, of 5 values, unaligned, and rows of
    # equal runs straddling every tile and bucket edge (ascending and
    # descending blocks of 5,000 equal keys)
    (128, 3452 * 128, 128, "cell"), (2, 3452 * 128, 128, "big"),
    (2, 3452 * 128, 128, "equal"), (2, 3452 * 128, 128, "few"),
    (3, 3452 * 128 + 3, 0, "unaligned"), (2, 2 * 16384, 0, "rand"),
    (2, 27 * 16384, 16, "rand"), (2, 32 * 16384, 16, "rand"),
    (2, 33 * 16384, 16, "rand"), (1, 64 * 16384 + 4, 4, "rand"),
    (2, 20 * 16384 + 7, 0, "blocks"), (2, 20 * 16384 + 8, 8, "blocks_desc"),
    (2, 32 * 16384, 0, "blocks"), (2, 33 * 16384 - 5, 0, "few"),
])
def test_sort_rows_long_kernel(dev, q, m, run, kind):
    """B1 past one block (M > 16384): the tile sort and its merges against
    torch.sort; one tile launch, then sort.long_plan's launches: one k-way
    merge up to KMAX tiles, pairwise passes first above."""
    gen = torch.Generator().manual_seed(q + m)
    x = torch.randint(0, 1 << 26, (q, m), generator=gen, dtype=torch.int32)
    x[torch.rand((q, m), generator=gen) < (0.54 if kind == "cell" else 0.2)
      ] = BIG
    if run == 0:
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (q, m), generator=gen,
                          dtype=torch.int32)
    if kind in ("equal", "big", "few", "ties"):
        x = _fill(x, kind, gen)
    elif kind.startswith("blocks"):
        b = torch.arange(m, dtype=torch.int32) // 5000
        x[:] = b.flip(0) if kind == "blocks_desc" else b
    if run > 1:
        x = _presorted(x, run)
    x = x.to(dev)
    if kind == "unaligned":
        x = _unaligned(x)
    before, shapes = dict(_build.LAUNCHES), _build.SHAPES.copy()
    got = S.sort_rows(x, presorted_run=run)
    torch.cuda.synchronize()
    passes, kway = S.long_plan(m)
    assert _build.LAUNCHES["sort_rows_tiles"] == before["sort_rows_tiles"] + 1
    assert (_build.LAUNCHES["sort_rows_merge"]
            == before["sort_rows_merge"] + passes + kway)
    assert _build.LAUNCHES["sort_rows_kway"] == before["sort_rows_kway"] + kway
    if m <= S.KWAY_MAX * S.TILE:
        assert (passes, kway) == (0, 1)
        k = -(-m // S.TILE)
        assert (_build.SHAPES - shapes)[("sort_rows_kway", (q, m, k))] == 1
    assert _build.LAUNCHES["sort_rows"] == before["sort_rows"]
    assert torch.equal(got, S.sort_rows_plain(x, presorted_run=run))


@pytest.mark.parametrize("q,m,run,minv,hi,kind", _cases([
    (768, 608, 16, 1, 1 << 10), (40, 96, 1, 1, 64), (16, 640, 128, 2, 1000),
    (9, 4096, 0, 1, 50), (3, 128, 128, 1, 4),
], [
    (6144, 4096, 128, 1, 1 << 22, "rand"),   # 36-residue frames
    # `first` from run 0 and 1 (stage 1), 16 and L (no stage: one run)
    (33, 1024, 0, 1, 300, "rand"), (33, 1024, 1, 1, 300, "rand"),
    (33, 1024, 16, 1, 300, "rand"), (33, 1024, 1024, 1, 300, "rand"),
    (8, 16384, 128, 1, 1 << 12, "rand"), (5, 16384, 0, 1, 300, "rand"),
    (70, 128, 0, 1, 20, "rand"),    # 32 rows a block, 8 a warp's vote
    (33, 300, 0, 1, 20, "rand"), (9, 2048, 16, 1, 100, "rand"),
    (16, 608, 16, 1, 1 << 10, "ncand32"), (16, 4096, 128, 1, 300, "ncand128"),
    (4, 16384, 128, 1, 300, "ncand128"), (70, 128, 0, 1, 20, "ncand128"),
    (16, 608, 16, 100000, 1 << 10, "rand"),   # min_votes above every run
    (16, 608, 16, 1, 0, "big"), (16, 4096, 128, 1, 0, "pad"),
    (16, 608, 16, 1, 0, "equal"), (16, 1024, 16, 1, 0, "few"),
    (16, 2048, 0, 1, 0, "ties"),
    (40, 608, 16, 1, 1 << 10, "unaligned"), (40, 98, 0, 1, 30, "rand"),
]))
def test_sort_vote_kernel(dev, q, m, run, minv, hi, kind):
    """B2's monolithic entry: B1's network, then the merge entry's vote."""
    gen = torch.Generator().manual_seed(m + run)
    x = _keys(gen, q, m, run or 1, max(hi, 1), "cpu")
    if kind in ("equal", "big", "pad", "few", "ties"):
        x = _fill(x, kind, gen)
        if run > 1:   # re-establish the presorted runs
            x = _presorted(x, run)
    x = x.to(dev)
    if kind == "unaligned":
        x = _unaligned(x)
    ncand = int(kind[5:]) if kind.startswith("ncand") else 8
    got = _launched("sort_vote_rank_rows",
                    lambda: S.sort_vote_rank_rows(x, ncand, minv, run))
    want = S.sort_vote_rank_rows_plain(x, ncand, minv, run)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("q,la,mb,minv,hi,kind", _cases([
    (256, 4096, 512, 1, 1 << 12), (64, 128, 1, 1, 50),
    (32, 1024, 1024, 2, 300), (16, 2048, 7, 1, 1 << 20),
    (24, 8192, 2560, 1, 1 << 14),   # 88-residue frames: a 64 KB row
], [
    (64, 8192, 2560, 1, 1 << 22, "rand"),   # the 250 bp merge shape
    (16, 4096, 4096, 1, 1 << 12, "rand"),   # Mb = La
    (16, 8192, 1, 1, 1 << 14, "rand"),      # Mb = 1
    (16, 4096, 512, 1, 0, "equal"), (16, 4096, 512, 1, 0, "big_a"),
    (16, 4096, 512, 1, 0, "pad"), (16, 4096, 512, 1, 0, "few"),
    (16, 4096, 512, 1, 0, "ties"), (16, 8192, 8192, 1, 0, "ties"),
    (16, 4096, 512, 1, 1 << 12, "invalid_b"),
    (16, 4096, 512, 100000, 1 << 12, "rand"),   # min_votes above every run
    (16, 128, 128, 1, 30, "rand"),
    (40, 4096, 512, 1, 1 << 12, "unaligned"),
    (8, 4096, 512, 1, 1 << 12, "ncand32"), (8, 1024, 100, 1, 300, "ncand128"),
]))
def test_merge_vote_kernel(dev, q, la, mb, minv, hi, kind):
    gen = torch.Generator().manual_seed(la + mb)
    if hi:
        a = _keys(gen, q, la, 1, hi, "cpu")
        b = _keys(gen, q, mb, 1, hi, "cpu")
    else:   # one row drawn whole, then split: runs cross the a/b boundary
        ab = _fill(torch.zeros((q, la + mb), dtype=torch.int32), kind, gen)
        a, b = ab[:, :la], ab[:, la:]
    if kind == "big_a":
        a[:] = BIG
    elif kind == "invalid_b":
        b[:] = BIG
    a = torch.sort(a, dim=1).values.contiguous().to(dev)
    b = torch.sort(b, dim=1).values.contiguous().to(dev)
    if kind == "unaligned":
        a, b = _unaligned(a), _unaligned(b)
    ncand = int(kind[5:]) if kind.startswith("ncand") else 8
    got = _launched("merge_vote_rank_rows",
                    lambda: S.merge_vote_rank_rows(a, b, ncand, minv))
    want = S.merge_vote_rank_rows_plain(a, b, ncand, minv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _chain_rows(gen, q, m, kind, nbins, gamma):
    """Sorted (q, m) vote-key rows of `kind`: "rand" (keys over up to
    570,000 subjects' bins, 30% invalid), "dense" (4 subjects: long
    chains, tied scores), "one" (one subject a row: one segment), "singles"
    (one-key runs), "big" (all invalid), "edges" (a new subject row every
    16 keys, at every thread's slice edge and so every tile edge, runs of
    1-3 keys inside), "long_runs" (runs of 37 keys and of 5,000, across
    slices and tiles, one subject), "span" (gamma * key up to 2^30: no
    int32 wraps), "wrap" (gamma * key past 2^30, up to 2^31 - m: the plain
    version's subtraction at a segment's first run wraps, and so, at m <
    2^15, does its packed top-k; one-key runs, each its own segment at
    nbins 1), "unaligned" ("rand" 4 bytes past 16-byte alignment)."""
    subjects = min(570_000, (1 << 30) // gamma // nbins)
    i = torch.arange(m, dtype=torch.int32).expand(q, m)
    if kind in ("rand", "unaligned"):
        k = torch.randint(0, subjects * nbins, (q, m), generator=gen,
                          dtype=torch.int32)
        k[torch.rand((q, m), generator=gen) < 0.3] = BIG
    elif kind == "dense":
        k = torch.randint(0, 4 * nbins, (q, m), generator=gen,
                          dtype=torch.int32)
    elif kind == "one":
        row = torch.randint(0, subjects, (q, 1), generator=gen,
                            dtype=torch.int32)
        k = row * nbins + torch.randint(0, nbins, (q, m), generator=gen,
                                        dtype=torch.int32)
    elif kind == "singles":
        steps = torch.randint(1, 4, (q, m), generator=gen,
                              dtype=torch.int32)
        k = torch.cumsum(steps, 1, dtype=torch.int32)
    elif kind == "big":
        k = torch.full((q, m), BIG, dtype=torch.int32)
    elif kind == "edges":
        k = (i // 16) * nbins + (i % 16) // 3
    elif kind == "long_runs":
        k = torch.where(i < m // 2, i // 37, m // 74 + 1 + i // 5000)
    elif kind == "span":
        top = (1 << 30) // gamma
        k = torch.randint(top - 20_000, top + 1, (q, m), generator=gen,
                          dtype=torch.int32)
    elif kind == "wrap":
        k = torch.randint((1 << 30) // gamma + 1, ((1 << 31) - m) // gamma,
                          (q, m), generator=gen, dtype=torch.int32)
    return torch.sort(k.to(torch.int32), dim=1).values.contiguous()


@pytest.mark.parametrize("q,m,kind,gamma,ncand,minv,nbins", [
    (128, 3452 * 128, "rand", 2, 4, 1, 124),   # the long-read cell's rows
    (384, 55_248, "rand", 2, 4, 1, 124),   # 10 kbp reads at k = 4
    (768, 27_600, "rand", 2, 4, 1, 124),   # 5 kbp reads
    (5, 13_800, "rand", 2, 4, 1, 113),
    (7, 4097, "rand", 1, 8, 1, 64),        # odd M: one key past a tile
    (9, 1001, "rand", 4, 1, 1, 32),        # odd M
    (5, 33, "rand", 2, 8, 1, 8), (3, 1, "rand", 2, 4, 1, 8),
    (64, 16_384, "dense", 1, 8, 3, 16), (16, 4096, "dense", 2, 32, 1, 16),
    (16, 55_248, "one", 2, 4, 1, 4096), (16, 27_600, "one", 4, 8, 3, 124),
    (16, 27_600, "singles", 2, 8, 1, 124),
    (16, 27_601, "singles", 4, 4, 1, 124),
    (8, 12_288, "big", 2, 4, 1, 124),
    (8, 8192, "edges", 2, 8, 1, 64), (8, 8195, "edges", 1, 4, 3, 64),
    (8, 55_248, "long_runs", 1, 4, 1, 1 << 16),
    (8, 55_248, "long_runs", 4, 8, 3, 1 << 16),
    (8, 10_000, "span", 4, 8, 1, 124), (8, 10_000, "span", 1, 4, 3, 124),
    (8, 10_000, "span", 2, 1, 1, 124),
    (8, 10_000, "wrap", 2, 8, 1, 1), (8, 27_600, "wrap", 4, 4, 1, 124),
    (4, 40_000, "wrap", 2, 8, 3, 1),      # m >= 2^15: the plain two-pass
    (4096, 2, "wrap", 2, 4, 1, 1),        # rows of negative readings only
    (2048, 3, "wrap", 4, 1, 1, 1),
    (40, 27_600, "unaligned", 2, 4, 1, 124),
    # rows of several blocks (S.CHAIN_PART keys each): one subject over
    # four blocks, long subjects, a subject row ending at each block edge
    (4, 3 * S.CHAIN_PART + 5, "one", 2, 8, 1, 1 << 20),
    (8, 70_000, "dense", 2, 4, 3, 4096),
    (8, 2 * S.CHAIN_PART + 16, "edges", 1, 4, 1, 64),
    (4, 2 * S.CHAIN_PART + 7, "unaligned", 4, 32, 1, 124),
])
def test_chain_vote_kernel(dev, q, m, kind, gamma, ncand, minv, nbins):
    """Kernel R2 against the plain vote_top(..., chain_gamma): one launch,
    equal keys and votes, on rows of one block and of several."""
    gen = torch.Generator().manual_seed(q * m + gamma)
    k = _chain_rows(gen, q, m, kind, nbins, gamma).to(dev)
    if kind == "unaligned":
        k = _unaligned(k)
    got = _launched("chain_vote_rank_rows", lambda: S.chain_vote_rank_rows(
        k, ncand, minv, nbins, gamma))
    want = S.vote_top(k, ncand, minv, nbins=nbins, chain_gamma=gamma)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind != "big":
        assert int(want[1].max()) > 0
    if kind == "wrap" and m < 8:
        assert int(want[1].min()) < 0


def test_chain_vote_kernel_ncand_past_its_lists_raises(dev):
    """R2 keeps top lists of up to S.CHAIN_NCAND: a wider ncand on a CUDA
    tensor raises rather than running the plain vote on the card."""
    k = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ncand"):
        S.chain_vote_rank_rows(k, S.CHAIN_NCAND + 1, 1, 16, 2)


def _lex_ops(gen, kind, q, m, nk, nops):
    """Keys 0..2 ("rand", the earlier cases; "ties": ties in most
    columns, 0..1), or "sentinel": INT32_MIN, INT32_MAX = PAD and values
    beside them, tied across them; payload -100..99."""
    ops = torch.randint(0, 3, (nops, q, m), generator=gen, dtype=torch.int32)
    if kind == "ties":
        ops[:nk] = torch.randint(0, 2, (nk, q, m), generator=gen,
                                 dtype=torch.int32)
    elif kind == "sentinel":
        vals = torch.tensor([-(1 << 31), (1 << 31) - 1, S.PAD, -1, 0, 1],
                            dtype=torch.int32)
        ops[:nk] = vals[torch.randint(0, 6, (nk, q, m), generator=gen)]
    ops[nk:] = torch.randint(-100, 100, (nops - nk, q, m), generator=gen,
                             dtype=torch.int32)
    return ops


@pytest.mark.parametrize("q,m,nk,nops,topk,kind", _cases([
    (8192, 48, 5, 9, 10), (100, 16, 3, 3, 8), (10, 100, 2, 4, 100),
    (50, 64, 3, 7, 64),
], [
    (8192, 48, 3, 3, 8, "rand"),       # the select's 3 operands, 3 keys
    (100, 1, 5, 9, 10, "rand"), (100, 33, 5, 9, 10, "rand"),
    (100, 64, 5, 9, 10, "rand"), (100, 65, 5, 9, 10, "rand"),
    (50, 200, 5, 9, 10, "rand"), (64, 1026, 5, 9, 10, "rand"),
    (4, 8192, 5, 9, 10, "rand"),        # the cap at 5 keys: 192 KB
    (300, 48, 5, 9, 10, "sentinel"), (50, 200, 5, 9, 10, "sentinel"),
    (300, 48, 5, 9, 10, "ties"), (20, 1026, 3, 3, 1026, "ties"),
    (100, 20, 5, 9, 30, "rand"),        # topk > M
    (77, 48, 1, 4, 10, "ties"), (77, 48, 9, 9, 10, "ties"),   # other
    (77, 64, 2, 2, 64, "sentinel"), (9, 300, 7, 8, 12, "ties"),  # counts
    (5, 2, 5, 9, 10, "ties"),
    # the multi-shard select: 3 keys, top 8 of n_shards x 8 columns (the
    # 3-key warp instance up to 64 columns, the block kernel above)
    (49152, 16, 3, 3, 8, "ties"), (100, 24, 3, 3, 8, "ties"),
    (100, 64, 3, 3, 8, "ties"), (300, 16, 3, 3, 8, "sentinel"),
    (60, 100, 3, 3, 8, "ties"),
]))
def test_lex_rank_kernel(dev, q, m, nk, nops, topk, kind):
    gen = torch.Generator().manual_seed(q + m)
    ops = _lex_ops(gen, kind, q, m, nk, nops).to(dev)
    got = _launched("lex_rank_rows", lambda: S.lex_rank_rows(ops, nk, topk))
    assert torch.equal(got, S.lex_rank_rows_plain(ops, nk, topk))


@pytest.mark.parametrize("m,nk", [(8193, 5), (8192, 8), (16384, 3)])
def test_lex_rank_kernel_row_cap(dev, m, nk):
    """Above (num_keys + 1) x L x 4 bytes = 227 KB the wrapper raises."""
    ops = torch.zeros((nk, 2, m), dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="227 KB"):
        S.lex_rank_rows(ops, nk, 10)


def _fused_inputs(gen, n, lq, band, kind):
    """Related and unrelated pairs (the earlier cases, kind "rand"), or:
    "repeat" (one code in query and window, every cell live in half the
    rows: equal maxima everywhere), "periodic" (query and window of one
    period-6 pattern: ties across diagonals), "copied" (the query copied
    into the window twice)."""
    q = torch.randint(0, 26, (n, lq), generator=gen, dtype=torch.int8)
    w = torch.randint(0, 26, (n, lq + band + 3), generator=gen,
                      dtype=torch.int8)
    w[::2, 3:3 + lq] = q[::2]
    lo = torch.randint(-4, 8, (n,), generator=gen, dtype=torch.int32)
    hi = torch.randint(lq // 2, lq + band + 4, (n,), generator=gen,
                       dtype=torch.int32)
    if kind == "repeat":
        q[:], w[:] = 18, 18
        lo[::2], hi[::2] = -4, lq + band + 4
    elif kind == "periodic":
        pat = torch.randint(0, 20, (n, 6), generator=gen, dtype=torch.int8)
        q = pat.repeat(1, -(-lq // 6))[:, :lq].contiguous()
        w = pat.repeat(1, -(-(lq + band + 6) // 6))[:, 3:lq + band + 6]
        w = w.contiguous()
    elif kind == "copied":
        half = band // 2
        w[:, 1:1 + lq] = q
        w[:, 1 + half:1 + half + lq] = q
    return q, w, lo, hi


@pytest.mark.parametrize("n,lq,band,kind,matrix", [
    # the earlier cases, their ids unchanged
    *(pytest.param(*c, "rand", "BLOSUM62", id="-".join(map(str, c)))
      for c in ((4096, 40, 32), (1000, 40, 16), (513, 24, 64), (300, 96, 32),
                (200, 40, 128), (100, 300, 48), (64, 40, 18))),
    # one alignment; a warp and one; not a multiple of the block (512
    # alignments at band <= 32, 256 at 64, 128 at 128)
    (1, 40, 32, "rand", "BLOSUM62"), (33, 40, 32, "rand", "BLOSUM62"),
    (777, 40, 32, "rand", "BLOSUM62"), (300, 40, 64, "rand", "BLOSUM62"),
    (130, 40, 128, "rand", "BLOSUM62"), (1, 24, 96, "rand", "BLOSUM62"),
    # ties, at one lane and across lanes
    (512, 40, 32, "repeat", "BLOSUM62"), (512, 40, 32, "periodic", "BLOSUM62"),
    (512, 40, 32, "copied", "BLOSUM62"), (256, 40, 64, "repeat", "BLOSUM62"),
    (256, 40, 64, "periodic", "BLOSUM62"),
    (128, 40, 128, "copied", "BLOSUM62"),
    (200, 41, 18, "repeat", "BLOSUM62"), (200, 37, 80, "periodic", "BLOSUM62"),
    # BLOSUM50's table (values up to 15), as chip_smoke times it
    (4096, 40, 32, "rand", "BLOSUM50"), (300, 96, 32, "rand", "BLOSUM50"),
    (200, 300, 128, "rand", "BLOSUM50"), (200, 40, 18, "periodic", "BLOSUM50"),
])
def test_sw_fused_kernel(dev, n, lq, band, kind, matrix):
    gen = torch.Generator().manual_seed(n + lq + band)
    mat = torch.from_numpy(padded_matrix(matrix).astype(np.int32)).to(dev)
    climit = sw_fused.build_packed_matrix(padded_matrix(matrix,
                                                        hard_stop=True))[1]
    go, ge = (11, 1) if matrix == "BLOSUM62" else (13, 2)
    q, w, lo, hi = (t.to(dev) for t in _fused_inputs(gen, n, lq, band, kind))
    got = _launched("sw_fused", lambda: sw_fused.sw_fused(
        q, w, mat, lo, hi, go, ge, band, climit))
    want = sw_fused.sw_fused_plain(q, w, mat, lo, hi, go, ge, band, climit)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert int(got[0].max()) > 0
    # the table built once by the caller, as the engine passes it
    tab = sw_fused.score_table(mat, climit)
    again = _launched("sw_fused", lambda: sw_fused.sw_fused(
        q, w, mat, lo, hi, go, ge, band, climit, table=tab))
    for g, x in zip(again, want):
        assert torch.equal(g, x)


def _scored_inputs(gen, n, lq, band, kind):
    """_fused_inputs, with window codes 26..31 (columns the matrix masks)
    in a quarter of the "rand" windows."""
    q, w, lo, hi = _fused_inputs(gen, n, lq, band, kind)
    if kind == "rand":
        w[1::4] = torch.randint(0, 32, w[1::4].shape, generator=gen,
                                dtype=torch.int8)
    return q, w, lo, hi


def _code_fed(dev, name, n, lq, band, kind, matrix):
    """A code-fed entry of B5 (name "sw_scored") or B6 ("sw_wave") against
    its plain version (the route's tile + the tile-fed plain SW), with the
    table's largest value read by the wrapper and passed in as the engine
    passes it."""
    mod = sw_scored if name == "sw_scored" else sw_wave
    entry = getattr(mod, f"{name}_codes")
    plain = getattr(mod, f"{name}_codes_plain")
    gen = torch.Generator().manual_seed(n + lq + band)
    mat = torch.from_numpy(padded_matrix(matrix).astype(np.int32)).to(dev)
    table = sw_scored.code_table(mat, band)
    go, ge = (13, 2) if matrix == "BLOSUM50" else (11, 1)
    q, w, lo, hi = (t.to(dev) for t in _scored_inputs(gen, n, lq, band,
                                                       kind))
    want = plain(q, w, table, lo, hi, go, ge, band)
    for tmax in (None, int(table.max())):
        got = _launched(name, lambda: entry(q, w, table, lo, hi, go, ge,
                                            band, table_max=tmax))
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    assert lq < 2 or int(want[0].max()) > 0


# the earlier tile cases' (n, lq, band), each band now naming its tile
# route; N = 50,000; the tie kinds of _fused_inputs; other matrices
@pytest.mark.parametrize("n,lq,band,kind,matrix", [
    *((*c, "rand", "BLOSUM50") for c in (
        (8192, 40, 32), (1000, 40, 24), (513, 40, 8), (300, 60, 32),
        (200, 40, 128), (130, 40, 96), (100, 300, 48), (77, 40, 10),
        (64, 1, 64), (5, 0, 32), (50_000, 40, 32), (50_000, 40, 24),
        (393, 40, 1), (257, 40, 33))),
    (512, 40, 32, "repeat", "BLOSUM50"), (512, 40, 24, "periodic", "BLOSUM50"),
    (256, 40, 9, "copied", "BLOSUM50"), (256, 40, 64, "repeat", "BLOSUM50"),
    (1000, 40, 32, "rand", "PAM30"), (1000, 40, 24, "rand", "BLOSUM45"),
])
def test_sw_scored_kernel(dev, n, lq, band, kind, matrix):
    _code_fed(dev, "sw_scored", n, lq, band, kind, matrix)


@pytest.mark.parametrize("n,lq,band,kind,matrix", [
    *((*c, "rand", "BLOSUM50") for c in (
        (8192, 88, 32), (1000, 72, 24), (513, 96, 16), (300, 64, 64),
        (200, 128, 128), (100, 300, 120), (96, 200, 128), (77, 64, 18),
        (65, 200, 40), (50, 65, 20), (33, 5, 32), (3, 0, 32),
        (50_000, 88, 32))),
    (512, 88, 32, "repeat", "BLOSUM50"), (512, 72, 24, "periodic", "BLOSUM50"),
    (256, 88, 64, "copied", "BLOSUM50"), (1000, 88, 32, "rand", "PAM70"),
])
def test_sw_wave_kernel(dev, n, lq, band, kind, matrix):
    _code_fed(dev, "sw_wave", n, lq, band, kind, matrix)


@pytest.mark.parametrize("n,lq,band,kind", [
    (4096, 40, 32, "rand"), (512, 40, 32, "periodic"), (300, 40, 64, "rand"),
    (200, 37, 80, "periodic"), (200, 41, 18, "repeat"),
    (128, 40, 128, "copied"),
])
def test_sw_fused_and_scored_share_the_dp(dev, n, lq, band, kind):
    """B3 after its DP moved into csrc/sw_common.cuh: equal to its plain
    version and to B5 on the same BLOSUM62 codes. Their tables agree there
    (columns from code_limit on are LOW in the hard-stop matrix; LOW and
    NEG cells act alike while H < 2^20)."""
    gen = torch.Generator().manual_seed(n + lq + band)
    mat = torch.from_numpy(padded_matrix("BLOSUM62").astype(np.int32)).to(dev)
    climit = sw_fused.build_packed_matrix(padded_matrix("BLOSUM62",
                                                        hard_stop=True))[1]
    q, w, lo, hi = (t.to(dev) for t in _scored_inputs(gen, n, lq, band,
                                                       kind))
    fused = _launched("sw_fused", lambda: sw_fused.sw_fused(
        q, w, mat, lo, hi, 11, 1, band, climit))
    scored = _launched("sw_scored", lambda: sw_scored.sw_scored_codes(
        q, w, sw_scored.code_table(mat, band), lo, hi, 11, 1, band))
    plain = sw_fused.sw_fused_plain(q, w, mat, lo, hi, 11, 1, band, climit)
    for f, s, p in zip(fused, scored, plain):
        assert torch.equal(f, p) and torch.equal(s, p)
    assert int(plain[0].max()) > 0


def test_engine_cuda_equals_cpu(dev, tmp_path):
    """Golden config-1 index and reads: the packed step output on CUDA
    equals the CPU engine's."""
    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import SearchEngine
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.io.fasta import read_batches

    gold = os.path.join(os.path.dirname(__file__), "golden")
    prefix = str(tmp_path / "idx")
    assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"),
                "-o", prefix]) == 0
    idx = load_index(prefix)
    cfg = Config(query_batch=128)
    _, dna, lens = next(read_batches(os.path.join(gold, "config1_reads.fa"),
                                     128, 120))
    g = SearchEngine(cfg, idx, device="cuda")
    c = SearchEngine(cfg, idx, device="cpu", key_table=g.key_table)
    got = g.fetch(g.search_refine_async_dna(dna, lens))
    want = c.fetch(c.search_refine_async_dna(dna, lens))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frame,band,kernel", [
    (40, 32, "sw_scored"), (72, 32, "sw_wave"), (40, 24, "sw_scored"),
])
def test_engine_cuda_equals_cpu_score_fed(dev, tmp_path, frame, band, kernel):
    """BLOSUM50 on the golden config-1 index: the score-fed route's packed
    output on CUDA equals the CPU engine's (its chunked plain tiles),
    through one launch of B5 or B6 for the batch and none of B3."""
    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import SearchEngine
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.io.fasta import read_batches

    gold = os.path.join(os.path.dirname(__file__), "golden")
    prefix = str(tmp_path / "idx")
    assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"),
                "-o", prefix]) == 0
    idx = load_index(prefix)
    cfg = Config(query_batch=128, matrix="BLOSUM50", gap_open=13,
                 gap_extend=2, query_frame_len=frame, band_width=band)
    _, dna, lens = next(read_batches(os.path.join(gold, "config1_reads.fa"),
                                     128, 120))
    g = SearchEngine(cfg, idx, device="cuda")
    c = SearchEngine(cfg, idx, device="cpu", key_table=g.key_table)
    before = dict(_build.LAUNCHES)
    got = g.fetch(g.search_refine_async_dna(dna, lens))
    assert _build.LAUNCHES[kernel] == before[kernel] + 1
    assert _build.LAUNCHES["sw_fused"] == before["sw_fused"]
    assert sum(_build.LAUNCHES[k] - before[k]
               for k in ("sw_scored", "sw_wave")) == 1
    want = c.fetch(c.search_refine_async_dna(dna, lens))
    np.testing.assert_array_equal(got, want)


def test_engine_cuda_equals_cpu_long_read(dev, tmp_path):
    """Long-read mode (the golden's config: 1728-residue frames, band 64,
    k = 4, chain_gamma 2) on the golden database plus a poly-A subject,
    whose AAAA bucket fills hits_per_seed 16: 16-wide table rows, so
    propose's key rows hold 1725 x 16 keys and take B1's long-row entry
    (2 tiles, one k-way merge). The packed step output on CUDA equals the
    CPU engine's."""
    import json

    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import SearchEngine
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.io.fasta import read_batches

    gold = os.path.join(os.path.dirname(__file__), "golden")
    db = tmp_path / "db.fa"
    with open(os.path.join(gold, "longread_db.fa")) as f:
        db.write_text(f.read() + ">polyA\n" + "A" * 40 + "\n")
    with open(os.path.join(gold, "longread_cfg.json")) as f:
        kw = json.load(f)
    prefix = str(tmp_path / "idx")
    assert cli(["db", "-i", str(db), "-o", prefix, "-k", "4"]) == 0
    idx = load_index(prefix)
    cfg = Config(**kw)
    _, dna, lens = next(read_batches(os.path.join(gold, "longread_reads.fa"),
                                     cfg.query_batch, 5300))
    g = SearchEngine(cfg, idx, device="cuda")
    assert g.table_width == 16
    c = SearchEngine(cfg, idx, device="cpu", key_table=g.key_table)
    before = dict(_build.LAUNCHES)
    got = g.fetch(g.search_refine_async_dna(dna, lens))
    assert _build.LAUNCHES["sort_rows_tiles"] == before["sort_rows_tiles"] + 1
    assert _build.LAUNCHES["sort_rows_kway"] == before["sort_rows_kway"] + 1
    assert _build.LAUNCHES["sort_vote_rank_rows"] == before[
        "sort_vote_rank_rows"]
    assert _build.LAUNCHES["chain_vote_rank_rows"] > before[
        "chain_vote_rank_rows"]
    want = c.fetch(c.search_refine_async_dna(dna, lens))
    np.testing.assert_array_equal(got, want)
    assert (got[1] >> 15).max() > 0


@pytest.mark.parametrize("shards,merge,tables", [
    (1, "1", "cap"), (1, "1", "csr"), (2, "0", "direct"),
    (2, "0", "csr"), (2, "1", "direct"),
])
def test_engine_cuda_equals_cpu_tables_and_shards(dev, tmp_path, monkeypatch,
                                                  shards, merge, tables):
    """The golden config-1 index with CSR seed tables (forced: a 1 KB
    direct-table cap, "cap", or a packed-value bound past int32), and at 2
    shards merged at init or through the per-shard loop: the (18, R, K)
    payload on CUDA equals the CPU engine's. The loop's select launches
    B4's 3-key rows, (3, 768, 16); a merged index launches none."""
    from ghostm_tpu_torch import engine as E
    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.io.fasta import read_batches

    gold = os.path.join(os.path.dirname(__file__), "golden")
    prefix = str(tmp_path / "idx")
    assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"), "-o",
                prefix, "--shards", str(shards)]) == 0
    monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", merge)
    if tables == "cap":
        monkeypatch.setattr(E, "DIRECT_TABLE_CAP", 1024)
    elif tables == "csr":
        monkeypatch.setattr(E, "_packed_value_bound", lambda *a: 1 << 40)
    idx = load_index(prefix)
    cfg = Config(query_batch=128)
    _, dna, lens = next(read_batches(os.path.join(gold, "config1_reads.fa"),
                                     128, 120))
    g = E.SearchEngine(cfg, idx, device="cuda")
    assert g.table_mode == ("csr" if tables == "cap" else tables)
    assert g.n_shards == (shards if merge == "0" else 1)
    c = E.SearchEngine(cfg, idx, device="cpu", key_table=g.key_table)
    _build.reset_launches()
    got = g.step_dna(torch.from_numpy(dna).to(dev),
                     torch.from_numpy(lens).to(dev), pack=False).cpu()
    select = _build.SHAPES[("lex_rank_rows", (3, 768, 16))]
    assert select == (1 if g.n_shards == 2 else 0)
    assert _build.LAUNCHES["sw_fused"] == g.n_shards
    want = c.step_dna(torch.from_numpy(dna), torch.from_numpy(lens),
                      pack=False)
    assert int(want[0].max()) > 0
    assert torch.equal(got, want)


def _golden_engines(tmp_path, monkeypatch=None, cap=False):
    """The config-1 golden index, one 128-read batch, a CUDA engine and a
    CPU engine on the same key tables (CSR ones with a 1 KB direct table
    cap)."""
    from ghostm_tpu_torch import engine as E
    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.io.fasta import read_batches

    if cap:
        monkeypatch.setattr(E, "DIRECT_TABLE_CAP", 1024)
    gold = os.path.join(os.path.dirname(__file__), "golden")
    prefix = str(tmp_path / "idx")
    assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"),
                "-o", prefix]) == 0
    idx = load_index(prefix)
    cfg = Config(query_batch=128)
    _, dna, lens = next(read_batches(os.path.join(gold, "config1_reads.fa"),
                                     128, 120))
    g = E.SearchEngine(cfg, idx, device="cuda")
    c = E.SearchEngine(cfg, idx, device="cpu", key_table=g.key_table)
    return g, c, dna, lens


@pytest.mark.parametrize("cap", [False, True])
def test_search_batch_checked_cuda(dev, tmp_path, monkeypatch, cap):
    """--check's pass on CUDA, through the kernels (B2, B3, B4 launch), on
    direct and on CSR tables: the hits equal the CPU engine's checked pass
    and the CUDA step's."""
    g, c, dna, lens = _golden_engines(tmp_path, monkeypatch, cap)
    assert g.table_mode == ("csr" if cap else "direct")
    q = g.translate(dna, lens)
    before = dict(_build.LAUNCHES)
    got = g.search_batch_checked(q)
    for k in ("sort_vote_rank_rows", "sw_fused", "lex_rank_rows"):
        assert _build.LAUNCHES[k] > before[k], k
    want = c.search_batch_checked(q)
    for f in ("score", "gsid", "frame", "qend", "s_end", "bend", "g0",
              "srow", "shard"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    step = g.fetch(g.search_packed(torch.from_numpy(q).to(dev)))
    np.testing.assert_array_equal(step[0], got.score)
    assert got.score.max() > 0


def test_hbm_log_keys_cuda(dev, tmp_path, monkeypatch):
    """GHOSTM_TPU_HBM_LOG on a CUDA engine: the JAX package's four keys,
    peak bytes > 0 and within the card's memory; the table is the
    golden's."""
    from ghostm_tpu_torch import pipeline
    from ghostm_tpu_torch.io.fasta import read_batches

    g, _, _, _ = _golden_engines(tmp_path)
    log_path = tmp_path / "hbm.json"
    monkeypatch.setenv("GHOSTM_TPU_HBM_LOG", str(log_path))
    gold = os.path.join(os.path.dirname(__file__), "golden")
    out = str(tmp_path / "hits.tsv")
    pipeline.run_search(g, read_batches(os.path.join(
        gold, "config1_reads.fa"), 32, 120), out)
    with open(out) as f, open(os.path.join(gold, "config1_hits.tsv")) as h:
        assert f.read() == h.read()
    with open(log_path) as f:
        got = json.load(f)
    assert tuple(sorted(got)) == tuple(sorted(pipeline.HBM_KEYS))
    assert 0 < got["bytes_in_use"] <= got["peak_bytes_in_use"] \
        <= got["bytes_limit"]
    assert 0 < got["largest_alloc_size"] <= got["peak_bytes_in_use"]


# One rank of a grid on the card: argv = coordinator, rank, data, db,
# index prefix, reads, directory; saves its whole-batch (18, R, K) payload.
GRID_RANK = r"""
import sys
import numpy as np
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.engine import SearchEngine
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.parallel import mesh as pm

coord, rank, data, db, prefix, n, d = sys.argv[1:8]
rank, data, db, n = int(rank), int(data), int(db), int(n)
pm.init_distributed(coord, data * db, rank, device="cuda")
mesh = pm.make_mesh(data, db)
eng = SearchEngine(Config(query_batch=128), load_index(prefix),
                   device=pm.rank_device("cuda", rank), mesh=mesh)
assert eng.device.type == "cuda"
qc = np.load(f"{d}/qcodes.npy")[:n]
hits, stats = eng.search_batch_stats(qc)
np.save(f"{d}/grid-r{rank}.npy", np.stack(
    [getattr(hits, f) for f in hits.__dataclass_fields__]
    + [stats[k] for k in eng.STAT_KEYS] + [stats["score_check"]]))
print(mesh.backend, flush=True)
"""


@pytest.mark.parametrize("data,db,reads", [
    (2, 1, 128), (1, 2, 128), (2, 1, 5),
])
def test_grid_cuda_equals_loop(dev, tmp_path, monkeypatch, data, db, reads):
    """A grid of ranks on the card (two ranks share one card over gloo;
    NCCL where each has its own): the whole batch on every rank equals
    the CUDA loop engine's (18, R, K) payload over the same index (the
    per-shard loop at 2 shards), 5 reads included (a tail batch the data
    axis does not divide)."""
    import subprocess
    import sys

    from ghostm_tpu_torch import engine as E
    from ghostm_tpu_torch.parallel import launch

    g, _, dna, lens = _golden_engines(tmp_path)
    prefix = str(tmp_path / "idx")
    if db == 2:
        from ghostm_tpu_torch.cli import main as cli
        from ghostm_tpu_torch.index.diskio import load_index

        gold = os.path.join(os.path.dirname(__file__), "golden")
        prefix = str(tmp_path / "idx2")
        assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"), "-o",
                    prefix, "--shards", "2"]) == 0
        monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", "0")
        g = E.SearchEngine(g.cfg, load_index(prefix), device="cuda")
        assert g.n_shards == 2
    qc = g.translate(dna, lens)
    np.save(tmp_path / "qcodes.npy", qc)
    want = g.fetch(g.search_refine_async(qc[:reads]))
    assert want[0].max() > 0
    procs = launch.start_ranks(
        lambda r, coord: [sys.executable, "-c", GRID_RANK, coord, str(r),
                          str(data), str(db), prefix, str(reads),
                          str(tmp_path)], data * db,
        stdout=subprocess.PIPE)
    assert launch.wait_ranks(procs, timeout=300) == 0
    for r in range(data * db):
        np.testing.assert_array_equal(np.load(tmp_path / f"grid-r{r}.npy"),
                                      want)


def test_grid_cli_golden_cuda(dev, tmp_path, monkeypatch):
    """`aln --device cuda --data-axis 1 --db-axis 2` over `db --shards 2`:
    two local ranks on the card write the config-1 golden, and each
    launched B2, B3 and B4 (GHOSTM_TPU_LAUNCH_COUNTS)."""
    from ghostm_tpu_torch.cli import main as cli

    gold = os.path.join(os.path.dirname(__file__), "golden")
    prefix = str(tmp_path / "idx2")
    assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"), "-o",
                prefix, "--shards", "2"]) == 0
    counts = str(tmp_path / "launches")
    monkeypatch.setenv("GHOSTM_TPU_LAUNCH_COUNTS", counts)
    out = str(tmp_path / "hits.tsv")
    assert cli(["aln", "-d", prefix, "-i", os.path.join(
        gold, "config1_reads.fa"), "-o", out, "--batch", "128",
        "--data-axis", "1", "--db-axis", "2"]) == 0
    with open(out) as f, open(os.path.join(gold, "config1_hits.tsv")) as h:
        assert f.read() == h.read()
    for r in range(2):
        with open(f"{counts}.r{r}.json") as f:
            got = json.load(f)["launches"]
        for k in ("sort_vote_rank_rows", "sw_fused", "lex_rank_rows"):
            assert got[k] > 0, (r, k)


def _refine_inputs(dev, R, K, lq, band, cfg):
    """refine_cases.make_case on the card, with the matrix and gap costs
    of CONFIGS[cfg]."""
    name, go, ge = CONFIGS[cfg]
    mat = torch.from_numpy(padded_matrix(name, hard_stop=True).astype(
        np.int32)).to(dev)
    case = (torch.from_numpy(a).to(dev)
            for a in make_case(lq * 1000 + band, R, K, lq, band))
    return (*case, mat, dict(band=band, gap_open=go, gap_extend=ge))


# the CPU test's shapes and configurations (tests/test_torch_refine.py),
# bands that leave a lane part-filled or empty, one hit, and the main
# path's shapes: 8192 reads x 10 hits at Lq 40 and 88 (100 and 250 bp
# reads), 128 x 10 at Lq 1728 band 64 (5 kbp), 8 x 8 and 64 x 10 at Lq
# 3456 band 128 (10 kbp); bands 80 and 96 at long frames (the warp
# layout's lanes past the band)
REFINE_CASES = [
    *((2, 8, lq, band, "b62") for lq, band in (
        (40, 32), (88, 32), (24, 16), (60, 64), (50, 128))),
    (1, 8, 300, 64, "b62"),
    *((2, 8, lq, band, c) for c in ("b50", "pam30", "open0", "ext0")
      for lq, band in ((40, 32), (60, 64))),
    (3, 7, 40, 1, "b62"), (3, 7, 40, 48, "b62"), (3, 7, 37, 80, "b50"),
    (3, 7, 41, 96, "open0"), (5, 9, 40, 18, "ext0"), (1, 1, 40, 32, "b62"),
    (8192, 10, 40, 32, "b62"), (8192, 10, 88, 32, "b50"),
    (128, 10, 1728, 64, "b62"), (8, 8, 3456, 128, "b62"),
    (64, 10, 3456, 128, "b62"), (16, 10, 700, 80, "b50"),
    (16, 10, 901, 96, "ext0"),
]
# the cases whose move plane is compared (the plain plane is N x Lq x band
# int32 tiles), and two of the main path's
REFINE_PLANE_CASES = [
    c for c in REFINE_CASES if c[0] * c[1] * c[2] * c[3] < 1 << 24
] + [(8192, 10, 40, 32, "b62"), (128, 10, 1728, 64, "b62")]


@pytest.mark.parametrize("R,K,lq,band,cfg", REFINE_CASES)
def test_refine_kernel(dev, R, K, lq, band, cfg):
    """Kernel R1 equals its plain version: all 9 rows, every hit kind of
    make_case, with the table built by the wrapper and passed in as the
    engine passes it."""
    q3, packed, w, lo, hi, mat, kw = _refine_inputs(dev, R, K, lq, band, cfg)
    want = refine.refine_stats_plain(q3, packed, mat, w, lo, hi, **kw)
    got = _launched("refine", lambda: refine.refine_stats(
        q3, packed, mat, w, lo, hi, **kw))
    assert torch.equal(got, want)
    tab = refine.score_table(mat)
    again = _launched("refine", lambda: refine.refine_stats(
        q3, packed, mat, w, lo, hi, table=tab, table_max=int(tab.max()),
        **kw))
    assert torch.equal(again, want)
    assert int(want[8].max()) > 0


@pytest.mark.parametrize("R,K,lq,band,cfg", REFINE_PLANE_CASES)
def test_refine_kernel_moves_plane(dev, R, K, lq, band, cfg):
    """The kernel's debug entry (the DP alone, no walk): its move plane
    equals sw_xla.sw_banded_moves' on every cell, and (score, i_end,
    b_end) too."""
    q3, packed, w, lo, hi, mat, kw = _refine_inputs(dev, R, K, lq, band, cfg)
    want = refine.moves_plain(q3, packed, mat, w, lo, hi, **kw)
    got = _launched("refine", lambda: refine.refine_moves(
        q3, packed, w, lo, hi, refine.score_table(mat), **kw))
    for g, x in zip(got, want):
        assert g.shape == x.shape and torch.equal(g.to(x.dtype), x)


@pytest.mark.parametrize("R,K,lq,band,cfg", REFINE_CASES)
def test_refine_kernel_layouts(dev, R, K, lq, band, cfg):
    """Kernel R1 in every layout it takes at the case's shape (the thread
    layout and the warp layout, forced through launch, whichever the rule
    would pick): all 9 rows equal to the plain version's, and on
    REFINE_PLANE_CASES the debug entry's move plane too, one launch each."""
    q3, packed, w, lo, hi, mat, kw = _refine_inputs(dev, R, K, lq, band, cfg)
    want = refine.refine_stats_plain(q3, packed, mat, w, lo, hi, **kw)
    tab = refine.score_table(mat)
    args = (q3, packed, w, lo, hi, tab)
    plane = (R, K, lq, band, cfg) in REFINE_PLANE_CASES
    want_moves = refine.moves_plain(q3, packed, mat, w, lo, hi, **kw) \
        if plane else ()
    opts = refine.layouts(lq, band)
    assert len(opts) == 2 and refine.layout(
        R * K, lq, band, refine.sm_count(q3.device)) in opts
    for lanes, diags in opts:
        got = _launched("refine", lambda: refine.launch(
            *args, table_max=int(tab.max()), walk=True, lanes=lanes,
            **kw)[0])
        assert torch.equal(got.view(want.shape), want), (lanes, diags)
        if plane:
            moves = _launched("refine", lambda: refine.refine_moves(
                *args, lanes=lanes, **kw))
            for g, x in zip(moves, want_moves):
                assert g.shape == x.shape and torch.equal(g.to(x.dtype), x)
    assert int(want[8].max()) > 0


def test_refine_never_plain_on_cuda(dev, tmp_path, monkeypatch):
    """With refine's plain functions made to raise, a CUDA engine batch,
    the config-1 golden through aln on CUDA and a grid of two ranks (each
    counting its launches) still give the CPU engine's stats and the
    golden: no CUDA path runs refine in plain torch, and the engine
    launches R1 once a batch."""
    from ghostm_tpu_torch.cli import main as cli

    g, c, dna, lens = _golden_engines(tmp_path)
    want = c.fetch(c.search_refine_async_dna(dna, lens))

    def boom(*a, **k):
        raise AssertionError("refine ran in plain torch on a CUDA path")

    for mod, name in ((refine, "refine_stats_plain"), (refine, "moves_plain"),
                      (sw_xla, "sw_banded_moves"),
                      (sw_xla, "traceback_stats_device")):
        monkeypatch.setattr(mod, name, boom)
    before = _build.LAUNCHES["refine"]
    got = g.fetch(g.search_refine_async_dna(dna, lens))
    assert _build.LAUNCHES["refine"] == before + 1
    np.testing.assert_array_equal(got, want)
    gold = os.path.join(os.path.dirname(__file__), "golden")
    reads = os.path.join(gold, "config1_reads.fa")
    before = _build.LAUNCHES["refine"]
    out = str(tmp_path / "hits.tsv")
    assert cli(["aln", "-d", str(tmp_path / "idx"), "-i", reads, "-o", out,
                "--device", "cuda", "--batch", "128"]) == 0
    with open(out) as f, open(os.path.join(gold, "config1_hits.tsv")) as h:
        assert f.read() == h.read()
    assert _build.LAUNCHES["refine"] > before
    counts = str(tmp_path / "launches")
    monkeypatch.setenv("GHOSTM_TPU_LAUNCH_COUNTS", counts)
    out = str(tmp_path / "grid.tsv")
    assert cli(["aln", "-d", str(tmp_path / "idx"), "-i", reads, "-o", out,
                "--device", "cuda", "--batch", "128", "--data-axis",
                "2"]) == 0
    with open(out) as f, open(os.path.join(gold, "config1_hits.tsv")) as h:
        assert f.read() == h.read()
    for r in range(2):
        with open(f"{counts}.r{r}.json") as f:
            assert json.load(f)["launches"]["refine"] > 0, r


# ---------------------------------------------------------------------------
# The step's CUDA graphs (engine.py): the graphed step against the eager one

def _revcomp(seq: bytes) -> bytes:
    return seq[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


def _graph_case(case, tmp_path, monkeypatch):
    """(CUDA engine, batches) of a graphed-step case, every batch's reads
    distinct and the last batch a tail the engine pads: the config-1
    golden in batches of 16 (6 and a tail of 4) on a one-shard direct
    index ("direct"), on a 2-shard CSR index through the per-shard loop
    ("csr2"), and on BLOSUM50 through B5 ("b5") and B6 ("b6", 72-residue
    frames); the long-read golden's config ("longread": k = 4 with a
    poly-A subject, so B1's long rows and the chained vote) on its 5 reads,
    their reverse complements and their first 3,000 bp, in batches of 2
    (7 and a tail of 1)."""
    from ghostm_tpu_torch import engine as E
    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.io.fasta import iter_fasta, read_batches

    gold = os.path.join(os.path.dirname(__file__), "golden")
    prefix = str(tmp_path / "idx")
    if case == "longread":
        db = tmp_path / "db.fa"
        with open(os.path.join(gold, "longread_db.fa")) as f:
            db.write_text(f.read() + ">polyA\n" + "A" * 40 + "\n")
        assert cli(["db", "-i", str(db), "-o", prefix, "-k", "4"]) == 0
        with open(os.path.join(gold, "longread_cfg.json")) as f:
            cfg = Config(**dict(json.load(f), query_batch=2))
        seqs = [s for _, s in iter_fasta(os.path.join(
            gold, "longread_reads.fa"))]
        reads = tmp_path / "reads.fa"
        reads.write_text("".join(
            f">r{i}\n{s.decode()}\n" for i, s in enumerate(
                seqs + [_revcomp(s) for s in seqs] + [s[:3000]
                                                      for s in seqs])))
        reads, max_len = str(reads), 5300
    else:
        shards = 2 if case == "csr2" else 1
        assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"), "-o",
                    prefix, "--shards", str(shards)]) == 0
        if case == "csr2":
            monkeypatch.setenv("GHOSTM_TPU_MERGE_COLOCATED", "0")
            monkeypatch.setattr(E, "_packed_value_bound", lambda *a: 1 << 40)
        b50 = dict(matrix="BLOSUM50", gap_open=13, gap_extend=2)
        kw = {"b5": b50, "b6": dict(b50, query_frame_len=72)}.get(case, {})
        cfg = Config(query_batch=16, **kw)
        reads, max_len = os.path.join(gold, "config1_reads.fa"), 120
    g = E.SearchEngine(cfg, load_index(prefix), device="cuda")
    if case == "csr2":
        assert (g.table_mode, g.n_shards) == ("csr", 2)
    batches = [(dna[:len(names)], lens[:len(names)])
               for names, dna, lens in read_batches(reads, cfg.query_batch,
                                                    max_len)]
    assert len(batches) >= 7 and len(batches[-1][0]) < cfg.query_batch
    return g, batches


def _counted(fn):
    """fn()'s result and the launches it counted, by wrapper and by
    (wrapper, shapes)."""
    l0, s0 = Counter(_build.LAUNCHES), Counter(_build.SHAPES)
    out = fn()
    return out, Counter(_build.LAUNCHES) - l0, _build.SHAPES - s0


@pytest.mark.parametrize("case,kernel", [
    ("direct", "sw_fused"), ("csr2", "sort_vote_rank_rows"),
    ("b5", "sw_scored"), ("b6", "sw_wave"), ("longread", "sort_rows_tiles"),
])
def test_graphed_step_equals_eager(dev, tmp_path, monkeypatch, case, kernel):
    """The step through search_refine_async_dna on a CUDA engine: batch 0
    eager, batch 1 captures the stages, every later batch replays them.
    Every batch's payload equals the eager step's (the same engine with
    the graph rule off), fetched only after every later batch has
    replayed (the clone), and every batch counts the eager step's
    launches, by wrapper and by shape (the case's kernel in each)."""
    from ghostm_tpu_torch import engine as E

    g, batches = _graph_case(case, tmp_path, monkeypatch)
    n = len(E.GRAPH_STAGES)
    graphed, stages = [], []
    for dna, lens in batches:
        graphed.append(_counted(
            lambda: g.search_refine_async_dna(dna, lens)))
        stages.append(g.last_graph_stages)
    assert stages == [0] + [n] * (len(batches) - 1)
    assert (g.graph_captures, g.graph_eager) == (n, n)
    assert g.graph_replays == n * (len(batches) - 1)
    with monkeypatch.context() as m:
        m.setattr(E, "graphs_device", lambda d: False)
        eager = [_counted(lambda: g.search_refine_async_dna(dna, lens))
                 for dna, lens in batches]
    assert g.graph_replays == n * (len(batches) - 1)
    hits = 0
    for i, ((p, gl, gs), (q, el, es)) in enumerate(zip(graphed, eager)):
        want = g.fetch(q)
        np.testing.assert_array_equal(g.fetch(p), want, err_msg=str(i))
        assert gl == el and gs == es, i
        assert gl[kernel] > 0, i
        hits += int((want[1] >> 15).astype(bool).sum())
    assert hits > 0


def test_graphed_goldens_cli(dev, tmp_path):
    """The three goldens through `aln` on CUDA in batches small enough
    that all but the first two replay the step's graphs: byte for byte."""
    from ghostm_tpu_torch.cli import main as cli

    gold = os.path.join(os.path.dirname(__file__), "golden")
    idx, lr = str(tmp_path / "idx"), str(tmp_path / "lr")
    assert cli(["db", "-i", os.path.join(gold, "config1_db.fa"), "-o",
                idx]) == 0
    cfg = os.path.join(gold, "longread_cfg.json")
    assert cli(["db", "-i", os.path.join(gold, "longread_db.fa"), "-o", lr,
                "--config", cfg]) == 0
    reads = os.path.join(gold, "config1_reads.fa")
    for tag, args, want in (
            ("b62", ["-d", idx, "-i", reads, "--batch", "16"],
             "config1_hits.tsv"),
            ("b50", ["-d", idx, "-i", reads, "--batch", "16", "--matrix",
                     "BLOSUM50", "--gap-open", "13", "--gap-extend", "2"],
             "config1_b50_hits.tsv"),
            ("lr", ["-d", lr, "-i", os.path.join(gold, "longread_reads.fa"),
                    "--config", cfg, "--max-read-len", "5300", "--batch",
                    "1"], "longread_hits.tsv")):
        out = str(tmp_path / f"{tag}.tsv")
        chained = _build.LAUNCHES["chain_vote_rank_rows"]
        assert cli(["aln", *args, "-o", out, "--device", "cuda"]) == 0, tag
        with open(out) as f, open(os.path.join(gold, want)) as h:
            assert f.read() == h.read(), tag
        # the long-read golden's chained vote runs on kernel R2
        assert (_build.LAUNCHES["chain_vote_rank_rows"] > chained) == (
            tag == "lr"), tag


@pytest.mark.parametrize("what", ["sort_rows", "merge_vote"])
def test_kernels_capture_above_48k_smem(dev, what):
    """B1 and B2's merge entry at 16,384-key rows (64 KB of shared memory:
    the launch opts in past the 48 KB default, csrc/bitonic.cuh) captured
    into a CUDA graph and replayed on new keys: the plain version's rows."""
    gen = torch.Generator().manual_seed(7)
    if what == "sort_rows":
        x = _keys(gen, 16, 16384, 128, 1 << 20, dev)
        fn = lambda: S.sort_rows(x, presorted_run=128)   # noqa: E731
        plain = lambda: S.sort_rows_plain(x, presorted_run=128)  # noqa
    else:
        a = torch.sort(_keys(gen, 16, 8192, 1, 1 << 12, dev), 1).values
        b = torch.sort(_keys(gen, 16, 2048, 1, 1 << 12, dev), 1).values
        fn = lambda: S.merge_vote_rank_rows(a, b, 8, 2)   # noqa: E731
        plain = lambda: S.merge_vote_rank_rows_plain(a, b, 8, 2)  # noqa
    fn()                                    # warm-up, outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        srcs = [x] if what == "sort_rows" else [a, b]
        for t in srcs:
            fresh = _keys(gen, t.shape[0], t.shape[1], 128 if what ==
                          "sort_rows" else 1, 1 << 12, dev)
            t.copy_(fresh if what == "sort_rows"
                    else torch.sort(fresh, 1).values)
        graph.replay()
        torch.cuda.synchronize()
        want = plain()
        for o, w in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(o, w)
