"""Row sorts of the propose and rank phases: kernels B1, B2 and B4.

Each wrapper takes int32 tensors. A CPU tensor goes through the plain
PyTorch version beside it; a CUDA tensor launches the hand-written kernel
(csrc/sort_rows.cu, csrc/sort_vote.cu, csrc/merge_vote.cu,
csrc/lex_rank.cu, csrc/chain_vote.cu) or raises. Both give the same
integers: an integer sort's output is unique, and the kernels'
tie-breaks are the plain versions' tie-breaks.

  B1 sort_rows             ascending sort of each row (torch.sort); rows
                           past TILE keys as tiles, then one k-way merge
  B2 sort_vote_rank_rows   sort + run-length vote + top-ncand per row
     merge_vote_rank_rows  the same over the union of two sorted halves
  B4 lex_rank_rows         stable lexicographic multi-operand row sort,
                           first topk columns
  R2 chain_vote_rank_rows  run-length vote + collinear chain scores +
                           top-ncand of each sorted row (long-read mode)

Caller contract (the JAX package's kernels/sort.py): invalid vote keys are
>= BIG = 2^30 and sort to the row's tail; B1 and B2 pad rows to a power of
two >= 128 with PAD = INT32_MAX (B1's long rows: their last tile only, in
shared memory).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ghostm_tpu_torch.kernels import _build

PAD = 0x7FFFFFFF
BIG = 1 << 30          # first invalid key value (matches candidates.BIG)
_LANES = 128           # the top-ncand output width of the JAX kernel
# bytes of one row in shared memory for B2's entries: above the 48 KB
# default the CUDA launch opts in (csrc/bitonic.cuh row_smem_ok); 16384 keys
# cover the merge row of 88-residue frames (84 k-mer positions x 128-wide
# table rows)
MAX_SMEM_ROW = 64 << 10
# B1's longest one-block row; longer rows sort as tiles of TILE keys, then
# merge in one k-way launch (csrc/sort_rows.cu)
TILE = 1 << 14
# B1's k-way merge (csrc/sort_rows.cu): its compile-time geometry
# (_build.DEFINES), and KWAY_KEYS keys a merge block on average
KWAY_MAX, KWAY_SAMPLES, KWAY_SMEM = (
    _build.DEFINES["sort_rows"][k]
    for k in ("KWAY_MAX", "KWAY_SAMPLES", "KWAY_SMEM"))
KWAY_KEYS = 7168
# B4's keys and index: (num_keys + 1) x L int32 of shared memory, up to an
# H100 block's 227 KB opt-in (csrc/lex_rank.cu)
LEX_SMEM_ROW = 227 << 10

_P = ctypes.c_void_p
_I = ctypes.c_int


def _row_len(M: int) -> int:
    """Power-of-two padded row length, >= 128 (sort.py's L)."""
    return max(1 << max(M - 1, 1).bit_length(), _LANES)


def _check_run(M: int, presorted_run: int) -> int:
    run = max(presorted_run, 1)
    if run & (run - 1) or (run > 1 and M % run):
        raise ValueError(f"presorted_run={presorted_run} invalid for M={M}")
    return run


def _aligned(*xs: torch.Tensor) -> bool:
    """Rows of every x start on 16 bytes: the kernels' int4 accesses."""
    return all(x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0 for x in xs)


def _check_cuda(*xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous int32, got "
                             f"{x.dtype} contiguous={x.is_contiguous()}")
        if x.device != xs[0].device:
            raise ValueError("kernel inputs must share one device")


def _check_row_smem(L: int, arrays: int = 1,
                    limit: int = MAX_SMEM_ROW) -> None:
    if L * 4 * arrays > limit:
        raise NotImplementedError(
            f"row length {L} x {arrays} int32 arrays exceeds {limit >> 10} "
            "KB of shared memory per block"
        )


# ---------------------------------------------------------------------------
# plain run-length vote, collinear chaining and neighbour-bin smoothing
# (candidates._per_query)
# ---------------------------------------------------------------------------

NEGC = -(1 << 30)      # the chain scan's minus infinity


def _shift_in(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x moved d columns right, the first d columns `fill`."""
    head = torch.full((x.shape[0], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:, :-d]], dim=1)


def _chain(k, votes, first, valid, nbins: int, gamma: int):
    """Collinear chain scores C[i] = votes[i] + max(0, max over earlier runs
    j of the same subject row of C[j] - gamma * (k[i] - k[j])), as the
    first-order (max, +) recurrence RM[i] = max(votes[i] + gamma k[i],
    RM[i-1] + votes[i]) solved by a segmented Hillis-Steele scan of
    log2(M) steps, segmented where the subject row changes. gamma * k
    wraps int32 at invalid (BIG) keys: they are zeroed first, which
    changes no value the reference keeps (it masks them after)."""
    Q, M = k.shape
    zero = torch.zeros_like(k)
    kv = torch.where(valid, k, zero)
    row = k // nbins              # invalid (BIG) rows segment alone
    A = torch.where(valid, votes + gamma * kv, torch.full_like(k, NEGC))
    B = votes
    F = torch.cat([torch.ones((Q, 1), dtype=torch.bool, device=k.device),
                   row[:, 1:] != row[:, :-1]], dim=1)
    d = 1
    while d < M:
        As, Bs, Fs = _shift_in(A, d, NEGC), _shift_in(B, d, 0), \
            _shift_in(F, d, True)
        A = torch.maximum(A, torch.where(F, NEGC, As + B))
        B = torch.where(F, B, Bs + B)
        F = F | Fs
        d *= 2
    same_seg = torch.cat([torch.zeros((Q, 1), dtype=torch.bool,
                                      device=k.device),
                          row[:, 1:] == row[:, :-1]], dim=1)
    rm_ex = torch.where(same_seg, _shift_in(A, 1, NEGC), NEGC)
    chained = votes + (rm_ex - gamma * kv).clamp_min(0)
    return torch.where(first, chained, zero)


def _smooth(k, votes, first, bnd, idx, next_start, nbins: int):
    """Each run start also takes the votes of the runs of key +- 1 (the
    same subject row's neighbour bins, adjacent in sorted order; a bin at
    0 or nbins - 1 has no neighbour across the row)."""
    M = k.shape[1]
    zero = torch.zeros_like(k)
    rep_idx = torch.cummax(torch.where(bnd, idx, zero), dim=1).values
    nxt = next_start.clamp(0, M - 1).long()
    prv = torch.gather(rep_idx, 1, (rep_idx - 1).clamp(0, M - 1).long()
                       ).long()
    b = k % nbins
    add_n = torch.where((torch.gather(k, 1, nxt) == k + 1) & (b + 1 < nbins),
                        torch.gather(votes, 1, nxt), zero)
    add_p = torch.where((torch.gather(k, 1, prv) == k - 1) & (b > 0),
                        torch.gather(votes, 1, prv), zero)
    return votes + torch.where(first, add_n + add_p, zero)


def vote_top(k: torch.Tensor, ncand: int, min_votes: int,
             nbins: int = 1 << 20, smooth: bool = False,
             chain_gamma: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """k: (Q, M) int32 packed (row * nbins + bin) hit keys, each row SORTED
    ascending (invalid = BIG and above, at the tail). Returns (keys,
    votes), each (Q, ncand) int32, by (votes desc, key asc); key BIG where
    votes == 0. The order of the reference: run-length votes, the chain
    (chain_gamma > 0), smoothing, min_votes, the top ncand. Row-batched
    port of the JAX package's candidates._per_query."""
    Q, M = k.shape
    dev = k.device
    valid = k < BIG
    first = torch.cat([valid[:, :1], (k[:, 1:] != k[:, :-1]) & valid[:, 1:]],
                      dim=1)
    idx = torch.arange(M, dtype=torch.int32, device=dev).expand(Q, M)
    # next run boundary per position; invalid positions are boundaries too
    bnd = first | ~valid
    big = torch.full_like(k, BIG)
    s_next = torch.cat([torch.where(bnd, idx, big)[:, 1:],
                        torch.full((Q, 1), M, dtype=torch.int32, device=dev)],
                       dim=1)
    next_start = torch.flip(torch.cummin(torch.flip(s_next, [1]), 1).values,
                            [1])
    zero = torch.zeros_like(k)
    votes = torch.where(first, next_start - idx, zero)
    if chain_gamma > 0:
        votes = _chain(k, votes, first, valid, nbins, chain_gamma)
    if smooth:
        votes = _smooth(k, votes, first, bnd, idx, next_start, nbins)
    votes = torch.where(votes >= min_votes, votes, zero)
    rows = torch.arange(Q, device=dev)
    top_keys, top_votes = [], []
    shift = M.bit_length()
    if 2 * shift > 31:
        # (votes << shift | idx) overflows int32: two reductions per pick
        vcur = votes
        for _ in range(ncand):
            v = vcur.max(dim=1).values
            i = torch.where(vcur == v[:, None], idx,
                            torch.full_like(idx, M - 1)).min(dim=1).values
            top_votes.append(v)
            top_keys.append(torch.where(v > 0, k[rows, i.long()],
                                        torch.full_like(v, BIG)))
            vcur = torch.where(idx == i[:, None], zero, vcur)
        return torch.stack(top_keys, 1), torch.stack(top_votes, 1)
    # pack = (votes, M-1-idx): max picks (votes desc, idx asc); run starts
    # are key-ascending in idx, so idx asc == key asc
    pk = (votes << shift) | (M - 1 - idx)
    mask = (1 << shift) - 1
    for _ in range(ncand):
        m = pk.max(dim=1).values
        v = m >> shift
        i = (M - 1) - (m & mask)
        top_votes.append(v)
        top_keys.append(torch.where(v > 0, k[rows, i.long()],
                                    torch.full_like(v, BIG)))
        pk = torch.where(idx == i[:, None], zero, pk)
    return torch.stack(top_keys, 1), torch.stack(top_votes, 1)


# ---------------------------------------------------------------------------
# R2: the chained vote (vote_top with chain_gamma > 0, no smoothing)
# ---------------------------------------------------------------------------

CHAIN_NCAND = 32       # R2's widest top-ncand (csrc/chain_vote.cu)
CHAIN_PART = 1 << 14   # R2's keys of a row a block (csrc/chain_vote.cu)


def chain_vote_rank_rows(k: torch.Tensor, ncand: int, min_votes: int,
                         nbins: int, chain_gamma: int):
    """vote_top(k, ncand, min_votes, nbins, smooth=False, chain_gamma) of a
    (Q, M) int32 array of rows sorted ascending (invalid keys >= BIG at
    the tail): (keys, votes), each (Q, ncand) int32, by (votes desc, key
    asc), key BIG where votes == 0. A CUDA tensor launches kernel R2
    (csrc/chain_vote.cu: a block a CHAIN_PART-key stretch of a row, cut
    where the subject row changes, read once; the row's last block merges
    the blocks' top lists), equal to the plain version wherever chain_gamma
    * key + M < 2^31 for every valid key (candidates.vote_and_rank's
    check), or raises. Replaces the JAX package's chain in
    kernels/candidates.py::_per_query (XLA)."""
    if k.device.type == "cpu":
        return vote_top(k, ncand, min_votes, nbins=nbins,
                        chain_gamma=chain_gamma)
    Q, M = k.shape
    if not 1 <= ncand <= CHAIN_NCAND:
        raise ValueError(f"ncand={ncand} not in [1, {CHAIN_NCAND}] "
                         "(kernel R2's top lists)")
    if chain_gamma < 1 or nbins < 1:
        raise ValueError(f"chain_gamma={chain_gamma} and nbins={nbins} "
                         "must be >= 1")
    _check_cuda(k)
    keys = torch.empty((Q, ncand), dtype=torch.int32, device=k.device)
    votes = torch.empty_like(keys)
    if Q == 0:
        return keys, votes
    parts = max(-(-M // CHAIN_PART), 1)
    lists = torch.empty((Q, parts, ncand), dtype=torch.int64,
                        device=k.device)
    done = torch.zeros((Q, 3), dtype=torch.int32, device=k.device)
    lib = _build.load("chain_vote")
    fn = lib.ghostm_chain_vote_rows
    fn.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    fn.restype = _I
    _build.check(fn(k.data_ptr(), Q, M, nbins, chain_gamma, ncand, min_votes,
                    int(_aligned(k)), CHAIN_PART, lists.data_ptr(),
                    done.data_ptr(), keys.data_ptr(), votes.data_ptr(),
                    _build.stream_ptr(k.device)), "chain_vote_rank_rows")
    _build.count("chain_vote_rank_rows", k.shape)
    return keys, votes


# ---------------------------------------------------------------------------
# B1: row sort
# ---------------------------------------------------------------------------

def sort_rows_plain(x: torch.Tensor, presorted_run: int = 0) -> torch.Tensor:
    _check_run(x.shape[1], presorted_run)
    return torch.sort(x, dim=1).values


def sort_rows(x: torch.Tensor, presorted_run: int = 0) -> torch.Tensor:
    """Ascending sort of each row of a (Q, M) int32 array; equals
    torch.sort(x, 1). presorted_run = 2^p > 1: the caller guarantees every
    aligned 2^p block of a row is sorted ascending for even block index
    and descending for odd (the state after bitonic stage p), so the
    kernel starts at stage p + 1. Rows of up to TILE keys sort in one
    block; longer ones (long reads) in tiles, then one k-way merge
    (_sort_rows_long). Replaces the JAX package's
    kernels/sort.py::sort_rows (Pallas _sort_kernel)."""
    if x.device.type == "cpu":
        return sort_rows_plain(x, presorted_run)
    Q, M = x.shape
    run = _check_run(M, presorted_run)
    L = _row_len(M)
    _check_cuda(x)
    out = torch.empty_like(x)
    if Q == 0:
        return out
    if L > TILE:
        return _sort_rows_long(x, out, run)
    lib = _build.load("sort_rows")
    fn = lib.ghostm_sort_rows
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    _build.check(fn(x.data_ptr(), out.data_ptr(), Q, M, L, run.bit_length(),
                    int(_aligned(x, out)), _build.stream_ptr(x.device)),
                 "sort_rows")
    _build.count("sort_rows", x.shape)
    return out


def _kway_shape(M: int, width: int) -> Tuple[int, int, int, int]:
    """(K, g, nb, shared bytes) of the k-way merge of rows of M keys in
    sorted runs of `width`: K runs, g samples a bucket (one sample every
    width / KWAY_SAMPLES keys), nb buckets a row, and the shared memory of
    its merge block, which holds a bucket's (g + K) x S keys at most
    (csrc/sort_rows.cu ghostm_merge_kway)."""
    K = -(-M // width)
    S = width // KWAY_SAMPLES
    g = max(1, KWAY_KEYS // S)
    ns = (K - 1) * KWAY_SAMPLES + -(-(M - (K - 1) * width) // S)
    cap = (g + K) * S
    return K, g, -(-ns // g), 2 * 4 * (cap + 1)


def long_plan(M: int) -> Tuple[int, int]:
    """B1's launches after the tile sort of rows of M > TILE keys: (pairwise
    merge passes, k-way merges). Up to KWAY_MAX tiles one k-way launch
    merges them all; more take pairwise passes until KWAY_MAX runs remain,
    then the k-way launch, while its block fits in shared memory (rows of
    up to 336 tiles, 5.5 M keys); longer rows merge pairwise to the end."""
    tiles = -(-M // TILE)
    passes = (-(-tiles // KWAY_MAX) - 1).bit_length()
    if _kway_shape(M, TILE << passes)[3] <= KWAY_SMEM:
        return passes, 1
    return (tiles - 1).bit_length(), 0


def _sort_rows_long(x: torch.Tensor, out: torch.Tensor,
                    run: int) -> torch.Tensor:
    """B1 at rows longer than one block holds (M > TILE): one launch
    sorts every TILE-key tile of every row with the L = TILE network
    (the last tile of a row padded in shared memory only) and writes
    KWAY_SAMPLES samples of each, then one k-way launch merges all of a
    row's tiles (csrc/sort_rows.cu: a split kernel cuts each row at
    samples, a merge kernel merges each bucket's slices in shared
    memory): two trips through device memory. Rows of more than KWAY_MAX
    tiles take pairwise merge passes first (long_plan). The launches
    alternate between `out` and a scratch row array, the last into `out`.
    Counts: "sort_rows_tiles" once; "sort_rows_merge" once a merge
    launch, pairwise or k-way (the merge stage of the long rows);
    "sort_rows_kway" once a k-way launch, shape (Q, M, K)."""
    Q, M = x.shape
    passes, kway = long_plan(M)
    # a tile inside one presorted run is all ascending or all descending,
    # not a bitonic stage's input: sort it from stage 1
    first = run.bit_length() if run < TILE else 1
    tmp = torch.empty_like(x)
    src = out if (passes + kway) % 2 == 0 else tmp
    dst = tmp if src is out else out
    vec = int(_aligned(x, out, tmp))
    smp = _sort_tiles(x, src, first, vec, bool(kway) and not passes)
    merge_fn = _build.load("sort_rows").ghostm_merge_pass
    merge_fn.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    merge_fn.restype = _I
    width = TILE
    for _ in range(passes):
        _build.check(merge_fn(src.data_ptr(), dst.data_ptr(), Q, M, width,
                              vec, _build.stream_ptr(x.device)),
                     "sort_rows (merge pass)")
        _build.count("sort_rows_merge", x.shape, (width,))
        src, dst = dst, src
        width *= 2
    if kway:
        _merge_kway(src, dst, width, smp, vec)
    return out


def _sort_tiles(x: torch.Tensor, dst: torch.Tensor, first: int, vec: int,
                samples: bool):
    """B1's tile launch: every TILE-key tile of x's rows sorted into dst;
    returns the tiles' samples ((Q, tiles, KWAY_SAMPLES) int32) when
    asked, else None."""
    Q, M = x.shape
    smp = (torch.empty((Q, -(-M // TILE), KWAY_SAMPLES), dtype=torch.int32,
                       device=x.device) if samples else None)
    fn = _build.load("sort_rows").ghostm_sort_tiles
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P]
    fn.restype = _I
    _build.check(fn(x.data_ptr(), dst.data_ptr(), Q, M, first, vec,
                    None if smp is None else smp.data_ptr(),
                    _build.stream_ptr(x.device)), "sort_rows (tiles)")
    _build.count("sort_rows_tiles", x.shape)
    return smp


def _merge_kway(src: torch.Tensor, dst: torch.Tensor, width: int, smp,
                vec: int) -> None:
    """B1's k-way launch: rows of src, sorted runs of `width` keys, merged
    into dst; smp: _sort_tiles' samples (width TILE), or None to read the
    runs' samples in place."""
    Q, M = src.shape
    K, g, nb, _ = _kway_shape(M, width)
    cuts = torch.empty((Q, nb + 1, K), dtype=torch.int32, device=src.device)
    fn = _build.load("sort_rows").ghostm_merge_kway
    fn.argtypes = [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    _build.check(fn(src.data_ptr(), dst.data_ptr(), Q, M, width,
                    None if smp is None else smp.data_ptr(), cuts.data_ptr(),
                    g, nb, vec, _build.stream_ptr(src.device)),
                 "sort_rows (k-way merge)")
    _build.count("sort_rows_merge", src.shape, (width, K))
    _build.count("sort_rows_kway", (Q, M, K))


# ---------------------------------------------------------------------------
# B2: fused sort + vote + top-ncand (monolithic and merge entries)
# ---------------------------------------------------------------------------

def _check_vote(L: int, ncand: int) -> None:
    if 2 * L.bit_length() > 31:
        raise ValueError(f"row length {L} overflows packed in-kernel top-k")
    if ncand > _LANES:
        raise ValueError(f"ncand={ncand} exceeds kernel lane width {_LANES}")


def sort_vote_rank_rows_plain(x, ncand: int, min_votes: int,
                              presorted_run: int = 0):
    Q, M = x.shape
    _check_run(M, presorted_run)
    _check_vote(_row_len(M), ncand)
    return vote_top(torch.sort(x, dim=1).values, ncand, min_votes)


def sort_vote_rank_rows(x: torch.Tensor, ncand: int, min_votes: int,
                        presorted_run: int = 0):
    """Fused sort + run-length vote + top-ncand of each row of a (Q, M)
    int32 key array (invalid keys >= BIG). Returns (top_keys, top_votes),
    each (Q, ncand) int32. The kernel sorts with B1's register network and
    votes as the merge entry does. Replaces
    kernels/sort.py::sort_vote_rank_rows (Pallas _sort_vote_kernel,
    monolithic entry)."""
    if x.device.type == "cpu":
        return sort_vote_rank_rows_plain(x, ncand, min_votes, presorted_run)
    Q, M = x.shape
    run = _check_run(M, presorted_run)
    L = _row_len(M)
    _check_vote(L, ncand)
    _check_cuda(x)
    _check_row_smem(L)
    keys = torch.empty((Q, ncand), dtype=torch.int32, device=x.device)
    votes = torch.empty_like(keys)
    if Q == 0:
        return keys, votes
    first = min(run.bit_length(), L.bit_length())
    lib = _build.load("sort_vote")
    fn = lib.ghostm_sort_vote_rows
    fn.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    _build.check(fn(x.data_ptr(), Q, M, L, first, int(_aligned(x)), ncand,
                    min_votes, keys.data_ptr(), votes.data_ptr(),
                    _build.stream_ptr(x.device)), "sort_vote_rank_rows")
    _build.count("sort_vote_rank_rows", x.shape)
    return keys, votes


def _check_merge(La: int, Mb: int) -> None:
    if Mb > La or La & (La - 1) or La < _LANES:
        raise ValueError(f"merge needs pow2 La >= {_LANES} >= Mb; "
                         f"got La={La} Mb={Mb}")


def merge_vote_rank_rows_plain(a, b, ncand: int, min_votes: int):
    La, Mb = a.shape[1], b.shape[1]
    _check_merge(La, Mb)
    _check_vote(2 * La, ncand)
    return vote_top(torch.sort(torch.cat([a, b], dim=1), dim=1).values,
                    ncand, min_votes)


def merge_vote_rank_rows(a: torch.Tensor, b: torch.Tensor, ncand: int,
                         min_votes: int):
    """Vote + top-ncand over the UNION of two row-sorted key arrays:
    a (Q, La) with La a power of two >= 128, b (Q, Mb) with Mb <= La.
    The kernel merges the valid prefixes of a and b (merge path) and
    counts the runs as it merges. Replaces
    kernels/sort.py::merge_vote_rank_rows (Pallas _sort_vote_kernel,
    merge entry)."""
    if a.device.type == "cpu":
        return merge_vote_rank_rows_plain(a, b, ncand, min_votes)
    Q, La = a.shape
    Mb = b.shape[1]
    _check_merge(La, Mb)
    L = 2 * La
    _check_vote(L, ncand)
    _check_cuda(a, b)
    if b.shape[0] != Q:
        raise ValueError(f"row counts differ: {Q} vs {b.shape[0]}")
    _check_row_smem(L)
    keys = torch.empty((Q, ncand), dtype=torch.int32, device=a.device)
    votes = torch.empty_like(keys)
    if Q == 0:
        return keys, votes
    lib = _build.load("merge_vote")
    fn = lib.ghostm_merge_vote_rows
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    vec = int(_aligned(a)) | 2 * int(_aligned(b))
    _build.check(fn(a.data_ptr(), b.data_ptr(), Q, La, Mb, ncand, min_votes,
                    vec, keys.data_ptr(), votes.data_ptr(),
                    _build.stream_ptr(a.device)), "merge_vote_rank_rows")
    _build.count("merge_vote_rank_rows", a.shape, b.shape)
    return keys, votes


# ---------------------------------------------------------------------------
# B4: stable lexicographic multi-operand rank
# ---------------------------------------------------------------------------

def lex_rank_rows_plain(ops: torch.Tensor, num_keys: int, topk: int):
    """Stable sort by keys ops[0..num_keys), last key first: each pass is a
    stable torch.sort over the permutation so far, so the original column
    breaks full-key ties."""
    nops, Q, M = ops.shape
    topk = min(topk, M)
    perm = torch.arange(M, device=ops.device).expand(Q, M)
    for key in reversed(range(num_keys)):
        vals = torch.gather(ops[key], 1, perm)
        order = torch.sort(vals, dim=1, stable=True).indices
        perm = torch.gather(perm, 1, order)
    perm = perm[:, :topk]
    return torch.stack([torch.gather(op, 1, perm) for op in ops])


def lex_rank_rows(ops: torch.Tensor, num_keys: int, topk: int) -> torch.Tensor:
    """ops: (nops, Q, M) int32. Sorts each row ascending-lexicographically
    on ops[0..num_keys) with the original column as the final key, and
    returns the first min(topk, M) columns of every operand:
    (nops, Q, min(topk, M)). The kernel ranks on the keys and the index
    alone (shared memory: num_keys + 1 arrays of L) and fetches the
    winners' columns. Replaces kernels/sort.py::lex_rank_rows (Pallas
    _lex_rank_kernel)."""
    if ops.device.type == "cpu":
        return lex_rank_rows_plain(ops, num_keys, topk)
    nops, Q, M = ops.shape
    if not 1 <= num_keys <= nops:
        raise ValueError(f"num_keys={num_keys} not in [1, {nops}]")
    topk = min(topk, M)
    L = 1 << max(M - 1, 1).bit_length()   # 48 -> 64: no 128-lane floor here
    _check_cuda(ops)
    _check_row_smem(L, num_keys + 1, limit=LEX_SMEM_ROW)
    out = torch.empty((nops, Q, topk), dtype=torch.int32, device=ops.device)
    if Q == 0:
        return out
    lib = _build.load("lex_rank")
    fn = lib.ghostm_lex_rank_rows
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    _build.check(fn(ops.data_ptr(), out.data_ptr(), nops, Q, M, L, num_keys,
                    topk, _build.stream_ptr(ops.device)), "lex_rank_rows")
    _build.count("lex_rank_rows", ops.shape)
    return out
