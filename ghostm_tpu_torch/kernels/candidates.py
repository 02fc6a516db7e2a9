"""Diagonal voting + candidate proposal (port of the JAX package's
kernels/candidates.py, SURVEY.md §2 "Diagonal voting").

Every hit is keyed by (subject row, SUBJECT-LOCAL diagonal bin) packed into
one int32 (row * nbins + bin); votes are counted scatter-free by sorting
each query frame's keys and run-length counting; each frame keeps its top
ncand cells by (votes desc, key asc). The branch structure is the JAX
package's (candidates.py:176-228), so the same shapes reach the same
kernels: without smoothing or chaining, a split sort (B1 twice, then B2's
merge entry) when the presorted run count is not a power of two and the
leading power-of-two part is >= 1024 keys, else B2's monolithic entry;
with either (long-read mode), or where B2's packed top-k cannot cover the
row, B1 then the vote: chaining alone by kernel R2
(sort.chain_vote_rank_rows), anything else by the row-batched plain vote
(sort.vote_top: the chain scan, the neighbour-bin smoothing and the
two-reduction top-k).

select_global merges the shards' proposals into the global top-ncand by
the same key (votes desc, gsid asc, bin asc): kernel B4 on 3 keys, the
identity with one shard.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ghostm_tpu_torch.kernels import sort
from ghostm_tpu_torch.utils.metrics import span

BIG = 1 << 30


def check_vote_keys(S: int, nbins: int) -> None:
    """Packed vote keys row * nbins + bin must stay below BIG, the invalid
    key. The JAX package bounds them by 2^31 instead, and between 2^30 and
    2^31 its vote drops every subject row past BIG // nbins without a
    word (one 35,213-aa subject gives 2,205 bins: more than 486,958 rows
    a shard); here that raises."""
    if S * nbins > BIG:
        raise ValueError(
            f"packed vote keys reach BIG = 2^30, the invalid key: {S} "
            f"subjects x {nbins} bins; use more shards or a wider band"
        )


def vote_and_rank(
    keys: torch.Tensor,        # (Q, M) int32 packed hit keys, invalid = BIG
    subject_ids: torch.Tensor,  # (S,) int32 global ids (sorted, pad BIG)
    ncand: int,
    min_votes: int,
    smooth: bool = False,
    nbins: int = 1 << 20,
    presorted_run: int = 0,
    chain_gamma: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This shard's top-ncand proposals per query frame: (gsid, lbin,
    votes), each (Q, ncand) int32; gsid/lbin are BIG where votes == 0.
    smooth: each run also takes its neighbour bins' votes; chain_gamma > 0:
    collinear chain scores with a drift penalty of chain_gamma votes a bin
    rank the cells (sort.vote_top)."""
    Q, M = keys.shape
    S = subject_ids.shape[0]
    check_vote_keys(S, nbins)
    if chain_gamma and chain_gamma * S * nbins + M >= (1 << 31):
        raise ValueError(
            f"chain_gamma={chain_gamma} overflows the (max,+) chain scan "
            f"for {S} subjects x {nbins} bins; use more shards"
        )
    mv = max(min_votes, 1)
    L = max(1 << max(M - 1, 1).bit_length(), 128)
    if (not smooth and not chain_gamma and 2 * L.bit_length() <= 31
            and ncand <= sort._LANES):
        run = presorted_run
        nruns = M // run if run > 1 and M % run == 0 else 0
        m1 = run << (nruns.bit_length() - 1) if nruns else 0
        if nruns and (nruns & (nruns - 1)) and m1 >= 1024:
            # SPLIT SORT: sort the leading 2^a runs and the remainder
            # separately, then merge the two sorted halves inside the vote
            # kernel — the same unique integer sort in less work than a
            # row padded to the next power of two
            a = sort.sort_rows(keys[:, :m1].contiguous(), presorted_run=run)
            b = sort.sort_rows(keys[:, m1:].contiguous(), presorted_run=run)
            top_keys, votes = sort.merge_vote_rank_rows(a, b, ncand, mv)
        else:
            top_keys, votes = sort.sort_vote_rank_rows(
                keys, ncand, mv, presorted_run=presorted_run
            )
    else:
        # smoothing, chaining, or rows too long for the packed in-kernel
        # top-k: B1 sort, then the vote: the chained one by kernel R2, any
        # other by the row-batched plain vote
        rows = sort.sort_rows(keys, presorted_run=presorted_run)
        with span("step.propose.vote"):
            if chain_gamma and not smooth:
                top_keys, votes = sort.chain_vote_rank_rows(
                    rows, ncand, mv, nbins, chain_gamma)
            else:
                top_keys, votes = sort.vote_top(
                    rows, ncand, mv, nbins=nbins, smooth=smooth,
                    chain_gamma=chain_gamma,
                )
    top_row = (top_keys // nbins).clamp(0, S - 1).to(torch.int64)
    pos = votes > 0
    big = torch.full_like(votes, BIG)
    gsid = torch.where(pos, subject_ids[top_row], big)
    lbin = torch.where(pos, top_keys % nbins, big)
    return gsid, lbin, votes


def select_global(gsid: torch.Tensor, lbin: torch.Tensor, votes: torch.Tensor,
                  ncand: int):
    """Global top-ncand over all shards' proposals, (Q, n_shards * ncand)
    each, by (votes desc, gsid asc, bin asc): any candidate of the global
    top-ncand is in its own shard's top-ncand, so this is exactly the
    one-index selection. gsid/lbin are BIG where votes == 0. Ranked by B4
    (sort.lex_rank_rows) on (-votes, gsid, lbin), 3 keys; with one shard,
    vote_and_rank already emits the global order, so the merge is the
    identity."""
    big = torch.full_like(gsid, BIG)
    pos = votes > 0
    g, b = torch.where(pos, gsid, big), torch.where(pos, lbin, big)
    if gsid.shape[1] == ncand:
        return g, b, votes
    nv, sg, sb = sort.lex_rank_rows(torch.stack((-votes, g, b)), 3, ncand)
    return sg, sb, -nv
