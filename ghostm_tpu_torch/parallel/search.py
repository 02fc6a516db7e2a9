"""The distributed search step over the ("data", "db") grid (port of the
JAX package's parallel/search.py: its shard_map body, run by every rank on
its own row block and its own shard).

Four phases; the collectives run along "db" only, each once a batch:
  1. propose (local): the rank's shard's top-ncand proposals a frame
     (SearchEngine.propose_one: B1 + B2, or B2's monolithic entry);
  2. select (all_gather): every shard's proposals side by side, in the
     loop's column order (shard-major, as the loop's torch.cat), then the
     global top-ncand by (votes desc, gsid asc, bin asc)
     (candidates.select_global: B4 on 3 keys past one shard): exactly the
     one-index selection for any shard layout;
  3. align (local) + merge (all_reduce): align_shard on the candidates the
     rank's shard owns (B3, or B5/B6), then the sum over "db" of the 7
     disjoint-masked fields with the rank's shard id as the shard field
     (each candidate is owned by one shard, so the int32 sums are exact
     in any order), then the per-read rank (B4, 5 keys);
  4. refine (all_reduce): each rank fetches the windows and subject spans
     of the hits its shard owns; one int32 all_reduce of (window, lo, hi)
     rows assembles them (one term of each sum is non-zero, the others
     0: the window bytes survive as int32); every rank then runs the same
     moves DP and traceback (refine_stats_packed).
The output is the rank's (18, R_local, K) block: the 9 hit fields and the
9 stat fields (with score_check), as the JAX package's step returns them.
`distributed_step` is the step that make_distributed_step builds there:
torch compiles nothing ahead, so it is a function of the grid engine,
which holds the statics and the rank's shard.
"""

from __future__ import annotations

import torch

from ghostm_tpu_torch.engine import NFRAMES, live_fields, rank_merged
from ghostm_tpu_torch.kernels import candidates as cand_mod
from ghostm_tpu_torch.parallel.mesh import DB_AXIS


def distributed_step(eng, qcodes3: torch.Tensor) -> torch.Tensor:
    """One grid rank's step on its row block: (R, 6, Lq) int8 frames on
    the engine's device -> (18, R, K) int32 (hits, then stats). Every rank
    of the rank's data row must call it on the same block."""
    mesh = eng.mesh
    cfg = eng.cfg
    C = cfg.candidates_per_frame
    R = qcodes3.shape[0]
    qflat = qcodes3.reshape(R * NFRAMES, cfg.query_frame_len)
    d = eng.shard_dev[0]
    # 1-2: propose on the local shard, gather, select
    props = torch.stack(eng.propose_one(qflat, d))          # (3, Qf, C)
    gath = mesh.all_gather(props, DB_AXIS, "select")       # (n, 3, Qf, C)
    n = gath.shape[0]
    pg, pb, pv = gath.permute(1, 2, 0, 3).reshape(3, -1, n * C)
    sel_g, sel_b, _ = cand_mod.select_global(pg, pb, pv, C)
    # 3: align on the owned candidates, the disjoint-mask merge, rank
    out = eng.align_one(qflat, d, sel_g, sel_b)
    shard = torch.full_like(out[0], mesh.db_index)
    fields = mesh.all_reduce_sum(live_fields(*out, shard), DB_AXIS, "merge")
    packed = rank_merged(fields, sel_g, R, cfg.max_hits)
    # 4: refine (windows gathered over "db" in refine_packed)
    return torch.cat([packed, eng.refine_packed(qcodes3, packed)])


def gather_windows(eng, g0: torch.Tensor, srow: torch.Tensor,
                   shard: torch.Tensor, wlen: int):
    """Every hit's (window, lo, hi) on a grid rank: its shard's for the
    hits it owns, 0 for the others, summed over "db" in one int32
    all_reduce. Returns (window int32 (N, wlen), lo (N,), hi (N,))."""
    mesh = eng.mesh
    w, lo, hi = eng.windows_of(eng.shard_dev[0], g0, srow, wlen)
    rows = torch.cat([w.to(torch.int32), lo[:, None], hi[:, None]], dim=1)
    mine = (shard == mesh.db_index)[:, None]
    rows = torch.where(mine, rows, torch.zeros_like(rows))
    rows = mesh.all_reduce_sum(rows, DB_AXIS, "windows")
    return rows[:, :wlen], rows[:, wlen], rows[:, wlen + 1]
