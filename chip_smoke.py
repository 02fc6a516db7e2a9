#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--subjects N]
    python3 chip_smoke.py --time-select-rank ROOT   (B4's select rows only,
                                                     with the port at ROOT)
    python3 chip_smoke.py --refine-rows   (the build, then R1's rows and
                                           its layouts across N only)
    python3 chip_smoke.py --time-refine ROOT   (R1's device ms only, with
                                                the port at ROOT)

Phases, each printing one JSON line ({"phase": ...}):
  device   the card's name and power limit (nvidia-smi);
  build    nvcc of every kernel source in csrc/, in parallel;
  kernels  each kernel's wrapper at its main-path shapes on seeded inputs
           (B1 and B2's merge entry at the shapes of both read lengths,
           B3 also at band 64), held against its plain PyTorch version on
           the card (integer outputs: equal, max_abs_err 0), with CUDA-event
           times of the kernel, the plain version, torch.sort as B1's
           yardstick, and the least time the card could take (bound_ms);
           the SW, B2-mono and B4 rows also give their device time
           without the wrapper's host work (device_ms), the SW rows the
           instructions a cell their time implies; B5 and B6 at the
           engine's score-fed shape (one launch a batch, from the codes),
           B5 also on the int32 tile route (band 24); rows on no path:
           B2-mono at (6144, 4096) with runs of 128 (36-residue frames),
           B4 at 9 x (1024, 1026) (rows past the old 48 KB cap); B1's
           long-row entry (tiles, then one k-way merge) at the 5 kbp and
           10 kbp propose rows, (768, 27600) and (384, 55248) with runs of
           16, and at the longread_k5.hifi10k cell's (128, 441856) with
           runs of 128, each with its k-way merge timed alone against one
           trip of the rows (kway_device_ms, kway_bound_ms), and past 32
           tiles, where pairwise merge passes come first: (8, 540672)
           with runs of 16 and (2, 1064963) unsorted; B3 at the long-read
           align shapes (3072 x Lq 1728, band 64; 1536 x Lq 3456, band
           128); the long-read golden's own
           shapes: B1 at (128, 13800) with runs of 8 (the one-block L =
           16384 instance), B3 at 120 x Lq 1728, band 64, B4 at 9 x (5, 24);
           B4 on 3 keys at 3 x (49152, 16), top 8 (the multi-shard select
           at 2 shards: the 3-key warp instance); R2 (the chained vote,
           gamma 2, 4 candidates) on sorted rows at the long-read golden's
           (128, 13800), the 5 kbp leg's (768, 27600) and the
           longread_k5.hifi10k cell's (128, 441856); R1 (refine: the moves
           DP and the traceback walk in one launch) at the main path's
           shapes, 81,920 hits at Lq 40 (BLOSUM62) and Lq 88 (BLOSUM50),
           band 32, and 1,280 at Lq 1728, band 64, and at 10 kbp reads'
           640 at Lq 3456, band 128: in each of its layouts (the thread
           and the warp layout) its move plane (the kernel's debug entry,
           the DP alone) equal to sw_banded_moves' on every cell and its
           9 stat rows equal to the plain version's; then the row in the
           layout its rule picks, held against the plain version like
           every row, with each layout's device ms, DP alone and walk;
  golden   `db` + `aln --batch 128` through the port's CLI on CUDA over
           tests/golden/config1_*, byte-compared with the golden table;
  golden_b50  the same index through `aln --matrix BLOSUM50 --gap-open 13
           --gap-extend 2` (the score-fed path, B5), byte-compared with
           tests/golden/config1_b50_hits.tsv;
  golden_tables_{merged,loop,cap}  the config-1 golden past the one
           direct table: `db --shards 2` searched by default (merged at
           init), with GHOSTM_TPU_MERGE_COLOCATED=0 (the per-shard loop:
           B3 twice, B4's 3-key select rows), and the 1-shard index with
           GHOSTM_TPU_DIRECT_TABLE_CAP=1024 (CSR tables, in a process of
           its own); each byte-compared with config1_hits.tsv;
  golden_debug_{check,sync,profile}  the config-1 golden through the
           port's `aln` (cli.main, the entry of `python -m
           ghostm_tpu_torch`) on CUDA in a process of its own, three more
           times: with `--check` (the checked pass launches
           B2, B3 and B4 again: twice the plain golden's launches), with
           GHOSTM_TPU_SYNC_PIPELINE=1 at 32 reads a batch, and with
           `--profile DIR` and GHOSTM_TPU_HBM_LOG=FILE (the trace must be
           non-empty, the log must hold the four keys with
           peak_bytes_in_use > 0); each byte-compared with config1_hits.tsv;
  golden_grid_{data2,db2}  the config-1 golden through `aln --device
           cuda --data-axis 2` (1-shard index) and `--db-axis 2` (`db
           --shards 2`): aln starts two local ranks on the one card
           (gloo); each rank writes its launch counts
           (GHOSTM_TPU_LAUNCH_COUNTS): B2, B3 and B4 on every rank, B4's
           3-key select rows on each rank of the db grid; byte-compared;
  golden_longread  `db` + `aln --config tests/golden/longread_cfg.json
           --max-read-len 5300` (5 kbp reads, collinear chaining: B1, the
           chained vote R2, B3, B4), byte-compared with
           tests/golden/longread_hits.tsv;
  scale    the config-2-true deployment: 570,000 synthetic proteins of
           250-450 aa (numpy default_rng(7)), k = 5, hits_per_seed 128,
           100 bp reads in 8192-read batches through
           SearchEngine.search_refine_async_dna with a background fetch
           (1 warm + 5 timed), then the same batches through the
           pipeline writing m8 (`scale_pipeline`: the one-time set-up, the
           name map and its arena, apart; per batch the fetch + unpack,
           the vectorised columns, the formatting and the write, median /
           min / max; every batch through the native writer, or the phase
           fails), then one batch's rows formatted by both routes, native
           and Python (`scale_m8_routes`: each route's ms, the bytes
           equal); a 256-read batch cross-checked against the same engine
           on device="cpu";
  mesh_scale_2x1  `scale`'s index saved with save_index, searched by a
           (2, 1) grid of two ranks on the card (MESH_CHILD: each loads
           the index, builds its engine, takes 4096 reads of each batch
           through search_batch_stats and gathers the whole batch over
           "data"); 1 warm + 3 timed batches of `scale`'s reads; rank 0's
           payload of every batch equal to the `scale` engine's, all 18
           rows; B1, B2's merge entry, B3 and B4 on every rank; per rank
           reads/s (median / min / max), the collectives' ms a batch
           (synchronised around each, apart from the step) and peak
           device memory;
  scale_b50  the same index and reads scored with BLOSUM50 13/2 (the
           score-fed route, B5; 1 warm + 3 timed batches, a stage
           breakdown, the 256-read CPU cross-check);
  scale_b50_250bp  the same index, BLOSUM50 13/2, 250 bp reads in
           88-residue frames (B6's route; its own key table);
  longread_5kbp  long-read mode at database size: the same 570,000
           proteins plus 1,000 of 1,750-1,850 aa (default_rng(8)), k = 4,
           hits_per_seed 16 (16-wide key rows); 5,000 bp reads simulated
           from the long proteins, 128 a batch (768 frames of 1728
           residues), the golden's config 5 (band 64, chain_gamma 2, 4
           candidates a frame), 1 warm + 3 timed batches; B1's long-row
           entry and R2 must launch; a 16-read batch cross-checked against the
           same engine on device="cpu";
  swissprot_tail  a database with Swiss-Prot's length tail: 480,000
           proteins of 250-450 aa (default_rng(7); the most one shard can
           vote on beside a 35,213-aa subject) plus 64 of 5,000-35,213 aa
           (default_rng(9), the longest exactly 35,213, titin), k = 5,
           hits_per_seed 128 with
           db's global truncation, built in the 2 shards `db --shards 2`
           writes (in a child process while the long-read leg runs), then
           merged into one: its packing overflows int32, so CSR tables
           (table_mode "csr"), B2's monolithic entry on rows of 40 x
           expand keys; 100 bp reads from 224 short and 32 long proteins,
           8192 a batch, 1 warm + 3 timed; reads/s (median, min, max), a
           stage breakdown, the 256-read CPU cross-check;
  swissprot_tail_2shard  the same 2-shard index as written: it fails the
           merge check, so the per-shard loop on CSR tables, B4's 3-key
           select and B3 twice a batch; the same reads; the CPU
           cross-check, and one batch's payload rows 0-5 and 9-17 equal to
           swissprot_tail's;
  mesh_tail_1x2  the same 2-shard index on a (1, 2) grid, a shard a rank
           (CSR tables decided over both shards), the same 1 warm + 3
           timed batches; rank 0's payload of every batch equal to
           swissprot_tail_2shard's, all 18 rows; B2's monolithic entry,
           B3, B4's 3-key select and B4's rank on every rank; the same
           per-rank numbers as mesh_scale_2x1; then B2's monolithic entry
           at each leg's CSR rows as kernel rows.
The launch counters are set to 0 just before each main-path run (each
golden aln and each scale leg's timed run; in each rank of a grid) and
read just after; every
kernel of that path must have launched in its run, and R1 once a batch
on every timed leg (one launch refines a batch, at any shard count). The wrappers also
count launches by input shape (`_build.SHAPES`): each `kernels` row
reports the launches of its own shape on its path (`launches`) beside the
wrapper's count at all shapes (`launches_wrapper`), and a row whose shape
was never launched there fails the run. The seed indexes are built by
the native counting sort (`kmer_csr`; its seconds in `scale_setup`,
`longread_setup` and the tail child's `seed_index_s`, beside
`bucket_keep`'s): a host-code call that took the Python route
(ghostm_tpu_torch.native.CALLS) fails the run. Then a line with the
card's name and power limit, a line {"kernels": [...]}, and last
{"ok": true, "device": ...}. Any mismatch or exception exits non-zero; so
does a host without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
OPS_PER_S = 67e12           # H100 SXM non-tensor 32-bit rate (see bound())
N_SUBJECTS = 570_000
TIMED_BATCHES = 5            # 8192-read batches after 1 warm batch
TIMED_B50 = 3                # the same, in each BLOSUM50 leg
TIMED_LONG = 3               # 128-read batches of the long-read leg
N_LONG = 1_000               # long proteins of the long-read database
# the golden's config 5 (tests/golden/longread_cfg.json) at 128 reads a batch
LONGREAD = dict(query_frame_len=1728, band_width=64, seed_len=4,
                chain_gamma=2, candidates_per_frame=4, hits_per_seed=16,
                query_batch=128)
B50 = dict(matrix="BLOSUM50", gap_open=13, gap_extend=2)
N_TAIL = 64                  # long proteins of the swissprot_tail database
# its short proteins: one shard votes on at most 2^30 / 2,205 bins (the
# 35,213-aa subject's) = 486,958 rows, so 480,000 of the 570,000
TAIL_SHORT = 480_000
TAIL_MAX = 35_213            # Swiss-Prot's longest entry (titin), aa
TIMED_TAIL = 3               # timed batches of each swissprot_tail leg
TAIL_BATCH = 8192            # reads a batch there
# the select's B4 rows at 2 shards: 3 x (frames, 2 x 8 proposals)
SELECT_SHAPE = lambda frames: (3, frames, 16)
TIMED_MESH = 3               # timed batches of each grid leg (after 1 warm)
# One rank of a grid leg: argv = coordinator, rank, data, db, index
# prefix, the Config's fields as JSON, the batches (.npz), directory. It
# runs 1 warm + the timed batches through the grid's codes entry (host
# translate, search_batch_stats: the pipeline's grid path), the launch
# counters and collective timers set to 0 after the warm batch; rank 0
# saves each batch's whole (18, R, K) payload. Writes its numbers to
# rank{rank}.json in the directory.
MESH_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.engine import SearchEngine
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.kernels import _build
from ghostm_tpu_torch.parallel import mesh as pm

coord, rank, data, db, prefix, cfg, npz, d = sys.argv[1:9]
rank, data, db = int(rank), int(data), int(db)
pm.init_distributed(coord, data * db, rank, device="cuda")
mesh = pm.make_mesh(data, db)
t0 = time.time()
index = load_index(prefix)
load_s = time.time() - t0
t0 = time.time()
eng = SearchEngine(Config(**json.loads(cfg)), index,
                   device=pm.rank_device("cuda", rank), mesh=mesh)
torch.cuda.synchronize()
init_s = time.time() - t0
z = np.load(npz)
n = len(z.files) // 2
rps, coll_ms, batch_ms = [], [], []
for b in range(n):
    if b == 1:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        mesh.time_collectives = True
    mesh.collective_s = {}
    t0 = time.perf_counter()
    hits, stats = eng.search_batch_stats(
        eng.translate(z[f"dna{b}"], z[f"lens{b}"]))
    dt = time.perf_counter() - t0
    if b:
        rps.append(hits.score.shape[0] / dt)
        batch_ms.append(dt * 1e3)
        coll_ms.append({k: v * 1e3 for k, v in mesh.collective_s.items()})
    if rank == 0:
        np.save(f"{d}/payload-b{b}.npy", np.stack(
            [getattr(hits, f) for f in hits.__dataclass_fields__]
            + [stats[k] for k in eng.STAT_KEYS] + [stats["score_check"]]))
res = dict(rank=rank, backend=mesh.backend, device=str(eng.device),
           shards_held=len(eng.shard_dev), table_mode=eng.table_mode,
           load_s=load_s, engine_init_s=init_s, reads_per_s=rps,
           batch_ms=batch_ms, collective_ms=coll_ms,
           max_memory_allocated=torch.cuda.max_memory_allocated(),
           launches=_build.LAUNCHES,
           shapes=[[k[0], [list(x) for x in k[1:]], v]
                   for k, v in _build.SHAPES.items()])
with open(f"{d}/rank{rank}.json", "w") as f:
    json.dump(res, f)
"""
# a golden_tables run in a process of its own (DIRECT_TABLE_CAP is read at
# import): argv = root, index prefix, aln arguments; prints one JSON line
TABLES_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from ghostm_tpu_torch import engine
from ghostm_tpu_torch.cli import main
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.index.diskio import load_index
from ghostm_tpu_torch.kernels import _build
eng = engine.SearchEngine(Config(query_batch=128), load_index(sys.argv[2]),
                          device="cuda")
mode = eng.table_mode
del eng
_build.reset_launches()
rc = main(sys.argv[3:])
print(json.dumps(dict(
    rc=rc, direct_table_cap=engine.DIRECT_TABLE_CAP, table_mode=mode,
    launches=_build.LAUNCHES,
    shapes=[[k[0], [list(x) for x in k[1:]], v]
            for k, v in _build.SHAPES.items()])))
"""


def emit(**kw):
    print(json.dumps(kw), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0]) * 1e6


def time_ms(fn, reps: int, flush: torch.Tensor,
            device_only: bool = False) -> float:
    """Median CUDA-event time of one call, L2 flushed before each (the
    inputs of the big calls exceed the 50 MB L2 anyway). The span holds
    whatever host work of the call the device waits for. device_only: the
    device sleeps ~1 ms before the first event, so the host has enqueued
    the call by then and the events time its device work alone."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes over 3.35 TB/s and int32
    operations over 67 T/s (the guide's non-tensor 32-bit entry; it lists
    no int32 rate, and this one is no lower than Hopper's int32 rate, so
    the bound stays a lower bound)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def presorted_keys(gen, q, m, run, hi, big_frac, dev):
    """(q, m) int32 vote keys, a big_frac share invalid (BIG), each run of
    `run` sorted, odd runs descending — the rows propose_shard builds."""
    from ghostm_tpu_torch.kernels.sort import BIG

    k = torch.randint(0, hi, (q, m), generator=gen, device=dev,
                      dtype=torch.int32)
    inval = torch.rand((q, m), generator=gen, device=dev) < big_frac
    k = torch.where(inval, torch.full_like(k, BIG), k)
    k = torch.sort(k.view(q, m // run, run), dim=2).values
    k[:, 1::2] = torch.flip(k[:, 1::2], [2])
    return k.reshape(q, m).contiguous()


def ptxas_lines(log: str) -> list:
    """nvcc -Xptxas -v: each kernel instance's (mangled) name and its
    "Used N registers ..." line, and each function's stack frame and
    spills where they are not all 0."""
    out, name, props = [], "?", None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "Function properties for" in ln:
            props = ln.rsplit(" ", 1)[1]
        elif props and "stack frame" in ln:
            if any(w != "0" for w in ln.split() if w.isdigit()):
                out.append(f"{props}: {ln.strip()}")
            props = None
        elif "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}")
    return out


def per_kernel(launches: dict) -> dict:
    """Wrapper launch counts -> counts per CUDA kernel (B2's two entries
    launch one kernel)."""
    # (B1's k-way merges, "sort_rows_kway", are among its merge launches)
    return {"B1": launches["sort_rows"] + launches["sort_rows_tiles"]
            + launches["sort_rows_merge"],
            "B2": launches["sort_vote_rank_rows"]
            + launches["merge_vote_rank_rows"],
            "B3": launches["sw_fused"], "B4": launches["lex_rank_rows"],
            "B5": launches["sw_scored"], "B6": launches["sw_wave"],
            "R1": launches["refine"],
            "R2": launches["chain_vote_rank_rows"]}


def refine_once_a_batch(tag: str, launches: dict, batches: int) -> None:
    """The engine refines a batch in one launch of R1, whatever its shards
    (on a grid rank too)."""
    if launches["refine"] != batches:
        raise SystemExit(f"{tag}: R1 launched {launches['refine']} times "
                         f"in {batches} batches, not once a batch")


def shape_counts(shapes: dict) -> dict:
    """_build.SHAPES as JSON: "wrapper (shape)+(shape)" -> launches."""
    return {f"{k[0]} " + "+".join(str(tuple(x)) for x in k[1:]): v
            for k, v in shapes.items()}


def max_err(a, b) -> int:
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


def make_runner(dev, entries: list):
    """run(name, ...): one kernel row, held against its plain version and
    timed (appended to `entries`; a mismatch exits)."""
    issue_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * 4 * max_sm_clock_hz())
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def run(name, source, replaces, kern, plain, library, nbytes, nops,
            ops_note, reps=20, launch=None, cells=None, device_ms=False,
            plain_reps=3, **extra):
        """launch: (main path, wrapper, input shapes) of the launches that
        the final line reports for this row; None: not on a main path.
        cells: the DP cells of an SW row, for the thread-instructions a
        cell its time allows (issue slots of 4 schedulers an SM at the top
        clock, 32 lanes each). device_ms: also time the wrapper's device
        work without its host work. plain_reps 0: the plain version is run
        once, for the check, and not timed (plain_ms None)."""
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err = max_err(out_k, out_p)
        equal = err == 0
        ms = time_ms(kern, reps, flush)
        if device_ms:
            extra["device_ms"] = time_ms(kern, reps, flush, device_only=True)
        plain_ms = time_ms(plain, plain_reps, flush) if plain_reps else None
        lib_ms = time_ms(library, reps, flush) if library else None
        b_ms, b_by = bound(nbytes, nops)
        e = dict(name=name, route="cuda", source=source, replaces=replaces,
                 equal=equal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 bytes=nbytes, ops=nops, ops_counted=ops_note,
                 launch=launch, **extra)
        if cells:
            e["instr_per_cell"] = ms * 1e-3 * issue_hz * 32 / cells
        emit(phase="kernels", **e)
        entries.append(e)
        if not equal:
            raise SystemExit(f"{name}: kernel differs from its plain version")

    return run


def select_ops(dev) -> torch.Tensor:
    """B4's select rows at 2 shards (its own generator): 3 x (49152
    frames, 2 x 8 proposals) as select_global stacks (-votes, gsid, bin),
    votes 0-5 (ties), gsid and bin BIG where 0."""
    from ghostm_tpu_torch.kernels.sort import BIG

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    shape = SELECT_SHAPE(49_152)[1:]
    draw = lambda hi: torch.randint(0, hi, shape, generator=gen, device=dev,
                                    dtype=torch.int32)
    v, g, b = draw(6), draw(570_064), draw(2_205)
    big = torch.full_like(g, BIG)
    return torch.stack((-v, torch.where(v > 0, g, big),
                        torch.where(v > 0, b, big)))


def time_select_rank(root: str) -> dict:
    """The B4 wrapper of the tree at `root` on select_ops, timed as a
    kernel row times it (built from that tree's csrc/): a tree whose B4
    has no 3-key warp instance runs its block kernel here. For comparing
    two trees on one card, each in a process of its own."""
    sys.path.insert(0, root)
    from ghostm_tpu_torch.kernels import sort as S

    dev = torch.device("cuda", 0)
    ops = select_ops(dev)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    equal = torch.equal(S.lex_rank_rows(ops, 3, 8),
                        S.lex_rank_rows_plain(ops, 3, 8))
    return dict(root=root, module=S.__file__, equal=equal,
                shape=list(ops.shape), smi=smi(),
                ms=time_ms(lambda: S.lex_rank_rows(ops, 3, 8), 50, flush),
                device_ms=time_ms(lambda: S.lex_rank_rows(ops, 3, 8), 50,
                                  flush, device_only=True))


def sort_ops(q, L, first, extra_per_elem=0):
    passes = sum(range(first, L.bit_length()))
    return q * (passes * (L // 2) * 2 + extra_per_elem * L)


def b1_long_row(run, S, leg, x, rn, dev):
    """B1's long-row route on x (runs of rn): the wrapper (tiles, then
    sort.long_plan's merges) held to the plain version and timed, and its
    k-way merge alone (kway_device_ms) from the sorted tiles, against one
    trip of the rows through device memory (8 bytes a key)."""
    q, m = x.shape
    tiles = -(-m // S.TILE)
    passes, kway = S.long_plan(m)
    extra = {}
    if kway and not passes:
        src = torch.empty_like(x)
        dst = torch.empty_like(x)
        vec = int(S._aligned(x, src, dst))
        smp = S._sort_tiles(x, src, rn.bit_length(), vec, True)
        extra = dict(kway_device_ms=time_ms(
            lambda: S._merge_kway(src, dst, S.TILE, smp, vec), 20,
            torch.empty(64 << 20, dtype=torch.int32, device=dev),
            device_only=True),
            kway_bound_ms=bound(2 * x.numel() * 4, 0)[0])
    run(f"B1 sort_rows ({q}, {m})", "ghostm_tpu_torch/csrc/sort_rows.cu",
        "ghostm_tpu/kernels/sort.py:69",
        lambda: S.sort_rows(x, presorted_run=rn),
        lambda: S.sort_rows_plain(x, presorted_run=rn),
        lambda: torch.sort(x, dim=1),
        2 * x.numel() * 4,
        sort_ops(q * tiles, S.TILE, rn.bit_length()) + q * m * (passes + kway),
        f"2 per compare-exchange of the tile networks (stages "
        f"{rn.bit_length()}..14) + 1 a key a merge launch",
        launch=(leg, "sort_rows_tiles", (q, m)) if leg else None,
        device_ms=True, shape=[q, m, rn], tiles=tiles, merge_passes=passes,
        kway_merges=kway, **extra)


def kernel_phase(dev):
    """Each kernel at its main-path shape vs its plain version."""
    from ghostm_tpu_torch.kernels import sort as S
    from ghostm_tpu_torch.kernels import sw_fused as F
    from ghostm_tpu_torch.kernels import sw_scored as SF
    from ghostm_tpu_torch.kernels import sw_wave as SW
    from ghostm_tpu_torch.ops.scoring import padded_matrix

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the rows on no path draw from their own generator, so that every
    # other row sees the inputs of earlier versions of this script
    gen_extra = torch.Generator(device=dev)
    gen_extra.manual_seed(1)
    ncand = 8
    entries = []
    run = make_runner(dev, entries)

    # B1: the split sort's two halves, runs of 128: (6144, 4096) and
    # (6144, 512) with 100 bp reads, (2944, 8192) and (2944, 2560) with
    # 250 bp reads (88-residue frames)
    for leg, q, m in (("scale", 6144, 4096), ("scale", 6144, 512),
                      ("scale_b50_250bp", 2944, 8192),
                      ("scale_b50_250bp", 2944, 2560)):
        x = presorted_keys(gen, q, m, 128, 1 << 26, 0.4, dev)
        L = max(1 << (m - 1).bit_length(), 128)
        run(f"B1 sort_rows ({q}, {m})", "ghostm_tpu_torch/csrc/sort_rows.cu",
            "ghostm_tpu/kernels/sort.py:69",
            lambda: S.sort_rows(x, presorted_run=128),
            lambda: S.sort_rows_plain(x, presorted_run=128),
            lambda: torch.sort(x, dim=1),
            2 * x.numel() * 4, sort_ops(q, L, 8),
            f"2 per compare-exchange, stages 8..{L.bit_length() - 1}",
            launch=(leg, "sort_rows", (q, m)))
    # B2 monolithic: golden config-1 shape (768 frames, 38 runs of 16);
    # then 36-residue frames at hits_per_seed 128 (32 runs of 128: not on
    # a main path)
    for q, m, rn, hi, launch in (
            (768, 608, 16, 1 << 14,
             ("golden", "sort_vote_rank_rows", (768, 608))),
            (6144, 4096, 128, 1 << 22, None)):
        k1 = presorted_keys(gen if launch else gen_extra, q, m, rn, hi, 0.6,
                            dev)
        L = max(1 << (m - 1).bit_length(), 128)
        first = rn.bit_length()
        run("B2 sort_vote_rank_rows" + ("" if launch else f" ({q}, {m})"),
            "ghostm_tpu_torch/csrc/sort_vote.cu",
            "ghostm_tpu/kernels/sort.py:74",
            lambda: S.sort_vote_rank_rows(k1, ncand, 1, presorted_run=rn),
            lambda: S.sort_vote_rank_rows_plain(k1, ncand, 1,
                                                presorted_run=rn),
            None, k1.numel() * 4 + 2 * q * ncand * 4,
            sort_ops(q, L, first, 1 + 2 * ncand),
            f"2 per compare-exchange (stages {first}..{L.bit_length() - 1})"
            " + (1 + 2 ncand) per key", launch=launch, device_ms=True,
            shape=[q, m, rn])
    # B2 merge: the sorted halves, (6144, 4096) + (6144, 512) with 100 bp
    # reads and (2944, 8192) + (2944, 2560) with 250 bp reads
    for leg, q, ma, mb in (("scale", 6144, 4096, 512),
                           ("scale_b50_250bp", 2944, 8192, 2560)):
        keys = presorted_keys(gen, q, ma + mb, 128, 1 << 22, 0.4, dev)
        a = torch.sort(keys[:, :ma], dim=1).values.contiguous()
        b = torch.sort(keys[:, ma:], dim=1).values.contiguous()
        L = 2 * ma
        run(f"B2 merge_vote_rank_rows ({q}, {ma}) + ({q}, {mb})",
            "ghostm_tpu_torch/csrc/merge_vote.cu",
            "ghostm_tpu/kernels/sort.py:74",
            lambda: S.merge_vote_rank_rows(a, b, ncand, 1),
            lambda: S.merge_vote_rank_rows_plain(a, b, ncand, 1),
            None, (a.numel() + b.numel()) * 4 + 2 * q * ncand * 4,
            sort_ops(q, L, L.bit_length() - 1, 1 + 2 * ncand),
            f"2 per compare-exchange (stage {L.bit_length() - 1}) "
            "+ (1 + 2 ncand) per key",
            launch=(leg, "merge_vote_rank_rows", (q, ma), (q, mb)))
    # B3: config-2 align, 49152 frames x 8 candidates, Lq 40, band 32;
    # then band 64 (not on a main path: two lanes an alignment); the score
    # table built once, as the engine builds it
    def pairs(N, Lq, B, g=None):
        """Codes and window-local spans of N alignments, half the pairs
        related (the query in the window): real alignments; drawn from
        `g` (default: gen)."""
        gen_ = g or gen
        q = torch.randint(0, 26, (N, Lq), generator=gen_, device=dev,
                          dtype=torch.int8)
        w = torch.randint(0, 26, (N, Lq + B), generator=gen_, device=dev,
                          dtype=torch.int8)
        w[::2, 8:8 + Lq] = q[::2]
        lo = torch.randint(0, 8, (N,), generator=gen_, device=dev,
                           dtype=torch.int32)
        hi = torch.randint(Lq // 2, Lq + B, (N,), generator=gen_, device=dev,
                           dtype=torch.int32)
        return q, w, lo, hi

    mat = torch.from_numpy(padded_matrix("BLOSUM62").astype(np.int32)).to(dev)
    tab = F.score_table(mat, 23)
    for N, Lq, B, launch in ((393_216, 40, 32, ("scale", "sw_fused",
                                                 (393_216, 40))),
                             (393_216, 40, 64, None)):
        q, w, lo, hi = pairs(N, Lq, B)
        run("B3 sw_fused" + ("" if B == 32 else f" (band {B})"),
            "ghostm_tpu_torch/csrc/sw_fused.cu",
            "ghostm_tpu/kernels/sw_fused.py:129",
            lambda: F.sw_fused(q, w, mat, lo, hi, 11, 1, B, 23, table=tab),
            lambda: F.sw_fused_plain(q, w, mat, lo, hi, 11, 1, B, 23),
            None, N * (Lq + Lq + B + 8 + 12), 12 * N * Lq * B,
            "12 int32 ops per DP cell", launch=launch, cells=N * Lq * B,
            device_ms=True, shape=[N, Lq, B])
    # B4: config-2 rank, 9 operands x (8192 reads, 48 hits), 5 keys, top
    # 10; then rows past the old 48 KB cap, 9 x (1024, 1026) (not on a
    # main path)
    nops = 9
    for R, M, launch in ((8192, 48, ("scale", "lex_rank_rows", (9, 8192, 48))),
                         (1024, 1026, None)):
        g = gen if launch else gen_extra
        ops = torch.randint(0, 6, (nops, R, M), generator=g, device=dev,
                            dtype=torch.int32)
        ops[5:] = torch.randint(-1000, 1000, (4, R, M), generator=g,
                                device=dev, dtype=torch.int32)
        if launch:   # the count PR 1 held this row to
            L = 1 << (M - 1).bit_length()
            passes = sum(range(1, L.bit_length()))
            n_ops = R * passes * (L // 2) * 26
            note = ("26 per compare-exchange (6 compares + 20 moves), "
                    f"{passes} passes at L={L}")
        else:        # work no design can skip: a top-10 selection
            n_ops = R * M * (5 + 1)
            note = "num_keys + 1 compares a column (the top-10 selection)"
        run("B4 lex_rank_rows" + ("" if launch else f" 9 x ({R}, {M})"),
            "ghostm_tpu_torch/csrc/lex_rank.cu",
            "ghostm_tpu/kernels/sort.py:127",
            lambda: S.lex_rank_rows(ops, 5, 10),
            lambda: S.lex_rank_rows_plain(ops, 5, 10),
            None, ops.numel() * 4 + nops * R * 10 * 4, n_ops, note,
            launch=launch, device_ms=True, shape=[nops, R, M])
    # B5 / B6: the score-fed route at config-2-true with BLOSUM50, one
    # launch over a batch's 49152 frames x 8 candidates, from the codes and
    # the code table the engine builds once (its largest value passed in);
    # the plain version builds the route's score tile and runs the
    # tile-fed plain SW; then B5 on the int32 tile route (band 24: not on a
    # main path)
    mat50 = torch.from_numpy(padded_matrix("BLOSUM50").astype(np.int32)
                             ).to(dev)
    b5 = (SF.sw_scored_codes, SF.sw_scored_codes_plain,
          "ghostm_tpu/kernels/sw_pallas.py:57")
    b6 = (SW.sw_wave_codes, SW.sw_wave_codes_plain,
          "ghostm_tpu/kernels/sw_wave.py:75")
    for name, (kern, plain, replaces), Lq, B, launch in (
            ("B5 sw_scored", b5, 40, 32, ("scale_b50", "sw_scored")),
            ("B6 sw_wave", b6, 88, 32, ("scale_b50_250bp", "sw_wave")),
            ("B5 sw_scored (int32 tile route)", b5, 40, 24, None)):
        N = 393_216
        q, w, lo, hi = pairs(N, Lq, B)
        tab = SF.code_table(mat50, B)
        tmax = int(tab.max())
        run(name, "ghostm_tpu_torch/csrc/sw_scored.cu", replaces,
            lambda: kern(q, w, tab, lo, hi, 13, 2, B, table_max=tmax),
            lambda: plain(q, w, tab, lo, hi, 13, 2, B),
            None, N * (Lq + Lq + B + 8 + 12), 12 * N * Lq * B,
            "12 int32 ops per DP cell", shape=[N, Lq, B],
            tile_route="int8" if B % 32 == 0 else "int32",
            launch=(*launch, (N, Lq, B)) if launch else None,
            cells=N * Lq * B, device_ms=True)
    # long-read rows (their own generator): B1's long-row entry at the
    # propose rows of 5 kbp reads (128 a batch, 1725 k-mer positions x
    # 16-wide table rows) and 10 kbp reads (64 a batch, 3453 x 16), runs
    # of 16, nearly every key valid (full seed buckets); B3 at their align
    # shapes (4 candidates a frame)
    gen_long = torch.Generator(device=dev)
    gen_long.manual_seed(2)
    for leg, q, m in (("longread_5kbp", 768, 1725 * 16),
                      (None, 384, 3453 * 16)):
        x = presorted_keys(gen_long, q, m, 16, 571_000 * 113, 0.02, dev)
        b1_long_row(run, S, leg, x, 16, dev)
    # the longread_k5.hifi10k cell's rows (its own generator; not a leg
    # here: the cell runs in portbench): 3,452 k-mers x 128 seeds of a
    # 3,456-residue frame, runs of 128, ~54% invalid; 27 tiles, one k-way
    # merge, timed alone against one trip of the rows (kway_bound_ms)
    gen_cell = torch.Generator(device=dev)
    gen_cell.manual_seed(6)
    x = presorted_keys(gen_cell, 128, 3452 * 128, 128, 570_000 * 124, 0.54,
                       dev)
    b1_long_row(run, S, None, x, 128, dev)
    # rows of more than KWAY_MAX tiles: pairwise merge passes (one, then
    # two) until KWAY_MAX runs remain, then the k-way merge reading its
    # runs' samples in place; the second row's last tile is short and
    # M % 4 != 0, so it takes no presorted runs
    for q, m, rn in ((8, 33 * S.TILE, 16), (2, 65 * S.TILE + 3, 1)):
        x = presorted_keys(gen_long, q, m, rn, 571_000 * 113, 0.02, dev)
        b1_long_row(run, S, None, x, rn, dev)
    tab = F.score_table(mat, 23)
    for N, Lq, B, leg in ((3072, 1728, 64, "longread_5kbp"),
                          (1536, 3456, 128, None)):
        q, w, lo, hi = pairs(N, Lq, B)
        run(f"B3 sw_fused (Lq {Lq}, band {B})",
            "ghostm_tpu_torch/csrc/sw_fused.cu",
            "ghostm_tpu/kernels/sw_fused.py:129",
            lambda: F.sw_fused(q, w, mat, lo, hi, 11, 1, B, 23, table=tab),
            lambda: F.sw_fused_plain(q, w, mat, lo, hi, 11, 1, B, 23),
            None, N * (Lq + Lq + B + 8 + 12), 12 * N * Lq * B,
            "12 int32 ops per DP cell", reps=5,
            launch=(leg, "sw_fused", (N, Lq)) if leg else None,
            cells=N * Lq * B, device_ms=True, shape=[N, Lq, B])
    # the long-read golden's own launches (its own generator): 5 reads, 30
    # frames in 128 propose rows of 1725 positions x 8-wide table rows (B1's
    # one-block L = 16384 instance, runs of 8; 8 subjects x 113 bins: heavy
    # ties), 120 alignments of Lq 1728, band 64, and B4 at 9 x (5, 24)
    gen_gold = torch.Generator(device=dev)
    gen_gold.manual_seed(3)
    x = presorted_keys(gen_gold, 128, 13_800, 8, 8 * 113, 0.5, dev)
    run("B1 sort_rows (128, 13800)", "ghostm_tpu_torch/csrc/sort_rows.cu",
        "ghostm_tpu/kernels/sort.py:69",
        lambda: S.sort_rows(x, presorted_run=8),
        lambda: S.sort_rows_plain(x, presorted_run=8),
        lambda: torch.sort(x, dim=1),
        2 * x.numel() * 4, sort_ops(128, 16_384, 4),
        "2 per compare-exchange, stages 4..14",
        launch=("golden_longread", "sort_rows", (128, 13_800)),
        device_ms=True, shape=[128, 13_800, 8])
    N, Lq, B = 120, 1728, 64
    q, w, lo, hi = pairs(N, Lq, B, gen_gold)
    run(f"B3 sw_fused ({N} x Lq {Lq}, band {B})",
        "ghostm_tpu_torch/csrc/sw_fused.cu",
        "ghostm_tpu/kernels/sw_fused.py:129",
        lambda: F.sw_fused(q, w, mat, lo, hi, 11, 1, B, 23, table=tab),
        lambda: F.sw_fused_plain(q, w, mat, lo, hi, 11, 1, B, 23),
        None, N * (Lq + Lq + B + 8 + 12), 12 * N * Lq * B,
        "12 int32 ops per DP cell", reps=5,
        launch=("golden_longread", "sw_fused", (N, Lq)),
        cells=N * Lq * B, device_ms=True, shape=[N, Lq, B])
    R, M = 5, 24
    ops = torch.randint(0, 6, (nops, R, M), generator=gen_gold, device=dev,
                        dtype=torch.int32)
    ops[5:] = torch.randint(-1000, 1000, (4, R, M), generator=gen_gold,
                            device=dev, dtype=torch.int32)
    L = 1 << (M - 1).bit_length()
    passes = sum(range(1, L.bit_length()))
    run(f"B4 lex_rank_rows 9 x ({R}, {M})",
        "ghostm_tpu_torch/csrc/lex_rank.cu", "ghostm_tpu/kernels/sort.py:127",
        lambda: S.lex_rank_rows(ops, 5, 10),
        lambda: S.lex_rank_rows_plain(ops, 5, 10),
        None, ops.numel() * 4 + nops * R * 10 * 4, R * passes * (L // 2) * 26,
        "26 per compare-exchange (6 compares + 20 moves), "
        f"{passes} passes at L={L}",
        launch=("golden_longread", "lex_rank_rows", (nops, R, M)),
        device_ms=True, shape=[nops, R, M])
    # B4 on 3 keys: the multi-shard select at 2 shards (the 3-key warp
    # instance)
    ops = select_ops(dev)
    _, Q, M = ops.shape
    run(f"B4 lex_rank_rows 3 x ({Q}, {M}), 3 keys",
        "ghostm_tpu_torch/csrc/lex_rank.cu", "ghostm_tpu/kernels/sort.py:127",
        lambda: S.lex_rank_rows(ops, 3, ncand),
        lambda: S.lex_rank_rows_plain(ops, 3, ncand),
        None, ops.numel() * 4 + 3 * Q * ncand * 4, Q * M * (3 + 1),
        "num_keys + 1 compares a column (the top-8 selection)",
        launch=("swissprot_tail_2shard", "lex_rank_rows", (3, Q, M)),
        device_ms=True, shape=[3, Q, M])
    # R2, the chained vote (its own generator): B1's sorted rows at the
    # long-read golden's (128, 13800) (8 subjects x 113 bins, half the
    # keys invalid), the 5 kbp leg's (768, 27600) (571,000 subjects x 113
    # bins, full seed buckets) and the longread_k5.hifi10k cell's
    # (128, 441856) (3,452 k-mers x 128 seeds of a 3,456-residue frame;
    # not a leg here: the cell runs in portbench), gamma 2, 4 candidates a
    # frame, against the plain vote_top(..., chain_gamma=2)
    gen_chain = torch.Generator(device=dev)
    gen_chain.manual_seed(5)
    for leg, q, m, nsub, nbins, big in (
            ("golden_longread", 128, 13_800, 8, 113, 0.5),
            ("longread_5kbp", 768, 1725 * 16, 571_000, 113, 0.02),
            (None, 128, 3452 * 128, 570_000, 124, 0.5)):
        x = torch.sort(presorted_keys(gen_chain, q, m, 8, nsub * nbins, big,
                                      dev), dim=1).values
        run(f"R2 chain_vote_rank_rows ({q}, {m})",
            "ghostm_tpu_torch/csrc/chain_vote.cu",
            "ghostm_tpu/kernels/candidates.py:66",
            lambda: S.chain_vote_rank_rows(x, 4, 1, nbins, 2),
            lambda: S.vote_top(x, 4, 1, nbins=nbins, chain_gamma=2),
            None, x.numel() * 4 + 2 * q * 4 * 4, 16 * q * m,
            "16 int32 ops a key (run detection 4, the chain recurrence 8, "
            "the run's score 4)",
            launch=(leg, "chain_vote_rank_rows", (q, m)) if leg else None,
            device_ms=True, shape=[q, m])
    del x, k1, keys, a, b, q, w, lo, hi, tab, ops
    torch.cuda.empty_cache()
    refine_rows(dev, run)
    return entries


def refine_case(gen, R: int, K: int, Lq: int, B: int, dev):
    """Ranked hits of R reads x K for refine (its own generator): frames
    0-5, g0 below 2^28; half the windows hold their hit's query frame on
    diagonal 8, a quarter with 3 residues inserted halfway (a gap); spans
    cut up to 8 positions into each end of the window; every eighth hit
    dead (its window wholly outside the span)."""
    from ghostm_tpu_torch.kernels.refine import query_codes

    N = R * K
    draw = lambda hi, shape, dt=torch.int32: torch.randint(
        0, hi, shape, generator=gen, device=dev, dtype=dt)
    q3 = draw(24, (R, 6, Lq), torch.int8)
    packed = torch.zeros((9, R, K), dtype=torch.int32, device=dev)
    packed[2] = draw(6, (R, K))
    g0 = draw(1 << 28, (N,))
    packed[6] = g0.view(R, K)
    w = draw(26, (N, Lq + B), torch.int8)
    qc = query_codes(q3, packed)
    h = Lq // 2
    w[::2, 8:8 + Lq] = qc[::2]
    w[1::4, 8:8 + h] = qc[1::4, :h]
    w[1::4, 11 + h:11 + Lq] = qc[1::4, h:]
    lo = g0 - draw(8, (N,))
    hi = g0 + Lq + B - draw(8, (N,))
    hi[7::8] = g0[7::8]
    return q3, packed, w, lo, hi


# R1's shapes: (main path or None, reads, Lq, band, matrix, gap costs);
# K = 10 hits a read
REFINE_SHAPES = (
    ("scale", 8192, 40, 32, "BLOSUM62", 11, 1),
    ("scale_b50_250bp", 8192, 88, 32, "BLOSUM50", 13, 2),
    ("longread_5kbp", 128, 1728, 64, "BLOSUM62", 11, 1),
    (None, 64, 3456, 128, "BLOSUM62", 11, 1),    # 10 kbp reads
)


def layout_name(lanes: int, diags: int) -> str:
    return f"{'warp' if lanes == 32 else 'thread'} ({lanes}x{diags})"


def refine_layout_times(R1, args, kw, tmax, reps, flush) -> dict:
    """Each layout R1 takes at this shape, forced through launch: the
    device ms of the kernel, of its DP alone (the debug entry's launch, no
    walk) and the walk's (the difference)."""
    times = {}
    for lanes, diags in R1.layouts(args[0].shape[2], kw["band"]):
        t = {k: time_ms(lambda: R1.launch(*args, table_max=tmax, walk=walk,
                                          lanes=lanes, **kw),
                        reps, flush, device_only=True)
             for k, walk in (("device_ms", True), ("dp_device_ms", False))}
        t["walk_ms"] = t["device_ms"] - t["dp_device_ms"]
        times[layout_name(lanes, diags)] = t
    return times


def refine_rows(dev, run) -> None:
    """R1 at the main path's shapes (its own generator): 8192 reads x 10
    hits at Lq 40 (`scale`, BLOSUM62 11/1) and Lq 88 (`scale_b50_250bp`,
    BLOSUM50 13/2), 128 x 10 at Lq 1728, band 64 (`longread_5kbp`), and 64
    x 10 at Lq 3456, band 128 (10 kbp reads: on no leg; the plain version
    run once for the check, not timed), on the engine's hard-stop matrices
    and its table built once. In every layout the kernel takes at the
    shape (R1.layouts): the move plane of the kernel's debug entry (the DP
    alone) against sw_banded_moves' plane and the stats against the plain
    version; then the row (run) in the layout R1.layout picks, and each
    layout's device ms, its DP alone and its walk. The plane's bytes
    through device memory once give a second bound beside the contract's
    (inputs and outputs only)."""
    from ghostm_tpu_torch.kernels import refine as R1
    from ghostm_tpu_torch.ops.scoring import padded_matrix

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    mats = {m: torch.from_numpy(padded_matrix(m, hard_stop=True).astype(
        np.int32)).to(dev) for m in ("BLOSUM62", "BLOSUM50")}
    K = 10
    for leg, R, Lq, B, m, go, ge in REFINE_SHAPES:
        N = R * K
        q3, packed, w, lo, hi = refine_case(gen, R, K, Lq, B, dev)
        mat = mats[m]
        tab = R1.score_table(mat)
        tmax = int(tab.max())
        kw = dict(band=B, gap_open=go, gap_extend=ge)
        args = (q3, packed, w, lo, hi, tab)
        want_moves = R1.moves_plain(q3, packed, mat, w, lo, hi, **kw)
        want = R1.refine_stats_plain(q3, packed, mat, w, lo, hi, **kw)
        moves_err = stats_err = 0
        for lanes, diags in R1.layouts(Lq, B):
            moves_err = max(moves_err, max_err(
                R1.refine_moves(*args, lanes=lanes, **kw), want_moves))
            got = R1.launch(*args, table_max=tmax, walk=True, lanes=lanes,
                            **kw)[0]
            stats_err = max(stats_err, max_err(got.view(want.shape), want))
            if moves_err or stats_err:
                raise SystemExit(
                    f"R1 at N {N}, Lq {Lq}, {layout_name(lanes, diags)}: "
                    f"the kernel differs from the plain version (moves "
                    f"{moves_err}, stats {stats_err})")
        del want_moves
        reps = 5 if Lq > 100 else 20
        layouts = refine_layout_times(R1, args, kw, tmax, reps, flush)
        nbytes = (q3.numel() + 2 * N * 4 + w.numel() + 2 * N * 4
                  + tab.numel() * 4 + 9 * N * 4)
        plane = Lq * -(-B // 4) * 4 * N
        chosen = R1.layout(N, Lq, B, R1.sm_count(dev))
        run(f"R1 refine (N {N}, Lq {Lq}, band {B})",
            "ghostm_tpu_torch/csrc/refine.cu", "ghostm_tpu/engine.py:490",
            lambda: R1.refine_stats(q3, packed, mat, w, lo, hi, table=tab,
                                    table_max=tmax, **kw),
            (lambda: want) if leg is None else
            (lambda: R1.refine_stats_plain(q3, packed, mat, w, lo, hi,
                                           **kw)),
            None, nbytes, 12 * N * Lq * B,
            "12 int32 ops per DP cell (the walk's steps not counted)",
            reps=reps, plain_reps=0 if leg is None else 3,
            launch=leg and (leg, "refine", (N, Lq + B)), cells=N * Lq * B,
            device_ms=True, shape=[N, Lq, B], matrix=m, gaps=[go, ge],
            moves_max_abs_err=moves_err, layout=layout_name(*chosen),
            layouts=layouts,
            dp_device_ms=layouts[layout_name(*chosen)]["dp_device_ms"],
            plane_bytes=plane,
            bound_with_plane_ms=bound(nbytes + plane, 12 * N * Lq * B)[0],
            hits=int((want[8] > 0).sum()),
            gapped=int((want[7] > 0).sum()))
        del q3, packed, w, lo, hi, want
        torch.cuda.empty_cache()
    del flush


# R1's layout sweep: (Lq, band, reads of 10 hits each)
REFINE_SWEEP = ((40, 32, (256, 512, 768, 1024, 2048, 3072, 8192)),
                (88, 32, (256, 512, 1024, 2048, 4096)),
                (400, 32, (128, 512, 1024, 2048, 4096)),
                (40, 64, (256, 1024, 2048, 4096, 8192)),
                (300, 64, (128, 512, 1024, 2048, 4096)),
                (1728, 64, (64, 128, 512, 1024, 2048)),
                (3456, 128, (64, 256, 512)))


def warm_up(dev, seconds: float = 0.5) -> None:
    """Keep the card busy for a while, so that the first timings of a
    process do not meet it at idle clocks."""
    x = torch.empty(1 << 26, device=dev)
    t0 = time.time()
    while time.time() - t0 < seconds:
        x.mul_(1.0)
        torch.cuda.synchronize()


def refine_sweep(dev) -> None:
    """R1's two layouts across N, for the layout rule's thresholds: at
    each (Lq, band, reads) of REFINE_SWEEP, hits made as refine_rows
    makes them; the layouts' stats equal to each other (refine_rows holds
    them against the plain version), each layout's device ms and the
    layout the rule picks."""
    from ghostm_tpu_torch.kernels import refine as R1
    from ghostm_tpu_torch.ops.scoring import padded_matrix

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    mat = torch.from_numpy(padded_matrix("BLOSUM62", hard_stop=True).astype(
        np.int32)).to(dev)
    tab = R1.score_table(mat)
    tmax = int(tab.max())
    for Lq, B, reads in REFINE_SWEEP:
        kw = dict(band=B, gap_open=11, gap_extend=1)
        for R in reads:
            q3, packed, w, lo, hi = refine_case(gen, R, 10, Lq, B, dev)
            args = (q3, packed, w, lo, hi, tab)
            outs = [R1.launch(*args, table_max=tmax, walk=True, lanes=a,
                              **kw)[0] for a, _ in R1.layouts(Lq, B)]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise SystemExit(f"R1 sweep N {R * 10}, Lq {Lq}: the "
                                 "layouts differ")
            times = {layout_name(*lay): time_ms(
                lambda: R1.launch(*args, table_max=tmax, walk=True,
                                  lanes=lay[0], **kw), 10, flush,
                device_only=True) for lay in R1.layouts(Lq, B)}
            emit(phase="refine_sweep", shape=[R * 10, Lq, B],
                 chosen=layout_name(*R1.layout(R * 10, Lq, B,
                                               R1.sm_count(dev))),
                 device_ms=times)
    del flush


def time_refine(root: str) -> None:
    """R1 of the tree at `root` (built from that tree's csrc/) at
    REFINE_SHAPES, in the layout its wrapper picks: the device ms of a
    launch and of its DP alone (walk=False). For comparing two trees on
    one card, each in a process of its own (refine_rows holds each tree's
    kernel against the plain version)."""
    sys.path.insert(0, root)
    from ghostm_tpu_torch.kernels import refine as R1
    from ghostm_tpu_torch.ops.scoring import padded_matrix

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    warm_up(dev)
    for leg, R, Lq, B, m, go, ge in REFINE_SHAPES:
        mat = torch.from_numpy(padded_matrix(m, hard_stop=True).astype(
            np.int32)).to(dev)
        tab = R1.score_table(mat)
        q3, packed, w, lo, hi = refine_case(gen, R, 10, Lq, B, dev)
        kw = dict(band=B, gap_open=go, gap_extend=ge,
                  table_max=int(tab.max()))
        run = lambda walk: R1.launch(q3, packed, w, lo, hi, tab, walk=walk,
                                     **kw)
        reps = 5 if Lq > 100 else 20
        emit(phase="time_refine", root=root, module=R1.__file__,
             shape=[R * 10, Lq, B], smi=smi(),
             device_ms=time_ms(lambda: run(True), reps, flush,
                               device_only=True),
             dp_device_ms=time_ms(lambda: run(False), reps, flush,
                                  device_only=True))
        del q3, packed, w, lo, hi
        torch.cuda.empty_cache()


def golden_phase(prefix: str, tag: str, flags, gold: str, need,
                 forbid=(), reads: str = "config1_reads.fa", env=None,
                 table_mode=None, **extra):
    """`aln --device cuda` with `flags` through the port's CLI over the
    index `prefix` and tests/golden/`reads`, byte-compared with
    tests/golden/`gold`; the kernels in `need` must launch in that run,
    those in `forbid` must not. env: the run goes to a process of its own
    (TABLES_CHILD) with these variables set, its launch counts and its
    engine's table mode read back from it; table_mode: the mode that
    child's engine must take."""
    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.kernels import _build

    golds = os.path.join(ROOT, "tests", "golden")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "hits.tsv")
        args = ["aln", "-d", prefix, "-i", os.path.join(golds, reads),
                "-o", out, "--device", "cuda", *flags]
        _build.reset_launches()
        t0 = time.time()
        if env is None:
            if cli(args) != 0:
                raise SystemExit(f"{tag}: aln failed")
            launches, shapes = dict(_build.LAUNCHES), dict(_build.SHAPES)
        else:
            res = subprocess.run(
                [sys.executable, "-c", TABLES_CHILD, ROOT, prefix, *args],
                env=dict(os.environ, **env), capture_output=True, text=True,
                timeout=600)
            if res.returncode != 0:
                raise SystemExit(f"{tag}: aln failed:\n{res.stderr[-4000:]}")
            child = json.loads(res.stdout.strip().splitlines()[-1])
            if child["rc"] != 0:
                raise SystemExit(f"{tag}: aln failed")
            if table_mode not in (None, child["table_mode"]):
                raise SystemExit(f"{tag}: {child['table_mode']} seed "
                                 f"tables, want {table_mode}")
            launches = child.pop("launches")
            shapes = {(k, *map(tuple, xs)): v
                      for k, xs, v in child.pop("shapes")}
            extra.update(child)
        wall = time.time() - t0
        with open(out) as f, open(os.path.join(golds, gold)) as g:
            got, want = f.read(), g.read()
    match = got == want
    emit(phase=tag, match=match, rows=len(got.splitlines()) - 1,
         aln_s=wall, launches=launches, kernel_launches=per_kernel(launches),
         shape_launches=shape_counts(shapes), **extra)
    if not match:
        raise SystemExit(f"{tag}: the CUDA hit table differs from "
                         f"tests/golden/{gold}")
    for k in need:
        if launches[k] == 0:
            raise SystemExit(f"{tag}: kernel {k} was never launched")
    for k in forbid:
        if launches[k]:
            raise SystemExit(f"{tag}: kernel {k} was launched")
    return launches, shapes


def golden_tables(prefix: str, d: str) -> dict:
    """The config-1 golden through the port's CLI on indexes past the one
    direct table: `db --shards 2` searched by default (the engine merges
    the shards at init: B4 never ranks the select), with
    GHOSTM_TPU_MERGE_COLOCATED=0 (the per-shard loop: B3 twice, B4's
    3-key select rows (3, 768, 16)), and the 1-shard index `prefix` with
    GHOSTM_TPU_DIRECT_TABLE_CAP=1024 (CSR tables; a process of its own).
    Each byte-identical to config1_hits.tsv."""
    from ghostm_tpu_torch.cli import main as cli
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import SearchEngine
    from ghostm_tpu_torch.index.diskio import load_index

    golds = os.path.join(ROOT, "tests", "golden")
    prefix2 = os.path.join(d, "idx_2shards")
    if cli(["db", "-i", os.path.join(golds, "config1_db.fa"), "-o", prefix2,
            "--shards", "2"]) != 0:
        raise SystemExit("golden_tables: db failed")
    need = ("sort_vote_rank_rows", "sw_fused", "lex_rank_rows", "refine")
    select = ("lex_rank_rows", SELECT_SHAPE(768))
    runs = {}
    for tag, merge in (("golden_tables_merged", "1"),
                       ("golden_tables_loop", "0")):
        os.environ["GHOSTM_TPU_MERGE_COLOCATED"] = merge
        try:
            eng = SearchEngine(Config(query_batch=128), load_index(prefix2),
                               device="cuda")
            info = dict(merged_colocated=eng.merged_colocated,
                        n_shards=eng.n_shards, table_mode=eng.table_mode)
            del eng
            runs[tag] = golden_phase(prefix2, tag, ["--batch", "128"],
                                     "config1_hits.tsv", need, **info)
        finally:
            del os.environ["GHOSTM_TPU_MERGE_COLOCATED"]
        launches, shapes = runs[tag]
        loop = merge == "0"
        if info["merged_colocated"] == loop or info["n_shards"] != 1 + loop:
            raise SystemExit(f"{tag}: engine {info}")
        if bool(shapes.get(select)) != loop or launches["sw_fused"] != 1 + loop:
            raise SystemExit(f"{tag}: B4's 3-key select launched "
                             f"{shapes.get(select, 0)} times, B3 "
                             f"{launches['sw_fused']}")
    tag = "golden_tables_cap"
    runs[tag] = golden_phase(
        prefix, tag, ["--batch", "128"], "config1_hits.tsv", need,
        env={"GHOSTM_TPU_DIRECT_TABLE_CAP": "1024"}, table_mode="csr")
    rows = (768, 40 * load_index(prefix).expand_width)   # all 40 positions
    if runs[tag][1].get(("sort_vote_rank_rows", rows)) != 1:
        raise SystemExit(f"{tag}: no CSR key rows {rows}")
    return runs


def golden_phases():
    """One config-1 index (`db` through the port's CLI), then the BLOSUM62
    golden (B3) and the BLOSUM50 golden (score-fed, B5); golden_tables;
    then the long-read golden on its own index (config 5: B1's one-block
    rows of 1725 x 8 keys, the chained vote, B3, B4; never B2)."""
    from ghostm_tpu_torch.cli import main as cli

    golds = os.path.join(ROOT, "tests", "golden")
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "idx")
        if cli(["db", "-i", os.path.join(golds, "config1_db.fa"),
                "-o", prefix]) != 0:
            raise SystemExit("golden: db failed")
        golden = golden_phase(
            prefix, "golden", ["--batch", "128"], "config1_hits.tsv",
            ("sort_vote_rank_rows", "sw_fused", "lex_rank_rows", "refine"))
        b50 = golden_phase(
            prefix, "golden_b50", ["--batch", "128", "--matrix", "BLOSUM50",
                                   "--gap-open", "13", "--gap-extend", "2"],
            "config1_b50_hits.tsv",
            ("sort_vote_rank_rows", "sw_scored", "lex_rank_rows", "refine"),
            forbid=("sw_fused", "sw_wave"))
        tables = golden_tables(prefix, d)
        grid_goldens(prefix, os.path.join(d, "idx_2shards"), d)
        debug = golden_debug(prefix, d, golden[0])
        cfgf = os.path.join(golds, "longread_cfg.json")
        prefix = os.path.join(d, "idx_lr")
        if cli(["db", "-i", os.path.join(golds, "longread_db.fa"), "-o",
                prefix, "--config", cfgf]) != 0:
            raise SystemExit("golden_longread: db failed")
        longread = golden_phase(
            prefix, "golden_longread", ["--config", cfgf, "--max-read-len",
                                        "5300"], "longread_hits.tsv",
            ("sort_rows", "chain_vote_rank_rows", "sw_fused",
             "lex_rank_rows", "refine"),
            forbid=("sort_vote_rank_rows", "merge_vote_rank_rows"),
            reads="longread_reads.fa")
    return dict(golden=golden, golden_b50=b50, golden_longread=longread,
                **tables, **debug)


def golden_debug(prefix: str, d: str, plain: dict) -> dict:
    """The config-1 golden through the port's `aln` (cli.main) on CUDA in a
    process of its own (TABLES_CHILD), three more times: with
    --check (its checked pass launches the plain golden's kernels once
    more), with GHOSTM_TPU_SYNC_PIPELINE=1 (4 batches of 32 reads), and
    with --profile and GHOSTM_TPU_HBM_LOG (a non-empty trace; the log's
    four keys, peak_bytes_in_use > 0). Each byte-identical."""
    from ghostm_tpu_torch.pipeline import HBM_KEYS

    need = ("sort_vote_rank_rows", "sw_fused", "lex_rank_rows", "refine")
    runs = {}
    tag = "golden_debug_check"
    runs[tag] = golden_phase(prefix, tag, ["--batch", "128", "--check"],
                             "config1_hits.tsv", need, env={})
    for k in need[:3]:   # refine runs once: --check repeats the search
        if runs[tag][0][k] != 2 * plain[k]:
            raise SystemExit(f"{tag}: {k} launched {runs[tag][0][k]} "
                             f"times, not twice the golden's {plain[k]}")
    tag = "golden_debug_sync"
    runs[tag] = golden_phase(prefix, tag, ["--batch", "32"],
                             "config1_hits.tsv", need,
                             env={"GHOSTM_TPU_SYNC_PIPELINE": "1"})
    tag = "golden_debug_profile"
    prof, hbm = os.path.join(d, "prof"), os.path.join(d, "hbm.json")
    runs[tag] = golden_phase(prefix, tag, ["--batch", "128", "--profile",
                                           prof], "config1_hits.tsv", need,
                             env={"GHOSTM_TPU_HBM_LOG": hbm})
    trace = os.path.join(prof, "trace.json")
    size = os.path.getsize(trace) if os.path.exists(trace) else 0
    with open(hbm) as f:
        mem = json.load(f)
    emit(phase="golden_debug_profile_files", trace_bytes=size, hbm_log=mem)
    if not size:
        raise SystemExit(f"{tag}: no profiler trace")
    if sorted(mem) != sorted(HBM_KEYS) or not mem["peak_bytes_in_use"] > 0:
        raise SystemExit(f"{tag}: device-memory log {mem}")
    return runs


def grid_goldens(prefix: str, prefix2: str, d: str) -> None:
    """The config-1 golden through the port's CLI on CUDA as a grid of two
    local ranks on the card (`aln` starts them itself): `--data-axis 2`
    over the 1-shard index and `--db-axis 2` over `db --shards 2`; each
    byte-identical. Each rank writes its launch counts
    (GHOSTM_TPU_LAUNCH_COUNTS, set just before the run): B2, B3 and B4
    must launch on every rank, B4's 3-key select rows on each rank of the
    db grid."""
    from ghostm_tpu_torch.cli import main as cli

    golds = os.path.join(ROOT, "tests", "golden")
    need = ("sort_vote_rank_rows", "sw_fused", "lex_rank_rows", "refine")
    for tag, idx, data, db in (("golden_grid_data2", prefix, 2, 1),
                               ("golden_grid_db2", prefix2, 1, 2)):
        out = os.path.join(d, f"{tag}.tsv")
        counts = os.path.join(d, f"{tag}-launches")
        os.environ["GHOSTM_TPU_LAUNCH_COUNTS"] = counts
        t0 = time.time()
        try:
            rc = cli(["aln", "-d", idx, "-i", os.path.join(
                golds, "config1_reads.fa"), "-o", out, "--device", "cuda",
                "--batch", "128", "--data-axis", str(data), "--db-axis",
                str(db)])
        finally:
            del os.environ["GHOSTM_TPU_LAUNCH_COUNTS"]
        wall = time.time() - t0
        if rc != 0:
            raise SystemExit(f"{tag}: aln failed ({rc})")
        ranks = []
        for r in range(data * db):
            with open(f"{counts}.r{r}.json") as f:
                ranks.append(json.load(f))
        with open(out) as f, open(os.path.join(golds,
                                               "config1_hits.tsv")) as g:
            match = f.read() == g.read()
        select = ("lex_rank_rows", SELECT_SHAPE(768))
        shapes = [{(k, *map(tuple, xs)): v for k, xs, v in c["shapes"]}
                  for c in ranks]
        emit(phase=tag, match=match, aln_s=wall, ranks=data * db,
             kernel_launches=[per_kernel(c["launches"]) for c in ranks],
             select_launches=[sh.get(select, 0) for sh in shapes])
        if not match:
            raise SystemExit(f"{tag}: the grid's hit table differs from "
                             "tests/golden/config1_hits.tsv")
        for r, (c, sh) in enumerate(zip(ranks, shapes)):
            for k in need:
                if c["launches"][k] == 0:
                    raise SystemExit(f"{tag}: kernel {k} was never launched "
                                     f"on rank {r}")
            if db > 1 and not sh.get(select):
                raise SystemExit(f"{tag}: B4's 3-key select never launched "
                                 f"on rank {r}")


def mesh_leg(tag: str, prefix: str, cfg, batches, wants, data: int, db: int,
             need, d: str) -> None:
    """One grid leg on the card: data x db ranks (MESH_CHILD), two sharing
    the one card over gloo, each holding its own shard of the index at
    `prefix`; 1 warm + the timed batches. Rank 0's whole payload of every
    batch must equal `wants` (the loop engine's on the same reads, all 18
    rows); every rank must launch each (wrapper, shape or None) of `need`
    in its timed run. Prints per rank reads/s (median / min / max), the
    collectives' ms a batch (synchronised around each, apart from the
    step) and peak device memory."""
    import dataclasses

    from ghostm_tpu_torch.parallel import launch

    npz = os.path.join(d, f"{tag}.npz")
    np.savez(npz, **{f"{k}{b}": x for b, (_, dna, lens) in enumerate(batches)
                     for k, x in (("dna", dna), ("lens", lens))})
    cfgj = json.dumps(dataclasses.asdict(cfg))
    t0 = time.time()
    rc = launch.wait_ranks(launch.start_ranks(
        lambda r, coord: [sys.executable, "-c", MESH_CHILD, coord, str(r),
                          str(data), str(db), prefix, cfgj, npz, d],
        data * db), timeout=900)
    wall = time.time() - t0
    if rc != 0:
        raise SystemExit(f"{tag}: a rank failed ({rc})")
    ranks = []
    for r in range(data * db):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    equal = [bool(np.array_equal(np.load(os.path.join(d, f"payload-b{b}.npy")),
                                 w)) for b, w in enumerate(wants)]
    per_rank = []
    for c in ranks:
        shapes = {(k, *map(tuple, xs)): v for k, xs, v in c.pop("shapes")}
        c["shapes"] = shapes
        coll = {}
        for b in c["collective_ms"]:
            for k, v in b.items():
                coll.setdefault(k, []).append(v)
        per_rank.append(dict(
            rank=c["rank"], backend=c["backend"], device=c["device"],
            shards_held=c["shards_held"], table_mode=c["table_mode"],
            load_s=c["load_s"], engine_init_s=c["engine_init_s"],
            reads_per_s=spread(c["reads_per_s"]), batch_ms=c["batch_ms"],
            collective_ms={k: spread(v) for k, v in coll.items()},
            collective_ms_batch=spread([sum(b.values())
                                        for b in c["collective_ms"]]),
            max_memory_allocated=c["max_memory_allocated"],
            kernel_launches=per_kernel(c["launches"]),
            shape_launches=shape_counts(shapes)))
    emit(phase=tag, grid=[data, db], batch_reads=cfg.query_batch,
         timed_batches=len(batches) - 1, wall_s=wall,
         payload_equal=equal, hits=int((wants[-1][0] > 0).sum()),
         ranks=per_rank)
    if not all(equal):
        raise SystemExit(f"{tag}: rank 0's payload differs from the loop "
                         f"engine's (batches {equal})")
    for c in ranks:
        for wrapper, shape in need:
            n = (c["launches"][wrapper] if shape is None
                 else c["shapes"].get((wrapper, shape), 0))
            if not n:
                raise SystemExit(f"{tag}: {wrapper} {shape or ''} never "
                                 f"launched on rank {c['rank']}")


def build_config2_index(n_subjects: int, cfg, n_long: int = 0):
    """The config-2-true store + k=5 seed index (positions truncated to the
    first hits_per_seed per bucket), as one shard. n_long > 0 (the
    long-read leg): n_long proteins of 1750-1850 aa (default_rng(8)) follow
    the short ones, and the truncation is `db`'s global hash sampling
    (seeds.bucket_keep): at k = 4 every bucket is full, and
    keeping the first positions would leave the long proteins no seed.
    Returns (index, seconds of bucket_keep and of build_seed_index)."""
    from ghostm_tpu_torch.index import diskio, seeds
    from ghostm_tpu_torch.index.store import SubjectStore
    from ghostm_tpu_torch.utils.simulate import fast_proteins, store_arrays

    rng = np.random.default_rng(7)
    codes, lens = fast_proteins(rng, n_subjects)
    if n_long:
        c2, l2 = fast_proteins(np.random.default_rng(8), n_long, 1750, 1850)
        codes, lens = np.concatenate([codes, c2]), np.concatenate([lens, l2])
        n_subjects += n_long
    buf, starts = store_arrays(codes, lens, cfg.sentinel_pad)
    st = SubjectStore(buffer=buf, starts=starts, lengths=lens.astype(np.int32),
                      subject_ids=np.arange(n_subjects, dtype=np.int32),
                      names=[f"s{i}" for i in range(n_subjects)])
    secs = {}
    if n_long:
        t0 = time.time()
        keep = seeds.bucket_keep(codes, lens, cfg.seed_len,
                                 cfg.hits_per_seed)
        secs["bucket_keep_s"] = time.time() - t0
        keep_buf = seeds.buffer_keep(keep, lens, cfg.seed_len,
                                     np.arange(n_subjects), starts, len(buf))
        t0 = time.time()
        sidx = seeds.build_seed_index(buf, cfg.seed_len, keep_buf)
        secs["seed_index_s"] = time.time() - t0
        return diskio.stack_shards([diskio.IndexShard(st, sidx)],
                                   cfg.seed_len), secs
    t0 = time.time()
    sidx = seeds.build_seed_index(buf, cfg.seed_len)
    secs["seed_index_s"] = time.time() - t0
    bs = np.asarray(sidx.bucket_starts, np.int64)
    counts = np.diff(bs)
    keep = (np.arange(len(sidx.positions), dtype=np.int64)
            - np.repeat(bs[:-1], counts)) < cfg.hits_per_seed
    nbs = np.zeros(len(bs), np.int64)
    np.cumsum(np.minimum(counts, cfg.hits_per_seed), out=nbs[1:])
    sidx = seeds.SeedIndex(cfg.seed_len,
                           sidx.positions[keep].astype(np.int32),
                           nbs.astype(np.int32))
    return diskio.stack_shards([diskio.IndexShard(st, sidx)],
                               cfg.seed_len), secs


def make_batches(index, n_batches: int, R: int, read_len: int = 100,
                 source=None):
    """Reads simulated from 256 random subjects (default_rng(1)), or from
    the subjects `source` (a range of ids)."""
    from ghostm_tpu_torch.ops.encode import encode_dna
    from ghostm_tpu_torch.utils.simulate import (
        decode_protein, reads_from_proteins,
    )

    st = index.shards[0].store
    rng = np.random.default_rng(1)
    pick = (rng.integers(0, st.num_subjects, 256) if source is None
            else np.asarray(source))
    prots = [decode_protein(st.subject_seq(int(p))) for p in pick]
    out = []
    for bi in range(n_batches):
        names, reads = reads_from_proteins(rng, prots, R, read_len=read_len)
        dna = np.full((R, read_len), 4, np.int8)
        lens = np.zeros(R, np.int32)
        for i, rd in enumerate(reads):
            c = encode_dna(rd)
            dna[i, :len(c)] = c
            lens[i] = len(c)
        out.append(([f"b{bi}_{n}" for n in names], dna, lens))
    return out


def stage_breakdown(eng, dna: np.ndarray, lens: np.ndarray) -> dict:
    """One batch through the engine's stages with a synchronise after each
    (host ms per stage: serialised, so the sum exceeds a pipelined batch),
    then one batch under torch.profiler: device time summed over kernels,
    the device's busy share of that batch's wall, and the top kernels."""
    from ghostm_tpu_torch.engine import NFRAMES, merge_rank
    from ghostm_tpu_torch.ops.translate import six_frame_translate_torch

    cfg = eng.cfg
    R = dna.shape[0]
    ms = {}
    torch.cuda.synchronize()
    t = time.time()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.time()
        ms[name] = (now - t) * 1e3
        t = now

    d = torch.from_numpy(dna).to(eng.device)
    ln = torch.from_numpy(lens).to(eng.device)
    mark("h2d")
    q3 = six_frame_translate_torch(d, ln, cfg.query_frame_len)
    mark("translate")
    qflat = q3.reshape(R * NFRAMES, cfg.query_frame_len)
    sel_g, sel_b = eng.propose(qflat)
    mark("propose")
    aligned = eng.align(qflat, sel_g, sel_b)
    mark("align")
    packed = merge_rank(aligned, sel_g, R, cfg.max_hits)
    mark("rank")
    stats = eng.refine_packed(q3, packed)
    mark("refine")
    staged = eng.fetch(eng._pack_transport(torch.cat([packed, stats])))
    mark("pack_d2h")
    whole = eng.fetch(eng.search_refine_async_dna(dna, lens))
    if not np.array_equal(staged, whole):
        raise SystemExit("scale: the staged batch differs from step_dna")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.fetch(eng.search_refine_async_dna(dna, lens))
        wall = time.time() - t0
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue   # CPU ops also carry their kernels' device time
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt / 1e3, ev.count, ev.key[:60]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(stage_ms=ms, profiled_wall_ms=wall * 1e3,
                device_busy_ms=busy,
                device_busy_share=busy / (wall * 1e3),
                device_launches=sum(r[1] for r in rows),
                top_kernels=[dict(ms=r[0], n=r[1], name=r[2])
                             for r in rows[:12]])


def timed_run(eng, batches):
    """1 warm batch, then the others with the pipeline's overlap: batch
    i + 1 is launched before batch i is fetched on a background thread.
    The launch counters are set to 0 after the warm batch. Returns
    (launches, launches by shape, per-batch host ms, wall s, last payload,
    peak bytes, reads/s of each batch: its reads over the time from its
    launch to the next batch's launch, or for the last to its fetch; the
    times add up to the wall)."""
    from ghostm_tpu_torch.kernels import _build

    eng.fetch(eng.search_refine_async_dna(*batches[0][1:]))   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    per_batch, starts = [], []
    t_start = time.time()
    with ThreadPoolExecutor(1) as pool:
        fut, pending = None, None
        for _, dna, lens in batches[1:]:
            tb = time.time()
            starts.append(tb)
            pay = eng.search_refine_async_dna(dna, lens)
            if pending is not None:
                if fut is not None:
                    fut.result()
                fut = pool.submit(eng.fetch, pending)
            pending = pay
            per_batch.append((time.time() - tb) * 1e3)
        if fut is not None:
            fut.result()
        last = eng.fetch(pending)
    t_end = time.time()
    wall = t_end - t_start
    rps = [len(b[0]) / (t1 - t0) for b, t0, t1
           in zip(batches[1:], starts, starts[1:] + [t_end])]
    return (dict(_build.LAUNCHES), dict(_build.SHAPES), per_batch, wall, last,
            torch.cuda.max_memory_allocated(), rps)


def spread(xs) -> dict:
    return dict(median=float(np.median(xs)), min=float(min(xs)),
                max=float(max(xs)))


def table_bytes(eng) -> int:
    return sum(int(a.nbytes) for m in eng.key_table[0] for a in m)


def crosscheck(eng, index, batch, n: int = 256):
    """n reads on the card vs the same engine on the CPU: (equal, hits)."""
    from ghostm_tpu_torch.engine import SearchEngine

    _, dna, lens = batch
    gpu = eng.fetch(eng.search_refine_async_dna(dna[:n], lens[:n]))
    cpu_eng = SearchEngine(eng.cfg.replace(query_batch=n), index,
                           device="cpu", key_table=eng.key_table)
    cpu = cpu_eng.fetch(cpu_eng.search_refine_async_dna(dna[:n], lens[:n]))
    same = gpu.shape == cpu.shape and bool((gpu == cpu).all())
    return same, int(((cpu[1] >> 15) > 0).sum())


def native_calls() -> dict:
    """ghostm_tpu_torch.native.CALLS as JSON: "function/route" -> calls;
    a call that took the Python route fails the run."""
    from ghostm_tpu_torch import native

    calls = {f"{f}/{r}": n for (f, r), n in sorted(native.CALLS.items())}
    python = {k: n for k, n in calls.items() if k.endswith("/python")}
    if python:
        raise SystemExit(f"host code took the Python route: {python}")
    return calls


def scale_phase(n_subjects: int, n_timed: int):
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import SearchEngine

    R = 8192
    cfg = Config(query_batch=R, seed_len=5, hits_per_seed=128)
    t0 = time.time()
    index, secs = build_config2_index(n_subjects, cfg)
    t_index = time.time() - t0
    t0 = time.time()
    eng = SearchEngine(cfg, index, device="cuda")
    torch.cuda.synchronize()
    t_engine = time.time() - t0
    batches = make_batches(index, 1 + n_timed, R)
    emit(phase="scale_setup", subjects=n_subjects,
         residues=int(index.total_residues), index_s=t_index, **secs,
         native_calls=native_calls(),
         engine_init_s=t_engine, table_bytes=table_bytes(eng),
         table_width=eng.table_width, expand=int(index.expand_width))

    launches, shapes, per_batch, wall, last, peak, rps = timed_run(eng,
                                                                   batches)
    emit(phase="scale", reads=R * n_timed, wall_s=wall,
         reads_per_s=R * n_timed / wall, reads_per_s_batches=spread(rps),
         batch_ms=per_batch,
         max_memory_allocated=peak, launches=launches,
         kernel_launches=per_kernel(launches),
         shape_launches=shape_counts(shapes),
         hits=int(((last[1] >> 15) > 0).sum()))
    for k in ("sort_rows", "merge_vote_rank_rows", "sw_fused",
              "lex_rank_rows", "refine"):
        if launches[k] == 0:
            raise SystemExit(f"scale: kernel {k} was never launched")
    refine_once_a_batch("scale", launches, n_timed)
    if not (last[1] >> 15).max() > 0:
        raise SystemExit("scale: no hits in the last batch")
    emit(phase="scale_stages", **stage_breakdown(eng, *batches[1][1:]))
    pipeline_phase(eng, index, batches, n_timed)

    same, hits = crosscheck(eng, index, batches[1])
    emit(phase="scale_crosscheck", reads=256, equal=same, hits=hits)
    if not same:
        raise SystemExit("scale: CUDA and CPU engines disagree")
    return ((launches, shapes), index, eng.key_table, batches,
            payloads(eng, batches[:1 + TIMED_MESH]))


def payloads(eng, batches) -> list:
    """The engine's (18, R, K) payload of each batch, host numpy."""
    return [eng.fetch(eng.step_dna(torch.from_numpy(dna).to(eng.device),
                                   torch.from_numpy(lens).to(eng.device),
                                   pack=False)) for _, dna, lens in batches]


def pipeline_phase(eng, index, batches, n_timed: int) -> None:
    """`scale_pipeline`: the timed batches through run_search writing m8,
    its wall split into the one-time set-up and each batch's host work
    (every batch through the native writer); `scale_m8_routes`: one
    batch's rows formatted by the native and the Python route, the same
    bytes."""
    import io

    from ghostm_tpu_torch import native
    from ghostm_tpu_torch.pipeline import _subject_names, run_search
    from ghostm_tpu_torch.report import write_hits
    from ghostm_tpu_torch.utils.metrics import MetricsLog

    R = eng.cfg.query_batch
    native.reset_calls()
    m = MetricsLog()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        rows = run_search(eng, batches[1:], os.path.join(d, "hits.tsv"),
                          metrics=m)
        wall_p = time.time() - t0
    ms = lambda f: spread([getattr(b, f) * 1e3 for b in m.batches])
    emit(phase="scale_pipeline", reads=R * n_timed, wall_s=wall_p,
         reads_per_s=R * n_timed / wall_p,
         reads_per_s_after_setup=R * n_timed / (wall_p - m.setup_s),
         rows=rows, setup_ms=m.setup_s * 1e3,
         batch_ms=dict(fetch_unpack=ms("fetch_s"), columns=ms("columns_s"),
                       format=ms("format_s"), write=ms("write_s"),
                       launch_to_written=ms("wall_s")),
         batch_rows=[b.hits for b in m.batches],
         native_calls=native_calls())
    if native.CALLS[("m8_format", "native")] != n_timed:
        raise SystemExit(f"scale_pipeline: {n_timed} batches, "
                         f"{native.CALLS[('m8_format', 'native')]} through "
                         "the native writer")
    names, dna, lens = batches[1]
    hits, stats = eng.unpack_results(eng.fetch(
        eng.search_refine_async_dna(dna, lens)))
    snames = _subject_names(index)
    snames.arena()
    db_seqs = sum(sh.store.num_subjects for sh in index.shards)
    out = {}
    for route, sn in (("native", snames), ("python", snames.names)):
        ts = []
        for _ in range(3):
            timing, buf = {}, io.StringIO()
            n = write_hits(buf, eng.cfg, names, lens, sn, hits, stats,
                           index.total_residues, db_seqs, timing=timing)
            ts.append(timing["format_s"] * 1e3)
        out[route] = (spread(ts), buf.getvalue())
    equal = out["native"][1] == out["python"][1]
    emit(phase="scale_m8_routes", rows=n, native_format_ms=out["native"][0],
         python_format_ms=out["python"][0], bytes_equal=equal,
         native_calls=native_calls())
    if not equal:
        raise SystemExit("scale_m8_routes: the native and Python m8 rows "
                         "differ")


def score_fed_leg(tag: str, cfg, index, batches, kernel: str,
                  key_table=None):
    """One BLOSUM50 leg on the config-2-true index: engine init, the timed
    run (the launch counters set to 0 just before it), a stage breakdown
    and the 256-read CPU cross-check. `kernel` must launch once a batch,
    B3 never."""
    from ghostm_tpu_torch.engine import SearchEngine

    t0 = time.time()
    eng = SearchEngine(cfg, index, device="cuda", key_table=key_table)
    torch.cuda.synchronize()
    t_engine = time.time() - t0
    launches, shapes, per_batch, wall, last, peak, rps = timed_run(eng,
                                                                   batches)
    n = cfg.query_batch * (len(batches) - 1)
    same, xhits = crosscheck(eng, index, batches[1])
    emit(phase=tag, route=eng.route, query_frame_len=cfg.query_frame_len,
         read_len=int(batches[1][1].shape[1]), engine_init_s=t_engine,
         reads=n, wall_s=wall, reads_per_s=n / wall,
         reads_per_s_batches=spread(rps), batch_ms=per_batch,
         max_memory_allocated=peak, launches=launches,
         kernel_launches=per_kernel(launches),
         shape_launches=shape_counts(shapes),
         hits=int(((last[1] >> 15) > 0).sum()), crosscheck_reads=256,
         crosscheck_equal=same, crosscheck_hits=xhits)
    if launches[kernel] != len(batches) - 1:
        raise SystemExit(f"{tag}: kernel {kernel} launched "
                         f"{launches[kernel]} times in {len(batches) - 1} "
                         "batches, not once a batch")
    if launches["sw_fused"]:
        raise SystemExit(f"{tag}: the fused kernel B3 was launched")
    refine_once_a_batch(tag, launches, len(batches) - 1)
    if not (last[1] >> 15).max() > 0:
        raise SystemExit(f"{tag}: no hits in the last batch")
    if not same:
        raise SystemExit(f"{tag}: CUDA and CPU engines disagree")
    emit(phase=f"{tag}_stages", **stage_breakdown(eng, *batches[1][1:]))
    return launches, shapes


def longread_phase(n_short: int):
    """Long-read mode at database size (config 5 of the golden): index,
    1 warm + TIMED_LONG timed 128-read batches of 5,000 bp reads from the
    long proteins, a stage breakdown, the 16-read CPU cross-check. B1's
    long-row entry must launch."""
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import SearchEngine

    cfg = Config(**LONGREAD)
    t0 = time.time()
    index, secs = build_config2_index(n_short, cfg, n_long=N_LONG)
    t_index = time.time() - t0
    t0 = time.time()
    eng = SearchEngine(cfg, index, device="cuda")
    torch.cuda.synchronize()
    t_engine = time.time() - t0
    R = cfg.query_batch
    batches = make_batches(index, 1 + TIMED_LONG, R, read_len=5000,
                           source=range(n_short, n_short + N_LONG))
    emit(phase="longread_setup", subjects=n_short + N_LONG,
         long_subjects=N_LONG, residues=int(index.total_residues),
         index_s=t_index, **secs, native_calls=native_calls(),
         engine_init_s=t_engine, route=eng.route,
         table_bytes=table_bytes(eng), table_width=eng.table_width,
         nbins=eng.nbins, expand=int(index.expand_width),
         pack_ok=eng._pack_ok)
    launches, shapes, per_batch, wall, last, peak, rps = timed_run(eng,
                                                                   batches)
    n = R * TIMED_LONG
    hits = int(((last[1] >> 15) > 0).sum())
    top = last[0][:, 0]
    names = batches[-1][0]
    # reads name their source subject ("..._from_subj<i>", i into the
    # long proteins): the top hit's subject id is n_short + i
    src = np.array([n_short + int(x.rsplit("subj", 1)[1]) for x in names])
    same, xhits = crosscheck(eng, index, batches[1], n=16)
    b1 = {k: v for k, v in shape_counts(shapes).items()
          if k.startswith("sort_rows")}
    emit(phase="longread_5kbp", reads=n, read_len=5000, wall_s=wall,
         reads_per_s=n / wall, reads_per_s_batches=spread(rps),
         batch_ms=per_batch,
         max_memory_allocated=peak, table_width=eng.table_width,
         b1_shapes=b1, launches=launches,
         kernel_launches=per_kernel(launches),
         shape_launches=shape_counts(shapes), hits=hits,
         top_hit_is_source=int((top == src).sum()), crosscheck_reads=16,
         crosscheck_equal=same, crosscheck_hits=xhits)
    for k in ("sort_rows_tiles", "sort_rows_merge", "sort_rows_kway",
              "chain_vote_rank_rows",
              "sw_fused", "lex_rank_rows", "refine"):
        if launches[k] == 0:
            raise SystemExit(f"longread_5kbp: kernel {k} was never launched")
    refine_once_a_batch("longread_5kbp", launches, TIMED_LONG)
    if launches["sort_vote_rank_rows"] or launches["merge_vote_rank_rows"]:
        raise SystemExit("longread_5kbp: B2 was launched on chained rows")
    if not hits:
        raise SystemExit("longread_5kbp: no hits in the last batch")
    if not same:
        raise SystemExit("longread_5kbp: CUDA and CPU engines disagree")
    emit(phase="longread_5kbp_stages", **stage_breakdown(eng,
                                                        *batches[1][1:]))
    return launches, shapes


def build_tail_index(n_subjects: int, prefix: str) -> dict:
    """The swissprot_tail database, written as `db --shards 2` would write
    it: n_subjects proteins of 250-450 aa (default_rng(7)), then N_TAIL
    proteins
    of 5,000-35,213 aa (default_rng(9); the longest exactly TAIL_MAX), k =
    5, hits_per_seed 128 truncated globally (seeds.bucket_keep), the
    subjects assigned by store.shard_records; saved with save_index.
    Returns the seconds of each step (seed_index_s: build_seed_index's,
    within shards_s) and the host-code calls by route. Runs in a child
    process (main's --build-tail-index) while the GPU legs run."""
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.index import diskio, seeds, store
    from ghostm_tpu_torch.utils.simulate import fast_proteins, store_arrays

    cfg = Config(seed_len=5, hits_per_seed=128, shards=2)
    k = cfg.seed_len
    secs = {}
    t0 = time.time()
    codes, lens = fast_proteins(np.random.default_rng(7), n_subjects)
    rng = np.random.default_rng(9)
    l2 = rng.integers(5_000, TAIL_MAX, N_TAIL)
    l2[int(np.argmax(l2))] = TAIL_MAX
    codes = np.concatenate(
        [codes, rng.integers(0, 20, int(l2.sum())).astype(np.int8)])
    lens = np.concatenate([lens, l2])
    first = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=first[1:])
    secs["proteins_s"] = time.time() - t0
    t0 = time.time()
    keep = seeds.bucket_keep(codes, lens, k, cfg.hits_per_seed)
    secs["bucket_keep_s"] = time.time() - t0
    t0 = time.time()
    view = memoryview(codes)   # records of the right lengths, no copies
    assign = store.shard_records(
        [(None, view[a:a + n]) for a, n in zip(first.tolist(),
                                               lens.tolist())], cfg.shards)
    shards = []
    secs["seed_index_s"] = 0.0
    for ids in assign:
        ids = np.asarray(ids, np.int64)
        sl = lens[ids]
        cum = np.zeros(len(sl), np.int64)
        np.cumsum(sl[:-1], out=cum[1:])
        src = (np.repeat(first[ids] - cum, sl)
               + np.arange(int(sl.sum()), dtype=np.int64))
        buf, starts = store_arrays(codes[src], sl, cfg.sentinel_pad)
        st = store.SubjectStore(buf, starts, sl.astype(np.int32),
                                ids.astype(np.int32), [f"s{i}" for i in ids])
        keep_buf = seeds.buffer_keep(keep, lens, k, ids, starts, len(buf))
        t1 = time.time()
        sidx = seeds.build_seed_index(buf, k, keep_buf)
        secs["seed_index_s"] += time.time() - t1
        shards.append(diskio.IndexShard(st, sidx))
    secs["shards_s"] = time.time() - t0
    t0 = time.time()
    diskio.save_index(prefix, shards, k)
    secs["save_s"] = time.time() - t0
    secs["native_calls"] = native_calls()
    return secs


def tail_leg(tag: str, cfg, index, batches, shards: int):
    """One swissprot_tail leg: its CSR key tables (timed apart), the
    engine, the timed run (the launch counters set to 0 just before it),
    the 256-read CPU cross-check, one batch's (18, R, K) payload and a
    stage breakdown. Returns ((launches, shapes), payload, the payloads of
    the grid leg's batches)."""
    from ghostm_tpu_torch import engine as E

    t0 = time.time()
    key_table = E.key_tables_for(cfg, index)
    table_s = time.time() - t0
    t0 = time.time()
    eng = E.SearchEngine(cfg, index, device="cuda", key_table=key_table)
    torch.cuda.synchronize()
    engine_s = time.time() - t0
    info = dict(table_mode=eng.table_mode, n_shards=eng.n_shards,
                merged_colocated=eng.merged_colocated, nbins=eng.nbins,
                expand=eng.expand, table_bytes=table_bytes(eng))
    if (eng.table_mode != "csr" or eng.n_shards != shards
            or eng.merged_colocated):
        raise SystemExit(f"{tag}: engine {info}")
    launches, shapes, per_batch, wall, last, peak, rps = timed_run(eng,
                                                                   batches)
    n = cfg.query_batch * (len(batches) - 1)
    same, xhits = crosscheck(eng, index, batches[1])
    _, dna, lens = batches[1]
    payload = eng.fetch(eng.step_dna(
        torch.from_numpy(dna).to(eng.device),
        torch.from_numpy(lens).to(eng.device), pack=False))
    emit(phase=tag, key_table_s=table_s, engine_init_s=engine_s, reads=n,
         wall_s=wall, reads_per_s=n / wall, reads_per_s_batches=spread(rps),
         batch_ms=per_batch, max_memory_allocated=peak, launches=launches,
         kernel_launches=per_kernel(launches),
         shape_launches=shape_counts(shapes),
         hits=int(((last[1] >> 15) > 0).sum()), crosscheck_reads=256,
         crosscheck_equal=same, crosscheck_hits=xhits, **info)
    nb = len(batches) - 1
    select = shapes.get(("lex_rank_rows", SELECT_SHAPE(cfg.query_batch * 6)),
                        0)
    if launches["sw_fused"] != shards * nb or select != (shards > 1) * nb:
        raise SystemExit(f"{tag}: B3 launched {launches['sw_fused']} times, "
                         f"B4's 3-key select {select}, in {nb} batches")
    if not launches["sort_vote_rank_rows"] or launches["sort_rows"] \
            or launches["merge_vote_rank_rows"]:
        raise SystemExit(f"{tag}: CSR key rows must take B2's monolithic "
                         "entry alone")
    refine_once_a_batch(tag, launches, nb)
    if not (last[1] >> 15).max() > 0:
        raise SystemExit(f"{tag}: no hits in the last batch")
    if not same:
        raise SystemExit(f"{tag}: CUDA and CPU engines disagree")
    emit(phase=f"{tag}_stages", **stage_breakdown(eng, dna, lens))
    return (launches, shapes), payload, payloads(eng,
                                                 batches[:1 + TIMED_MESH])


def tail_phase(proc, prefix: str, n_subjects: int, dev, entries: list):
    """The legs swissprot_tail (the index merged into one shard: CSR
    tables, the select the identity) and swissprot_tail_2shard (the
    2-shard index as written: it fails the merge check, so the per-shard
    loop on CSR tables, B4's 3-key select, B3 twice a batch), then B2's
    monolithic entry at the CSR rows each leg launched (kernel rows)."""
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import _merge_fits_direct
    from ghostm_tpu_torch.index.diskio import load_index, merge_shards
    from ghostm_tpu_torch.kernels import sort as S

    t0 = time.time()
    if proc.wait(timeout=1200) != 0:
        raise SystemExit("swissprot_tail: the index build failed")
    wait_s = time.time() - t0
    with open(prefix + ".json") as f:
        build = json.load(f)
    t0 = time.time()
    index2 = load_index(prefix)
    load_s = time.time() - t0
    t0 = time.time()
    merged = merge_shards(index2)
    merge_s = time.time() - t0
    cfg = Config(query_batch=TAIL_BATCH, seed_len=5, hits_per_seed=128)
    if _merge_fits_direct(index2, cfg):
        raise SystemExit("swissprot_tail: the 2-shard index passes the "
                         "merge check")
    # reads from 224 short and 32 long proteins (ids past n_subjects)
    rng = np.random.default_rng(11)
    source = np.concatenate([rng.choice(n_subjects, 224, replace=False),
                             n_subjects + rng.choice(N_TAIL, 32,
                                                     replace=False)])
    batches = make_batches(merged, 1 + TIMED_TAIL, cfg.query_batch,
                           source=source)
    emit(phase="swissprot_tail_setup", subjects=n_subjects + N_TAIL,
         long_subjects=N_TAIL, longest=int(merged.lengths.max()),
         residues=int(merged.total_residues),
         shard_subjects=[s.store.num_subjects for s in index2.shards],
         positions=int(sum(len(s.seeds.positions) for s in index2.shards)),
         expand=int(merged.expand_width), build_wait_s=wait_s,
         load_s=load_s, merge_s=merge_s, **build)
    runs = {}
    runs["swissprot_tail"], one, _ = tail_leg("swissprot_tail", cfg, merged,
                                              batches, 1)
    del merged
    free_cuda()
    runs["swissprot_tail_2shard"], two, wants = tail_leg(
        "swissprot_tail_2shard", cfg, index2, batches, 2)
    rows = [*range(6), *range(9, 18)]
    same = bool((one[rows] == two[rows]).all())
    emit(phase="swissprot_tail_shards", batch_reads=cfg.query_batch,
         rows_0_5_9_17_equal=same, rows_6_8_equal=bool(
             (one[6:9] == two[6:9]).all()),
         hits=int((one[0] > 0).sum()))
    if not same:
        raise SystemExit("swissprot_tail_2shard: payload rows 0-5, 9-17 "
                         "differ from swissprot_tail's")
    del index2
    free_cuda()
    # the same index and reads on a (1, 2) grid: a rank a shard, the
    # payload the per-shard loop's
    mdir = os.path.join(os.path.dirname(prefix), "mesh_tail")
    os.makedirs(mdir)
    Q = cfg.query_batch * 6
    mesh_leg("mesh_tail_1x2", prefix, cfg, batches[:1 + TIMED_MESH], wants,
             1, 2, (("sort_vote_rank_rows", None), ("sw_fused", None),
                    ("refine", None),
                    ("lex_rank_rows", SELECT_SHAPE(Q)),
                    ("lex_rank_rows", (9, cfg.query_batch, 48))), mdir)
    del wants
    # B2's monolithic entry at the CSR key rows swissprot_tail launched:
    # rows of Lq x expand keys, no presorted run, about half BIG; keys
    # below S x nbins (its own generator)
    # the rows of each leg (their own generator): a shard's expansion is
    # its own largest bucket, so the loop's rows are shorter
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    run = make_runner(dev, entries)
    for leg, shards in (("swissprot_tail", 1), ("swissprot_tail_2shard", 2)):
        (q, m), _ = max(((k[1], v) for k, v in runs[leg][1].items()
                         if k[0] == "sort_vote_rank_rows"),
                        key=lambda kv: kv[1])
        S_nbins = (n_subjects + N_TAIL) // shards * (
            (TAIL_MAX + cfg.query_frame_len) // (cfg.band_width // 2) + 2)
        k1 = torch.randint(0, S_nbins, (q, m), generator=gen, device=dev,
                           dtype=torch.int32)
        k1 = torch.where(torch.rand((q, m), generator=gen, device=dev) < 0.5,
                         torch.full_like(k1, S.BIG), k1)
        L = max(1 << (m - 1).bit_length(), 128)
        run(f"B2 sort_vote_rank_rows ({q}, {m}), CSR rows",
            "ghostm_tpu_torch/csrc/sort_vote.cu",
            "ghostm_tpu/kernels/sort.py:74",
            lambda: S.sort_vote_rank_rows(k1, 8, 1),
            lambda: S.sort_vote_rank_rows_plain(k1, 8, 1),
            None, k1.numel() * 4 + 2 * q * 8 * 4,
            sort_ops(q, L, 1, 1 + 2 * 8),
            f"2 per compare-exchange (stages 1..{L.bit_length() - 1}) "
            "+ (1 + 2 ncand) per key",
            launch=(leg, "sort_vote_rank_rows", (q, m)),
            device_ms=True, shape=[q, m, 0])
        del k1
    free_cuda()
    return runs


def free_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--subjects", type=int, default=N_SUBJECTS,
                    help="config-2 subject count (cut only for time)")
    ap.add_argument("--build-tail-index", metavar="PREFIX",
                    help=argparse.SUPPRESS)   # the child of tail_phase
    ap.add_argument("--time-select-rank", metavar="ROOT",
                    help="only time B4's select rows with the port at ROOT")
    ap.add_argument("--refine-rows", action="store_true",
                    help="only the build, R1's rows and its layout sweep")
    ap.add_argument("--time-refine", metavar="ROOT",
                    help="only time R1 with the port at ROOT")
    args = ap.parse_args()
    if args.build_tail_index:
        sys.path.insert(0, ROOT)
        secs = build_tail_index(args.subjects, args.build_tail_index)
        with open(args.build_tail_index + ".json", "w") as f:
            json.dump(secs, f)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.time_select_rank:
        emit(phase="select_rank",
             **time_select_rank(os.path.abspath(args.time_select_rank)))
        return 0
    if args.time_refine:
        time_refine(os.path.abspath(args.time_refine))
        return 0
    sys.path.insert(0, ROOT)
    from ghostm_tpu_torch.kernels import _build

    if args.refine_rows:
        card = smi()
        dev = torch.device("cuda", 0)
        emit(phase="device", name=torch.cuda.get_device_name(0), smi=card,
             torch=torch.__version__, cuda=torch.version.cuda)
        t0 = time.time()
        log = _build.build_all()["refine"]
        emit(phase="build", seconds=time.time() - t0,
             ptxas={"refine": ptxas_lines(log)})
        warm_up(dev)
        refine_rows(dev, make_runner(dev, []))
        refine_sweep(dev)
        print(card)
        return 0
    with tempfile.TemporaryDirectory() as tail_dir:
        tail = [None]   # the index build's child process, once started
        try:
            return smoke(args, _build, tail, tail_dir)
        finally:
            if tail[0] is not None and tail[0].poll() is None:
                tail[0].kill()
                tail[0].wait()


def smoke(args, _build, tail: list, tail_dir: str) -> int:
    t_all = time.time()
    card = smi()
    dev = torch.device("cuda", 0)
    emit(phase="device", name=torch.cuda.get_device_name(0), smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.time()
    logs = _build.build_all()
    ptxas = {n: ptxas_lines(log) for n, log in logs.items()}
    emit(phase="build", seconds=time.time() - t0, ptxas=ptxas)
    entries = kernel_phase(dev)
    runs = golden_phases()
    if args.subjects < N_SUBJECTS:
        emit(phase="reduced", subjects=args.subjects, of=N_SUBJECTS,
             why="command-line cut of the subject count")
    runs["scale"], index, key_table, batches, wants = scale_phase(
        args.subjects, TIMED_BATCHES)
    free_cuda()
    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.index.diskio import save_index

    # the scale index on a (2, 1) grid: each rank half of every batch
    mdir = os.path.join(tail_dir, "mesh_scale")
    os.makedirs(mdir)
    t0 = time.time()
    save_index(os.path.join(mdir, "idx"), index.shards, index.seed_len)
    emit(phase="mesh_scale_setup", save_index_s=time.time() - t0)
    cfg = Config(query_batch=8192, seed_len=5, hits_per_seed=128)
    mesh_leg("mesh_scale_2x1", os.path.join(mdir, "idx"), cfg,
             batches[:1 + TIMED_MESH], wants, 2, 1,
             (("sort_rows", None), ("merge_vote_rank_rows", None),
              ("refine", None),
              ("sw_fused", None), ("lex_rank_rows", (9, 4096, 48))), mdir)
    del wants
    shutil.rmtree(mdir)

    cfg = Config(query_batch=8192, seed_len=5, hits_per_seed=128, **B50)
    # same Lq and band as the BLOSUM62 leg: its key table and reads
    runs["scale_b50"] = score_fed_leg(
        "scale_b50", cfg, index, batches[:1 + TIMED_B50], "sw_scored",
        key_table=key_table)
    del key_table, batches
    free_cuda()
    # 250 bp reads: 84-residue frames, padded to 88 (a multiple of 8);
    # the direct table packs Lq, so this leg builds its own
    cfg = cfg.replace(query_frame_len=88)
    runs["scale_b50_250bp"] = score_fed_leg(
        "scale_b50_250bp", cfg, index,
        make_batches(index, 1 + TIMED_B50, 8192, read_len=250), "sw_wave")
    del index
    free_cuda()
    # the swissprot_tail index builds on the host, in a child process,
    # while the long-read leg runs
    prefix = os.path.join(tail_dir, "tail")
    n_tail = min(args.subjects, TAIL_SHORT)
    with open(prefix + ".log", "w") as log:
        tail[0] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--subjects",
             str(n_tail), "--build-tail-index", prefix],
            stdout=log, stderr=subprocess.STDOUT)
    runs["longread_5kbp"] = longread_phase(args.subjects)
    free_cuda()
    runs.update(tail_phase(tail[0], prefix, n_tail, dev, entries))
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_path", "launches_wrapper", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = []
    for e in entries:
        if e["launch"] is None:
            continue   # B5's int32 line: timed, not on a main path here
        path, wrapper, *shapes = e["launch"]
        counts, by_shape = runs[path]
        # launches of this row's shape; the wrapper's count at all shapes
        e["launches"] = by_shape.get((wrapper, *shapes), 0)
        e["launches_wrapper"] = counts[wrapper]
        e["launches_path"] = path
        if wrapper == "sort_rows_tiles":   # B1's long rows: + their merges
            e["launches_merge"] = sum(
                v for k, v in by_shape.items()
                if k[0] == "sort_rows_merge" and k[1] == tuple(shapes[0]))
            e["launches_kway"] = sum(
                v for k, v in by_shape.items()
                if k[0] == "sort_rows_kway" and k[1][:2] == tuple(shapes[0]))
        if e["launches"] == 0:
            raise SystemExit(f"{e['name']}: no launch on its path {path}")
        out.append({k: e[k] for k in keys + ("launches_merge",
                                              "launches_kway") if k in e})
    emit(phase="done", seconds=time.time() - t_all,
         native_calls=native_calls())
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
