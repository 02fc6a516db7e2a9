"""CLI — `python -m ghostm_tpu_torch db` / `aln`, the JAX package's flags.

`db` writes the same index files as `python -m ghostm_tpu db` (either
package reads the other's). `aln` runs on CUDA unless `--device cpu` (or
`--cpu`) is given, and fails without a GPU. `--pallas`/`--no-pallas` are
accepted and ignored (a CUDA run always launches the kernels, a CPU run
their plain versions), so the JAX package's command lines carry over.
Every `--matrix`, gap cost and `--band` of the JAX package runs (a CUDA
run takes bands up to 128 and gap costs >= 0). Long-read mode runs as in
the JAX package: `smooth_bins` and `chain_gamma` from `--config` JSON or
`--chain-gamma`, long reads with `--max-read-len`. The debug surface runs
as in the JAX package: `--check` (bounds and NaN asserts on each batch's
search before its step), `--debug-nans` (a NaN check of every stage's
floating outputs; the step computes in integers), `--profile DIR`
(torch.profiler's trace), and the variables GHOSTM_TPU_HBM_LOG and
GHOSTM_TPU_SYNC_PIPELINE (pipeline.py).

The distributed search (parallel/): torch has a process a rank, so
  * `--data-axis a --db-axis b` (a * b > 1) without `--num-processes`
    starts a * b local ranks of this command (parallel.launch.run_local),
    the JAX package's one-process mesh: rank 0 writes the table;
  * `--coordinator host:port --num-processes n --process-id i` joins this
    process as rank i of n (the JAX package's multi-process run; it needs
    --checkpoint-batches);
  * `--cpu N` is `--device cpu` with at most N local ranks (the JAX
    package's N CPU devices): a grid of more ranks raises its "needs N
    devices".
A rank's device is cuda:{local rank % cards}. A rank that fails fails the
run. GHOSTM_TPU_LAUNCH_COUNTS=PREFIX: each `aln` process writes its kernel
launch counts to PREFIX.r{rank}.json at its end (chip_smoke.py reads the
counts of the ranks a grid run starts).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("ghostm_tpu_torch")

def _add_common(p):
    p.add_argument("-k", "--seed-len", type=int, default=None)
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--log-json", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="check every stage's floating outputs for NaN (the "
                        "search step computes in integers)")
    p.add_argument("--cpu", type=int, nargs="?", const=8, default=None,
                   metavar="N", help="run on the CPU with at most N local "
                                     "ranks (the JAX package's N CPU "
                                     "devices; default 8)")


def _config_from_args(args, **overrides) -> Config:
    base = {}
    if args.config:
        with open(args.config) as f:
            base = json.load(f)
    if args.seed_len is not None:
        base["seed_len"] = args.seed_len
    base.update({k: v for k, v in overrides.items() if v is not None})
    return Config(**base)


def cmd_db(args) -> int:
    from ghostm_tpu_torch.index import diskio, seeds, store
    from ghostm_tpu_torch.io.fasta import iter_fasta
    from ghostm_tpu_torch.ops.encode import encode_aa

    cfg = _config_from_args(args, shards=args.shards)
    t0 = time.time()
    records = list(iter_fasta(args.input))
    log.info("read %d subjects (%.1fs)", len(records), time.time() - t0)
    # Global per-k-mer bucket truncation BEFORE sharding, so the surviving
    # seed set is shard-layout invariant (index/seeds.py).
    codes = [encode_aa(seq) for _, seq in records]
    lens = np.array([len(c) for c in codes], dtype=np.int64)
    keep = seeds.bucket_keep(
        np.concatenate(codes) if codes else np.zeros(0, np.int8), lens,
        cfg.seed_len, cfg.hits_per_seed,
    )
    assign = store.shard_records(records, cfg.shards)
    shards = []
    for ids in assign:
        st = store.build_store(
            [records[i] for i in ids], cfg.sentinel_pad, subject_ids=ids
        )
        keep_buf = seeds.buffer_keep(
            keep, lens, cfg.seed_len, ids, st.starts, len(st.buffer)
        )
        shards.append(
            diskio.IndexShard(
                st, seeds.build_seed_index(st.buffer, cfg.seed_len, keep_buf)
            )
        )
    diskio.save_index(args.output, shards, cfg.seed_len)
    log.info(
        "index written: %d shards, %d residues, %.1fs",
        len(shards),
        sum(s.store.total_residues for s in shards),
        time.time() - t0,
    )
    return 0


def cmd_aln(args) -> int:
    import torch

    from ghostm_tpu_torch.engine import SearchEngine, check_mesh
    from ghostm_tpu_torch.index.diskio import index_shards, load_index
    from ghostm_tpu_torch.io.fasta import read_batches
    from ghostm_tpu_torch.parallel import launch, mesh as pm
    from ghostm_tpu_torch.pipeline import run_search

    cfg = _config_from_args(
        args,
        band_width=args.band,
        candidates_per_frame=args.candidates,
        max_hits=args.max_hits,
        evalue_cutoff=args.evalue,
        query_batch=args.batch,
        matrix=args.matrix,
        gap_open=args.gap_open,
        gap_extend=args.gap_extend,
        checkpoint_batches=args.checkpoint_batches,
        chain_gamma=args.chain_gamma,
        check=args.check or None,
        profile_dir=args.profile,
        data_axis=args.data_axis,
        db_axis=args.db_axis,
    )
    device = "cpu" if args.cpu else args.device
    data, db = cfg.data_axis, cfg.db_axis
    nproc = args.num_processes
    mesh = None
    if nproc and nproc > 1:
        # one rank of a run of nproc processes: the checkpoint rule is
        # checked before joining, so a refused run waits for no peer
        if not args.local_ranks and cfg.checkpoint_batches <= 0:
            raise ValueError(
                "multi-process runs need checkpoint_batches > 0 "
                "(per-batch row-addressed result parts)"
            )
        pm.init_distributed(args.coordinator, nproc, args.process_id,
                            device=device)
        device = pm.rank_device(device, args.process_id)
        mesh = pm.make_mesh(data, db, local_ranks=args.local_ranks)
    elif data * db > 1:
        # the one-run grid: check what each rank would refuse, then start
        # the ranks
        if args.cpu:
            pm.check_grid(data, db, args.cpu)
        elif device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass --device "
                               "cpu or --cpu N")
        check_mesh(cfg, index_shards(args.db), data, db)
        return launch.run_local(args.argv, data * db)
    elif nproc:
        mesh = pm.make_mesh(data, db)      # one process: a 1x1 grid
    index = load_index(args.db)
    if cfg.seed_len != index.seed_len:
        cfg = cfg.replace(seed_len=index.seed_len)
    engine = SearchEngine(cfg, index, device=device, mesh=mesh)
    log.info("engine: %d shard(s)%s, %s seed tables of width %d%s",
             engine.n_shards,
             " (merged at init)" if engine.merged_colocated else "",
             engine.table_mode, engine.table_width,
             "" if mesh is None else
             f", grid ({data}x{db}) rank {mesh.rank} on {engine.device}")
    n = run_search(
        engine,
        read_batches(args.input, cfg.query_batch, args.max_read_len),
        args.output,
        resume=args.resume,
    )
    log.info("wrote %d hit rows -> %s", n, args.output)
    counts = os.environ.get("GHOSTM_TPU_LAUNCH_COUNTS")
    if counts:
        from ghostm_tpu_torch.kernels import _build

        with open(f"{counts}.r{0 if mesh is None else mesh.rank}.json",
                  "w") as f:
            json.dump(dict(launches=_build.LAUNCHES, shapes=[
                [k[0], [list(x) for x in k[1:]], v]
                for k, v in _build.SHAPES.items()]), f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ghostm_tpu_torch",
        description="metagenomic homology search (GHOSTM-class), "
                    "PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="mode", required=True)

    pd = sub.add_parser("db", help="build a database index")
    pd.add_argument("-i", "--input", required=True, help="protein FASTA")
    pd.add_argument("-o", "--output", required=True, help="index prefix")
    pd.add_argument("--shards", type=int, default=None)
    _add_common(pd)
    pd.set_defaults(fn=cmd_db)

    pa = sub.add_parser("aln", help="search reads against an index")
    pa.add_argument("-d", "--db", required=True, help="index prefix")
    pa.add_argument("-i", "--input", required=True, help="DNA reads FASTA/FASTQ")
    pa.add_argument("-o", "--output", required=True, help="output TSV")
    pa.add_argument("-b", "--band", type=int, default=None)
    pa.add_argument("-n", "--candidates", type=int, default=None)
    pa.add_argument("--max-hits", type=int, default=None)
    pa.add_argument("-e", "--evalue", type=float, default=None)
    pa.add_argument("--matrix", type=str, default=None,
                    help="substitution matrix (BLOSUM45/50/62/80/90, "
                         "PAM30/70/250); BLOSUM62 runs the fused SW kernel, "
                         "the others the score-fed ones")
    pa.add_argument("--gap-open", type=int, default=None)
    pa.add_argument("--gap-extend", type=int, default=None)
    pa.add_argument("--batch", type=int, default=None)
    pa.add_argument("--max-read-len", type=int, default=120)
    pa.add_argument("--chain-gamma", type=int, default=None,
                    help="> 0: collinear seed chaining with this drift "
                         "penalty (long-read mode)")
    pa.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) launches the CUDA kernels; cpu runs "
                         "their plain PyTorch versions")
    pa.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                    default=None, help="accepted and ignored")
    pa.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="torch.profiler trace of the batch loop, written "
                         "to DIR/trace.json")
    pa.add_argument("--check", action="store_true",
                    help="debug: bounds and NaN asserts on each batch's "
                         "search before its step (raise on a violation)")
    pa.add_argument("--resume", action="store_true",
                    help="resume from per-batch checkpoint parts")
    pa.add_argument("--checkpoint-batches", type=int, default=None,
                    help=">0: write results in per-batch parts with a cursor")
    pa.add_argument("--data-axis", type=int, default=None,
                    help="grid size along 'data' (query data-parallel)")
    pa.add_argument("--db-axis", type=int, default=None,
                    help="grid size along 'db' (a rank an index shard)")
    pa.add_argument("--coordinator", type=str, default=None,
                    help="host:port of rank 0 (multi-process)")
    pa.add_argument("--num-processes", type=int, default=None)
    pa.add_argument("--process-id", type=int, default=None)
    # set on the ranks run_local starts: the one-run grid
    pa.add_argument("--local-ranks", action="store_true",
                    help=argparse.SUPPRESS)
    _add_common(pa)
    pa.set_defaults(fn=cmd_aln)

    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    args.argv = argv
    setup_logging(json_lines=args.log_json, verbose=args.verbose)
    if args.debug_nans:
        from ghostm_tpu_torch import engine

        engine.DEBUG_NANS = True
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
