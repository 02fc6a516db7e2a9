"""CLI — `python -m ghostm_tpu_torch db` / `aln`, the JAX package's flags.

`db` writes the same index files as `python -m ghostm_tpu db` (either
package reads the other's). `aln` runs on CUDA unless `--device cpu` is
given, and fails without a GPU. `--pallas`/`--no-pallas` are accepted and
ignored (a CUDA run always launches the kernels, a CPU run their plain
versions), so the JAX package's command lines carry over. Every
`--matrix`, gap cost and `--band` of the JAX package runs (a CUDA run takes
bands up to 128 and gap costs >= 0). Long-read mode runs as in the JAX
package: `smooth_bins` and `chain_gamma` from `--config` JSON or
`--chain-gamma`, long reads with `--max-read-len`. The debug surface runs
as in the JAX package: `--check` (bounds and NaN asserts on each batch's
search before its step), `--debug-nans` (a NaN check of every stage's
floating outputs; the step computes in integers), `--profile DIR`
(torch.profiler's trace), and the variables GHOSTM_TPU_HBM_LOG and
GHOSTM_TPU_SYNC_PIPELINE (pipeline.py). The mesh and multi-process flags
(`--data-axis` / `--db-axis` above 1, `--coordinator`, `--num-processes`,
`--process-id`) and `--cpu` are not ported yet and are rejected.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np

from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("ghostm_tpu_torch")

# flags of the JAX package's CLI this port does not support yet
_NOT_PORTED = (
    ("cpu", "--cpu"), ("coordinator", "--coordinator"),
    ("num_processes", "--num-processes"), ("process_id", "--process-id"),
)


def _add_common(p):
    p.add_argument("-k", "--seed-len", type=int, default=None)
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--log-json", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="check every stage's floating outputs for NaN (the "
                        "search step computes in integers)")
    p.add_argument("--cpu", type=int, nargs="?", const=8, default=None,
                   metavar="N", help="JAX mesh testing: not ported (rejected)")


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
    from ghostm_tpu_torch.engine import SearchEngine
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.io.fasta import read_batches
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
    )
    index = load_index(args.db)
    if cfg.seed_len != index.seed_len:
        cfg = cfg.replace(seed_len=index.seed_len)
    engine = SearchEngine(cfg, index, device=args.device)
    log.info("engine: %d shard(s)%s, %s seed tables of width %d",
             engine.n_shards,
             " (merged at init)" if engine.merged_colocated else "",
             engine.table_mode, engine.table_width)
    n = run_search(
        engine,
        read_batches(args.input, cfg.query_batch, args.max_read_len),
        args.output,
        resume=args.resume,
    )
    log.info("wrote %d hit rows -> %s", n, args.output)
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
                    help="mesh axes: only 1 (no mesh) is ported")
    pa.add_argument("--db-axis", type=int, default=None,
                    help="mesh axes: only 1 (no mesh) is ported")
    pa.add_argument("--coordinator", type=str, default=None,
                    help="multi-process: not ported yet (rejected)")
    pa.add_argument("--num-processes", type=int, default=None)
    pa.add_argument("--process-id", type=int, default=None)
    _add_common(pa)
    pa.set_defaults(fn=cmd_aln)

    args = ap.parse_args(argv)
    for attr, flag in _NOT_PORTED:
        if getattr(args, attr, None):
            ap.error(f"{flag} is not ported yet")
    for attr, flag in (("data_axis", "--data-axis"), ("db_axis", "--db-axis")):
        if (getattr(args, attr, None) or 1) > 1:
            ap.error(f"{flag} > 1 (the device mesh) is not ported yet")
    setup_logging(json_lines=args.log_json, verbose=args.verbose)
    if args.debug_nans:
        from ghostm_tpu_torch import engine

        engine.DEBUG_NANS = True
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
