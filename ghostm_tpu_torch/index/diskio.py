"""Index (de)serialisation (SURVEY.md §2 "Index (de)serializer").

On-disk format (per DB prefix):
  <prefix>.manifest.json   — format version, config echo, per-shard sizes
  <prefix>.shard{i}.npz    — buffer/starts/lengths/subject_ids/names +
                             positions/bucket_starts (the seed index)

Each shard is self-contained so a multi-host job loads only its own shards
(SURVEY.md §3.3). `stack_shards` pads every shard to the max shard size and
stacks along a leading axis — the static-shape form the device mesh consumes
(pad positions point at the leading sentinel run, so even an unmasked lookup
lands on un-alignable residues).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np

from ghostm_tpu_torch.index.seeds import SeedIndex
from ghostm_tpu_torch.index.store import SubjectStore
from ghostm_tpu_torch.ops.encode import SENTINEL

FORMAT_VERSION = 1


@dataclasses.dataclass
class IndexShard:
    store: SubjectStore
    seeds: SeedIndex


@dataclasses.dataclass
class StackedIndex:
    """Device-ready stacked form: leading axis = shard.

    `starts`/`subject_ids` let the DEVICE map an alignment endpoint (a global
    buffer position) to a global subject id + subject-local offset, which is
    what makes top-k merge keys shard-invariant (SURVEY.md §7.2)."""
    seed_len: int
    buffers: np.ndarray        # (n_shards, Bmax) int8
    positions: np.ndarray      # (n_shards, Pmax) int32
    bucket_starts: np.ndarray  # (n_shards, 20**k + 2) int32
    starts: np.ndarray         # (n_shards, Smax) int32, pad = Bmax+1
    subject_ids: np.ndarray    # (n_shards, Smax) int32, pad = 1<<30 (sorted!)
    lengths: np.ndarray        # (n_shards, Smax) int32, pad = 0
    shards: List[IndexShard]   # host-side metadata for reporting
    total_residues: int        # whole-DB residue count (E-value search space)
    expand_width: int          # max seed-bucket length across shards (the
                               # static per-seed hit expansion that makes
                               # lookup lossless after build-time truncation)


def save_index(prefix: str, shards: List[IndexShard], seed_len: int) -> None:
    manifest = {
        "format_version": FORMAT_VERSION,
        "seed_len": seed_len,
        "n_shards": len(shards),
        "shards": [
            {
                "buffer_len": len(sh.store.buffer),
                "num_positions": sh.seeds.num_positions,
                "num_subjects": sh.store.num_subjects,
                "residues": sh.store.total_residues,
            }
            for sh in shards
        ],
    }
    with open(f"{prefix}.manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    for i, sh in enumerate(shards):
        np.savez(
            f"{prefix}.shard{i}.npz",
            buffer=sh.store.buffer,
            starts=sh.store.starts,
            lengths=sh.store.lengths,
            subject_ids=sh.store.subject_ids,
            names=np.array(sh.store.names, dtype=object),
            positions=sh.seeds.positions,
            bucket_starts=sh.seeds.bucket_starts,
        )


def index_shards(prefix: str) -> int:
    """The shard count of the index at `prefix` (its manifest alone)."""
    with open(f"{prefix}.manifest.json") as f:
        return int(json.load(f)["n_shards"])


def load_index(prefix: str) -> StackedIndex:
    with open(f"{prefix}.manifest.json") as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"index format {manifest['format_version']} unsupported")
    k = manifest["seed_len"]
    shards: List[IndexShard] = []
    for i in range(manifest["n_shards"]):
        z = np.load(f"{prefix}.shard{i}.npz", allow_pickle=True)
        store = SubjectStore(
            buffer=z["buffer"],
            starts=z["starts"],
            lengths=z["lengths"],
            subject_ids=z["subject_ids"],
            names=[str(n) for n in z["names"]],
        )
        shards.append(IndexShard(store, SeedIndex(k, z["positions"], z["bucket_starts"])))
    return stack_shards(shards, k)


def merge_shards(index: StackedIndex) -> StackedIndex:
    """Merge ALL shards of an index into ONE logical shard, byte-identical
    to what a `db --shards 1` build of the same records would produce.

    Why this is sound: the per-k-mer bucket truncation is applied GLOBALLY
    before sharding (seeds.bucket_keep), so the union of the
    shards' seed sets IS the 1-shard seed set, and the engine's
    shard-invariance contract (SURVEY.md §7.2, tests/test_distributed.py)
    makes the merged search bit-identical to the sharded one. The engine
    uses this on the single-device loop path, where searching n shards
    sequentially costs ~n x the propose/align work of one shard
    (VERDICT r04 missing #2: 2-shard colocated ran at ~53% of 1-shard
    throughput) — after merging it runs at exactly 1-shard cost.

    Cost: a few vectorised passes over the residue/position arrays
    (~10-30 s at 570k-seq/200M-residue scale), paid once at engine init.
    """
    shards = index.shards
    if len(shards) <= 1:
        return index
    k = index.seed_len
    pads = {int(s.store.starts[0]) for s in shards if s.store.num_subjects}
    if len(pads) != 1:
        raise ValueError("cannot merge: shards disagree on sentinel pad")
    pad = pads.pop()
    ids = np.concatenate(
        [np.asarray(s.store.subject_ids, np.int64) for s in shards]
    )
    lens_c = np.concatenate(
        [np.asarray(s.store.lengths, np.int64) for s in shards]
    )
    src_start = np.concatenate(
        [np.asarray(s.store.starts, np.int64) for s in shards]
    )
    nsub = np.array([s.store.num_subjects for s in shards], np.int64)
    buf_lens = np.array([len(s.store.buffer) for s in shards], np.int64)
    base = np.zeros(len(shards), np.int64)
    np.cumsum(buf_lens[:-1], out=base[1:])
    shard_of = np.repeat(np.arange(len(shards)), nsub)
    if not len(ids):
        return index
    order = np.argsort(ids, kind="stable")   # merged row = global-id rank
    ids_m = ids[order]
    lens_m = lens_c[order]
    S = len(ids_m)
    starts_m = np.zeros(S, np.int64)
    np.cumsum(lens_m[:-1] + pad, out=starts_m[1:])
    starts_m += pad
    total = int(starts_m[-1] + lens_m[-1] + pad)
    if total >= (1 << 31):
        raise ValueError("merged buffer exceeds int32 positions")
    buf = np.full(total, SENTINEL, np.int8)
    bigbuf = np.concatenate([s.store.buffer for s in shards])
    srcg_m = (src_start + base[shard_of])[order]
    # residue copy, vectorised in subject chunks (bounds the temp arrays)
    CH = 200_000
    for i0 in range(0, S, CH):
        sl = slice(i0, min(S, i0 + CH))
        l = lens_m[sl]
        n_res = int(l.sum())
        if not n_res:
            continue
        rep = np.repeat(np.arange(len(l)), l)
        cum0 = np.zeros(len(l), np.int64)
        np.cumsum(l[:-1], out=cum0[1:])
        within = np.arange(n_res, dtype=np.int64) - cum0[rep]
        buf[starts_m[sl][rep] + within] = bigbuf[srcg_m[sl][rep] + within]
    names_c = [n for s in shards for n in s.store.names]
    names_m = [names_c[j] for j in order]
    store = SubjectStore(
        buffer=buf, starts=starts_m, lengths=lens_m.astype(np.int32),
        subject_ids=ids_m.astype(np.int32), names=names_m,
    )
    # merged row of each concat-order subject (for position remapping)
    inv = np.empty(S, np.int64)
    inv[order] = np.arange(S)
    # seed positions: map each shard's positions into merged coordinates
    # (subject-constant delta, repeated over buffer spans — no searchsorted;
    # leading pad folds into subject 0, no seeds fall there), then ONE sort
    # of (bucket << 31 | new_pos) keys reproduces the 1-shard CSR order
    # (within-bucket ascending position == ascending (subject id, offset)).
    nb = shards[0].seeds.num_buckets
    key_parts = []
    counts_m = np.zeros(nb + 1, np.int64)
    off = 0
    for si, s in enumerate(shards):
        st = s.store
        bs = np.asarray(s.seeds.bucket_starts, np.int64)
        counts = np.diff(bs)                       # (nb + 1,) incl overflow
        counts_m += counts
        pos = np.asarray(s.seeds.positions, np.int64)
        rows = inv[off : off + st.num_subjects]
        delta = starts_m[rows] - np.asarray(st.starts, np.int64)
        spans = np.diff(
            np.asarray(st.starts, np.int64), append=np.int64(len(st.buffer))
        ).copy()
        spans[0] += int(st.starts[0])
        dmap = np.repeat(delta, spans)
        newpos = pos + dmap[pos]
        bid = np.repeat(np.arange(nb + 1, dtype=np.int64), counts)
        key_parts.append((bid << 31) | newpos)
        off += st.num_subjects
    keys = np.concatenate(key_parts) if key_parts else np.zeros(0, np.int64)
    keys.sort()
    positions = (keys & ((1 << 31) - 1)).astype(np.int32)
    bsm = np.zeros(nb + 2, np.int64)
    np.cumsum(counts_m, out=bsm[1:])
    merged = IndexShard(
        store, SeedIndex(k, positions, bsm.astype(np.int32))
    )
    return stack_shards([merged], k)


def stack_shards(shards: List[IndexShard], seed_len: int) -> StackedIndex:
    n = len(shards)
    bmax = max(len(s.store.buffer) for s in shards)
    pmax = max(1, max(s.seeds.num_positions for s in shards))
    # Round up so device arrays tile cleanly regardless of shard content.
    bmax = -(-bmax // 128) * 128
    pmax = -(-pmax // 128) * 128
    buffers = np.full((n, bmax), SENTINEL, dtype=np.int8)
    positions = np.zeros((n, pmax), dtype=np.int32)
    nb = shards[0].seeds.bucket_starts.shape[0]
    bucket_starts = np.zeros((n, nb), dtype=np.int32)
    smax = max(s.store.num_subjects for s in shards)
    starts = np.full((n, smax), bmax + 1, dtype=np.int32)
    subject_ids = np.full((n, smax), 1 << 30, dtype=np.int32)
    lengths = np.zeros((n, smax), dtype=np.int32)
    for i, s in enumerate(shards):
        buffers[i, : len(s.store.buffer)] = s.store.buffer
        positions[i, : s.seeds.num_positions] = s.seeds.positions
        bucket_starts[i] = s.seeds.bucket_starts
        ns = s.store.num_subjects
        starts[i, :ns] = s.store.starts
        subject_ids[i, :ns] = s.store.subject_ids
        lengths[i, :ns] = s.store.lengths
        if ns and not (np.diff(s.store.subject_ids) > 0).all():
            raise ValueError("shard subject_ids must be strictly increasing")
    total = sum(s.store.total_residues for s in shards)
    expand = max(1, max(s.seeds.max_bucket_len for s in shards))
    return StackedIndex(
        seed_len, buffers, positions, bucket_starts, starts, subject_ids,
        lengths, shards, total, expand,
    )


def index_from_arrays(index) -> StackedIndex:
    """The port's StackedIndex from any StackedIndex-shaped object (the JAX
    package's, built in the same process) by duck typing: the stacked numpy
    fields, total_residues and expand_width are taken as they are, and each
    shard's store and seed arrays and names are rebuilt as this package's
    types. Lets one in-memory index serve both engines without a disk round
    trip; nothing of the other package is imported."""
    shards = [
        IndexShard(
            SubjectStore(
                buffer=np.asarray(sh.store.buffer),
                starts=np.asarray(sh.store.starts),
                lengths=np.asarray(sh.store.lengths),
                subject_ids=np.asarray(sh.store.subject_ids),
                names=[str(n) for n in sh.store.names],
            ),
            SeedIndex(int(index.seed_len), np.asarray(sh.seeds.positions),
                      np.asarray(sh.seeds.bucket_starts)),
        )
        for sh in index.shards
    ]
    return StackedIndex(
        int(index.seed_len), np.asarray(index.buffers),
        np.asarray(index.positions), np.asarray(index.bucket_starts),
        np.asarray(index.starts), np.asarray(index.subject_ids),
        np.asarray(index.lengths), shards, int(index.total_residues),
        int(index.expand_width),
    )
