"""Packed subject store (SURVEY.md §2 "DB builder: sequence store").

TPU-native layout: ALL subject residues of a shard live in ONE concatenated
int8 buffer with `sentinel_pad` SENTINEL codes between (and around) subjects.
Consequences the rest of the engine relies on:

  - a single global position identifies (subject, offset) — diagonal voting
    and banded SW work in global coordinates with no per-subject logic;
  - sentinels score LOW (ops.scoring), so a banded alignment window that
    straddles two subjects can never profitably cross the boundary — no
    masking needed in the SW kernel;
  - `pos -> subject` is a searchsorted over `starts` (host-side, tiny: only
    for the final reported hits).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from ghostm_tpu_torch.ops.encode import SENTINEL, encode_aa


@dataclasses.dataclass
class SubjectStore:
    buffer: np.ndarray        # (B,) int8, sentinel-separated residues
    starts: np.ndarray        # (S,) int64 — start of each subject in buffer
    lengths: np.ndarray       # (S,) int32
    subject_ids: np.ndarray   # (S,) int32 — GLOBAL subject ids (shard-stable)
    names: List[str]

    @property
    def num_subjects(self) -> int:
        return len(self.starts)

    @property
    def total_residues(self) -> int:
        return int(self.lengths.sum())

    def pos_to_subject(self, pos: np.ndarray) -> np.ndarray:
        """Global buffer position -> local subject row (host-side)."""
        return np.searchsorted(self.starts, np.asarray(pos), side="right") - 1

    def subject_seq(self, row: int) -> np.ndarray:
        s = int(self.starts[row])
        return self.buffer[s : s + int(self.lengths[row])]


def build_store(
    records: Iterable[Tuple[str, bytes]],
    sentinel_pad: int,
    subject_ids: Sequence[int] | None = None,
) -> SubjectStore:
    names, seqs = [], []
    for name, seq in records:
        names.append(name)
        seqs.append(encode_aa(seq))
    n = len(seqs)
    ids = np.asarray(
        subject_ids if subject_ids is not None else np.arange(n), dtype=np.int32
    )
    total = sentinel_pad + sum(len(s) + sentinel_pad for s in seqs)
    buffer = np.full(total, SENTINEL, dtype=np.int8)
    starts = np.zeros(n, dtype=np.int64)
    lengths = np.zeros(n, dtype=np.int32)
    cur = sentinel_pad
    for i, s in enumerate(seqs):
        starts[i] = cur
        lengths[i] = len(s)
        buffer[cur : cur + len(s)] = s
        cur += len(s) + sentinel_pad
    return SubjectStore(buffer, starts, lengths, ids, names)


def shard_records(
    records: Sequence[Tuple[str, bytes]], n_shards: int
) -> List[List[int]]:
    """Balanced contiguous-ish sharding by residue count (greedy round-robin
    over length-sorted subjects keeps shards within ~1 subject of balanced).
    Returns, per shard, the list of GLOBAL subject indices assigned to it."""
    order = sorted(range(len(records)), key=lambda i: -len(records[i][1]))
    loads = [0] * n_shards
    assign: List[List[int]] = [[] for _ in range(n_shards)]
    for gi in order:
        s = loads.index(min(loads))
        assign[s].append(gi)
        loads[s] += len(records[gi][1])
    for a in assign:
        a.sort()  # deterministic order within shard
    return assign
