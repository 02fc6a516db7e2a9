"""Seed index: direct-addressed k-mer buckets over the subject buffer.

Reference equivalent: GHOSTM's sorted fixed-length seed index / depth-k
suffix array (SURVEY.md §1.1 step 1, §2 "DB builder: seed index"). TPU-native
re-design: instead of binary-searching a sorted key list on device (random
branchy probes), we store

  - ``positions``     (P,) int32 — every valid seed position in the buffer,
                      sorted by (k-mer key, position);
  - ``bucket_starts`` (20**k + 2,) int32 — CSR offsets per key, with one
                      extra EMPTY bucket at index 20**k that invalid query
                      seeds are routed to.

Device-side lookup is then two contiguous gathers (bucket_starts[key],
bucket_starts[key+1]) + a strided slice of positions — no search loop at all,
which is the layout the TPU's vector memory system likes (SURVEY.md §7.2
"Random gather on TPU").

Keys use base 20: only the 20 standard amino acids form seeds (codes >= 20 —
B/Z/X/*/sentinel — never seed, matching seed-and-extend family convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ghostm_tpu_torch import native

NUM_SEED_AA = 20


@dataclasses.dataclass
class SeedIndex:
    seed_len: int
    positions: np.ndarray      # (P,) int32
    bucket_starts: np.ndarray  # (20**k + 2,) int32

    @property
    def num_buckets(self) -> int:
        return NUM_SEED_AA**self.seed_len

    @property
    def num_positions(self) -> int:
        return len(self.positions)

    @property
    def max_bucket_len(self) -> int:
        nb = self.num_buckets
        if not len(self.positions):
            return 0
        return int(
            (self.bucket_starts[1 : nb + 1] - self.bucket_starts[:nb]).max()
        )


def kmer_keys(buf: np.ndarray, k: int) -> np.ndarray:
    """(len(buf) - k + 1,) int32 keys; invalid windows (any code >= 20) get
    key == 20**k (the empty overflow bucket). int32 arithmetic throughout
    (20**5 < 2**31); int64 numpy ops are ~3x slower on the build host."""
    buf = np.asarray(buf)
    if buf.dtype != np.int8:
        buf = buf.astype(np.int8)
    n = len(buf) - k + 1
    if n <= 0:
        return np.zeros((0,), dtype=np.int32)
    keys = np.zeros(n, dtype=np.int32)
    valid = np.ones(n, dtype=bool)
    for t in range(k):
        c = buf[t : t + n]
        keys *= NUM_SEED_AA
        keys += np.minimum(np.maximum(c, 0), NUM_SEED_AA - 1).astype(np.int32)
        valid &= c < NUM_SEED_AA
    keys[~valid] = NUM_SEED_AA**k
    return keys


def _mix(x: np.ndarray) -> np.ndarray:
    """Deterministic 32-bit integer hash (splitmix-style avalanche);
    uint32 wrap-around arithmetic (uint64 numpy is much slower)."""
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x45D9F3B)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x45D9F3B)
    return x ^ (x >> np.uint32(16))


def bucket_keep(codes: np.ndarray, lens: np.ndarray, k: int,
                cap: int) -> np.ndarray:
    """Decide, GLOBALLY and before sharding, which seed positions survive the
    per-k-mer cap (reference analogue: GHOSTM limits hits for high-frequency
    seeds). Survivors are chosen by a deterministic HASH of the global
    (subject id, offset) — a pure function of layout-invariant identifiers,
    so the surviving set (and every vote count downstream) is identical for
    ANY shard layout (SURVEY.md §7.2) while sampling each bucket uniformly
    across subjects (plain id-order would make late subjects unfindable in
    over-full buckets).

    Args:
      codes: the encoded subjects concatenated in GLOBAL id order (int8).
      lens: their lengths.
      cap: max kept positions per k-mer bucket (Config.hits_per_seed).
    Returns:
      the keep flags of every subject's max(len - k + 1, 0) windows,
      concatenated in the same order (buffer_keep maps them into a store).
    """
    lens = np.asarray(lens, np.int64)
    nb = NUM_SEED_AA**k
    # One vectorised pass: k-1 invalid separators between subjects, so
    # k-mer windows never cross records (per-record python loops cost
    # minutes at 570k-record scale).
    sep = k - 1
    tot = int(lens.sum()) + sep * len(lens)
    cat = np.full(tot, NUM_SEED_AA, dtype=np.int8)  # invalid filler
    starts = np.cumsum(lens + sep) - (lens + sep)
    cat[starts.repeat(lens) + _ragged_arange(lens)] = codes
    all_keys = kmer_keys(cat, k) if len(cat) >= k else np.zeros(0, np.int32)
    klens = np.maximum(lens - k + 1, 0)
    key_idx = starts.repeat(klens) + _ragged_arange(klens)
    rec_keys = all_keys[key_idx]                      # per-record valid rows
    gsid = np.repeat(np.arange(len(lens), dtype=np.int64), klens)
    offset = _ragged_arange(klens)
    prio = _mix(gsid.astype(np.uint32) * np.uint32(1_000_003)
                + offset.astype(np.uint32))
    # Stable sort on packed (key, hash): ties fall back to enumeration
    # order == (gsid, offset) order — deterministic and layout-invariant.
    packed = (rec_keys.astype(np.int64) << 32) | prio.astype(np.int64)
    order = np.argsort(packed, kind="stable")
    sorted_keys = rec_keys[order]
    bucket_starts = np.searchsorted(sorted_keys, np.arange(nb + 1))
    rank = np.empty(len(rec_keys), dtype=np.int64)
    rank[order] = np.arange(len(rec_keys)) - bucket_starts[
        np.clip(sorted_keys, 0, nb)
    ]
    return (rank < cap) & (rec_keys < nb)


def buffer_keep(keep: np.ndarray, lens: np.ndarray, k: int, ids,
                starts: np.ndarray, size: int) -> np.ndarray:
    """bucket_keep's flags (`keep`, over subjects of lengths `lens` in
    global id order) as the (size,) bool mask over a store buffer that
    holds the subjects `ids` (global ids), subject r from starts[r]: the
    `keep` argument of build_seed_index."""
    klens = np.maximum(np.asarray(lens, np.int64) - k + 1, 0)
    first = np.cumsum(klens) - klens
    ids = np.asarray(ids, np.int64)
    kl = klens[ids]
    within = _ragged_arange(kl)
    mask = np.zeros(size, dtype=bool)
    mask[np.asarray(starts, np.int64).repeat(kl) + within] = keep[
        first[ids].repeat(kl) + within
    ]
    return mask


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """concatenate([arange(l) for l in lens]) without the python loop."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    out = np.ones(total, dtype=np.int64)
    ends = np.cumsum(lens)
    starts_at = ends - lens
    out[0] = 0
    nz = lens > 0
    first_idx = starts_at[nz]
    out[first_idx[1:]] = 1 - lens[nz][:-1]
    return np.cumsum(out)


def build_seed_index(buf: np.ndarray, k: int, keep: np.ndarray | None = None) -> SeedIndex:
    """Sort-free CSR build: bincount keys -> cumsum -> stable scatter.

    `keep`: optional bool mask over buffer positions (len >= len(buf)-k+1)
    from bucket_keep, mapped into shard-buffer coordinates (buffer_keep).

    Takes the native counting sort (ghostm_tpu_torch.native.kmer_csr) when
    the host library is built; the numpy path below gives the same arrays.
    """
    res = native.kmer_csr(buf, k, keep)
    if res is not None:
        return SeedIndex(k, *res)
    keys = kmer_keys(buf, k)
    valid = keys < NUM_SEED_AA**k
    if keep is not None:
        valid &= keep[: len(keys)]
    vkeys = keys[valid]
    vpos = np.nonzero(valid)[0].astype(np.int32)
    counts = np.bincount(vkeys, minlength=NUM_SEED_AA**k)
    bucket_starts = np.zeros(NUM_SEED_AA**k + 2, dtype=np.int64)
    np.cumsum(counts, out=bucket_starts[1 : NUM_SEED_AA**k + 1])
    bucket_starts[NUM_SEED_AA**k + 1] = bucket_starts[NUM_SEED_AA**k]
    # Positions sorted by (key, pos): vpos is already position-ordered, so a
    # stable argsort on key alone preserves position order within buckets.
    order = np.argsort(vkeys, kind="stable")
    positions = vpos[order]
    return SeedIndex(k, positions.astype(np.int32), bucket_starts.astype(np.int32))
