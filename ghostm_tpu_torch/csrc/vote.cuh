// Kernel B2's run-length vote and top ncand, shared by its two entries:
// merge_vote.cu (the union of two sorted rows) and sort_vote.cu (one row
// sorted by B1's network; an empty second list). B1's merge passes at long
// rows (sort_rows.cu) take co_rank alone.
//
// A group of NW warps votes one row held sorted in shared memory:
//  * The valid prefix of each list (keys < BIG) is found by one binary
//    search; the invalid tail never votes.
//  * Thread t takes merged positions [t c, (t + 1) c), c = ceil(n / 32 NW),
//    finds its start in a and b by a co-rank (merge-path) search, and
//    merges its keys sequentially, counting run lengths as it goes. A run
//    belongs to the thread where it starts: a thread skips a run carried in
//    from the previous span, and extends its last run past its span with
//    one upper_bound in a and one in b.
//  * Each run of >= min_votes is one 32-bit word, votes << 14 | (16383 -
//    its merged position p): a run's position orders it as its key does,
//    so the top ncand by (votes desc, key asc) are the ncand largest words.
//    Each thread keeps its NC largest in registers (NC = 8, 32 or
//    128 >= ncand); each warp merges its lanes' lists by ncand warp maxima
//    (one redux.sync each); after one group barrier warp 0 merges the NW
//    warps' lists the same way, and each output slot finds its key at
//    merged position p by one more co-rank search.
#pragma once

#include "bitonic.cuh"

namespace {

constexpr int MAX_NCAND = 128;
constexpr int POS_BITS = 14;   // merged positions < La + Mb <= 16384
constexpr uint32_t POS_MASK = (1u << POS_BITS) - 1;

__device__ __forceinline__ uint32_t pack(int p, int votes) {
  return ((uint32_t)votes << POS_BITS) | (POS_MASK - (uint32_t)p);
}

// first index i in [lo, hi) of the ascending s with s[i] > v (UPPER) or
// s[i] >= v; hi when there is none
template <bool UPPER>
__device__ __forceinline__ int search(const int32_t* s, int lo, int hi,
                                      int32_t v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (UPPER ? s[mid] <= v : s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// co-rank of merged position d: how many of the first d merged keys come
// from a (a first among equal keys)
__device__ __forceinline__ int co_rank(const int32_t* sa, int na,
                                       const int32_t* sb, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[d - mid - 1]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// insert p into the descending top[NC]
template <int NC>
__device__ __forceinline__ void insert(uint32_t (&top)[NC], uint32_t p) {
  if (p <= top[NC - 1]) return;
#pragma unroll
  for (int q = NC - 1; q > 0; --q)
    top[q] = p > top[q - 1] ? top[q - 1] : max(top[q], p);
  top[0] = max(top[0], p);
}

// the vote group's barrier: one warp, or the whole block
template <int NW>
__device__ __forceinline__ void group_sync() {
  if constexpr (NW == 1) __syncwarp(); else __syncthreads();
}

// The vote of one row: sa[0, La) and sb[0, Mb) sorted ascending in shared
// memory (Mb = 0: one list), voted by the NW warps of a group (NW > 1: the
// whole block), t = the thread's index in the group. wl (NW * ncand
// words) and fin (ncand) are the group's lists in shared memory. Writes
// keys[c] and votes[c], c < ncand, when `write`. The lists are free again
// after the next group barrier.
template <int NC, int NW>
__device__ __forceinline__ void vote_rank(const int32_t* sa, int La,
                                          const int32_t* sb, int Mb,
                                          int ncand, int min_votes, int t,
                                          uint32_t* wl, uint32_t* fin,
                                          int32_t* keys, int32_t* votes,
                                          bool write) {
  constexpr int THREADS = NW * 32;
  const int na = search<false>(sa, 0, La, GHOSTM_BIG);
  const int nb = search<false>(sb, 0, Mb, GHOSTM_BIG);
  const int n = na + nb;
  const int per = (n + THREADS - 1) / THREADS;
  const int d0 = min(t * per, n), d1 = min(d0 + per, n);
  int ia = co_rank(sa, na, sb, nb, d0), ib = d0 - ia;
  // the merged key before d0: the larger of the two last ones taken
  int32_t last = INT32_MIN;
  if (ia > 0) last = sa[ia - 1];
  if (ib > 0) last = max(last, sb[ib - 1]);

  const int mv = max(min_votes, 1);
  uint32_t top[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) top[q] = 0;
  int32_t cur = 0;
  int cur_p = 0;
  int cnt = 0;   // length of the open run; 0 while skipping a carried run
  for (int p = d0; p < d1; ++p) {
    int32_t v;
    if (ib >= nb || (ia < na && sa[ia] <= sb[ib])) v = sa[ia++];
    else v = sb[ib++];
    if (p > 0 && v == last) {
      if (cnt) ++cnt;
    } else {
      if (cnt >= mv) insert(top, pack(cur_p, cnt));
      cur = v;
      cur_p = p;
      cnt = 1;
    }
    last = v;
  }
  if (cnt) {
    cnt += search<true>(sa, ia, na, cur) - ia + search<true>(sb, ib, nb, cur)
           - ib;
    if (cnt >= mv) insert(top, pack(cur_p, cnt));
  }

  // each warp's top ncand, by ncand warp maxima over the lanes' heads
  const int lane = t & 31, warp = t >> 5;
  for (int c = 0; c < ncand; ++c) {
    const uint32_t m = __reduce_max_sync(0xffffffffu, top[0]);
    if (m && top[0] == m) {
#pragma unroll
      for (int q = 0; q < NC - 1; ++q) top[q] = top[q + 1];
      top[NC - 1] = 0;
    }
    if (lane == 0) wl[warp * ncand + c] = m;
  }
  group_sync<NW>();
  if (warp == 0) {
    int pos = 0;
    uint32_t head = lane < NW ? wl[lane * ncand] : 0;
    for (int c = 0; c < ncand; ++c) {
      const uint32_t m = __reduce_max_sync(0xffffffffu, head);
      if (m && head == m) {
        ++pos;
        head = pos < ncand ? wl[lane * ncand + pos] : 0;
      }
      if (lane == 0) fin[c] = m;
    }
    __syncwarp();
    // each slot's key: the merged key at its run's start position
    for (int c = lane; c < ncand && write; c += 32) {
      const uint32_t m = fin[c];
      const int nv = (int)(m >> POS_BITS);
      int32_t key = GHOSTM_BIG;
      if (nv) {
        const int p = (int)(POS_MASK - (m & POS_MASK));
        const int ja = co_rank(sa, na, sb, nb, p), jb = p - ja;
        key = jb >= nb || (ja < na && sa[ja] <= sb[jb]) ? sa[ja] : sb[jb];
      }
      keys[c] = key;
      votes[c] = nv;
    }
  }
}

}  // namespace
