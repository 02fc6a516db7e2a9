// Kernel B2, merge entry: per row, the union of two sorted key rows, the
// run-length vote over it and the top ncand by (votes desc, key asc).
//
// Replaces ghostm_tpu/kernels/sort.py::_sort_vote_kernel, entry
// merge_vote_rank_rows: the end of the propose phase's split sort, on
// a (6144, 4096) + b (6144, 512) with 100 bp reads and (2944, 8192) +
// (2944, 2560) with 250 bp reads. Keys >= BIG = 2^30 are invalid and sort
// to each row's tail; the outputs are (Q, ncand) keys and votes, key BIG
// where votes == 0. The monolithic entry stays in sort_vote.cu.
//
// Bound on the H100: device-memory bytes (each key row read once, 64 bytes
// of output a row). The previous design laid the row out as
// [a | PAD | flip(b)] (8192 keys, 3584 of them PAD), ran a 13-pass bitonic
// merge with a block barrier each, one binary search per run start, and
// 8 block-wide max rounds with two barriers each; with 1024-thread blocks
// of 32 KB only 2 blocks fit an SM.
//
// Design (merge path; no sorting network: two sorted lists need a merge,
// which touches each key once):
//  * The block (256 threads) copies a and b into shared memory with 16-byte
//    loads and finds each row's valid prefix (the first key >= BIG) by one
//    binary search each. Only the n = na + nb valid keys are merged; the
//    invalid tail never votes.
//  * Thread t takes merged positions [t c, (t + 1) c), c = ceil(n / 256),
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
//    (one redux.sync each); after one barrier warp 0 merges the 8 warps'
//    lists the same way, and each output slot finds its key at merged
//    position p by one more co-rank search. Two barriers in all.
// Shared memory: the two rows, (La + Mb) * 4 bytes (18 KB at 4096 + 512;
// 43 KB at 8192 + 2560), and 4.5 KB of lists.
#include "bitonic.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src,
                                         int n, bool vec) {
  if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += THREADS * 4)
      *reinterpret_cast<int4*>(dst + i) =
          *reinterpret_cast<const int4*>(src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
    merge_vote_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b, int La, int Mb,
                      int ncand, int min_votes, int vec,
                      int32_t* __restrict__ keys,
                      int32_t* __restrict__ votes) {
  extern __shared__ int32_t s[];   // [a row | b row]
  __shared__ uint32_t wl[WARPS * MAX_NCAND];   // each warp's top ncand
  __shared__ uint32_t fin[MAX_NCAND];
  int32_t* sa = s;
  int32_t* sb = s + La;
  const size_t r = blockIdx.x;
  copy_row(sa, a + r * La, La, vec & 1);
  copy_row(sb, b + r * Mb, Mb, vec & 2);
  __syncthreads();

  const int na = search<false>(sa, 0, La, GHOSTM_BIG);
  const int nb = search<false>(sb, 0, Mb, GHOSTM_BIG);
  const int n = na + nb;
  const int per = (n + THREADS - 1) / THREADS;
  const int d0 = min((int)threadIdx.x * per, n), d1 = min(d0 + per, n);
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < ncand; ++c) {
    const uint32_t m = __reduce_max_sync(0xffffffffu, top[0]);
    if (m && top[0] == m) {
#pragma unroll
      for (int q = 0; q < NC - 1; ++q) top[q] = top[q + 1];
      top[NC - 1] = 0;
    }
    if (lane == 0) wl[warp * ncand + c] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int pos = 0;
    uint32_t head = lane < WARPS ? wl[lane * ncand] : 0;
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
    for (int c = lane; c < ncand; c += 32) {
      const uint32_t m = fin[c];
      const int nv = (int)(m >> POS_BITS);
      int32_t key = GHOSTM_BIG;
      if (nv) {
        const int p = (int)(POS_MASK - (m & POS_MASK));
        const int ja = co_rank(sa, na, sb, nb, p), jb = p - ja;
        key = jb >= nb || (ja < na && sa[ja] <= sb[jb]) ? sa[ja] : sb[jb];
      }
      keys[r * ncand + c] = key;
      votes[r * ncand + c] = nv;
    }
  }
}

template <int NC>
int launch(const int32_t* a, const int32_t* b, int Q, int La, int Mb,
           int ncand, int min_votes, int vec, int32_t* keys, int32_t* votes,
           cudaStream_t stream) {
  const int shm = (La + Mb) * (int)sizeof(int32_t);
  if (!row_smem_ok(merge_vote_kernel<NC>, shm))
    return (int)cudaErrorInvalidValue;
  merge_vote_kernel<NC><<<Q, THREADS, shm, stream>>>(
      a, b, La, Mb, ncand, min_votes, vec, keys, votes);
  return (int)cudaGetLastError();
}

}  // namespace

// a (Q, La), b (Q, Mb): rows sorted ascending, contiguous; keys, votes
// (Q, ncand); 1 <= ncand <= 128; La + Mb <= 16384. vec: bit 0 when a's rows are 16-byte
// aligned (La % 4 == 0 and a aligned), bit 1 likewise for b.
extern "C" int ghostm_merge_vote_rows(const int32_t* a, const int32_t* b,
                                      int Q, int La, int Mb, int ncand,
                                      int min_votes, int vec, int32_t* keys,
                                      int32_t* votes, cudaStream_t stream) {
  if (La + Mb > (1 << POS_BITS)) return (int)cudaErrorInvalidValue;
  if (ncand <= 8)
    return launch<8>(a, b, Q, La, Mb, ncand, min_votes, vec, keys, votes,
                     stream);
  if (ncand <= 32)
    return launch<32>(a, b, Q, La, Mb, ncand, min_votes, vec, keys, votes,
                      stream);
  if (ncand <= 128)
    return launch<128>(a, b, Q, La, Mb, ncand, min_votes, vec, keys, votes,
                       stream);
  return (int)cudaErrorInvalidValue;
}
