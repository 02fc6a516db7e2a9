// Kernel R2: the chained vote of long-read mode. Per row of sorted hit
// keys, the run-length vote, the collinear chain score of each run and
// the top ncand by (votes desc, key asc).
//
// Replaces the XLA chain of ghostm_tpu/kernels/candidates.py:66-90 (a
// segmented Hillis-Steele (max, +) scan inside _per_query), which the
// port ran as plain torch (kernels/sort.py: _chain and vote_top's two
// reductions a pick): about log2(M) steps of full-row temporaries, then
// ncand picks. At the long-read cell's rows that was ~1,000 launches and
// 138.7 device ms a batch on an H100.
//
// Contract (kernels/sort.py::vote_top with chain_gamma > 0, smooth off):
// the input is B1's sorted (Q, M) int32 keys, invalid keys (>= BIG =
// 2^30) at the tail. A run of equal valid keys has votes v = its length;
// a segment is a stretch of one subject row (key / nbins); a run's chain
// score is C = v + max(0, RMex - gamma k), RMex the recurrence RM =
// max(v + gamma k, RM + v) at the previous run of its segment (NEGC =
// -2^30 at a segment's first run). Runs with C >= min_votes rank by (C
// desc, key asc); slots past them are (BIG, 0). The plain version's int32
// arithmetic is kept wherever gamma k + M < 2^31 (candidates.
// vote_and_rank's check): the subtraction at a segment's first run wraps
// where gamma k > 2^30, as the plain one does, and so does the plain
// top-k's pack of votes and position into one int32 (rows of M < 2^15):
// a score past 2^(31 - wbits), wbits = bit length of M, ranks and reads as
// its low 32 - wbits bits sign-extended; one <= 0 is not ranked, and a
// row whose every key is a run of negative score reads that score in slot
// 0 (the plain picks: a picked slot becomes 0, above every negative).
//
// Bound on the H100: device-memory bytes. The row is read once, 8 bytes
// a slot written; the operations are a few tens a key. At the long-read
// cell's rows, (128, 441,856) three times a batch (k = 5, 128 seeds a
// k-mer, 3,452 k-mers a 3,456-residue frame), that is 226 MB a launch,
// 67.5 us at 3.35 TB/s.
//
// Design. A row is cut into stretches of about `part` keys, each ended
// where the subject row changes (the recurrence starts afresh there), so
// the stretches of a row are independent: one 256-thread block a stretch
// (a one-warp 32-ary search for each end), every stretch of every row in
// one grid. A block walks its stretch in tiles of 4,096 keys, 16
// consecutive keys a thread (int4 loads where the row is 16-byte
// aligned). Each position is one element (A, B, F) of the (max, +)
// recurrence: a run start A = gamma k + 1, any other valid key A = NEGC,
// B = 1, so the state at a run's end is RM of that run whatever thread
// holds its keys; F = a new subject row (or position 0) resets it.
//  1. Walk 1: each thread finds its run starts, run ends and resets (bit
//     masks) and composes its 16 elements; a thread whose first key is
//     invalid (the sorted row's tail) only loads its keys.
//  2. A block scan of the threads' compositions (warp shuffles, then the
//     8 warps' totals in shared memory), seeded with the state after the
//     previous tile: the state before each thread's first key.
//  3. Walk 2: each thread steps its keys from that state; at a run start
//     it takes RMex and the clamp term, at a run end it scores the run if
//     it also started in the thread's keys, and keeps its top NC packed
//     words (C << 32 | ~(key ^ 2^31): the max is (votes desc, key asc)).
//  4. A second block scan (the latest run start: position, key, clamp
//     term) gives each thread the run carried into its keys, which the
//     thread holding its end scores.
// The tile's totals seed the next tile's scans. Each warp then merges its
// lanes' lists by ncand warp maxima and warp 0 the 8 warps' lists; the
// block writes its list to scratch, and the row's last block to finish
// (an atomic count a row) merges the row's lists the same way and writes
// the row's (keys, votes). No shared memory but the scans' 8 totals and
// the lists (2.5 KB at NC 32); the (k // nbins) of every key is a
// multiply-high (RowDiv). Not kept: a block a row walking its tiles in
// turn, 128 blocks a launch, took 0.60 ms a launch at the cell's shape on
// an H100; the stretches take 0.28.
#include <climits>

#include "bitonic.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KPT = 16;                  // consecutive keys a thread
constexpr int TILE_KEYS = THREADS * KPT;
constexpr int NEGC = -(1 << 30);         // the recurrence's minus infinity
constexpr int DONE = 3;   // a row's ints in `done`: blocks finished, then
                          // its negative scores' count and order-mapped max
constexpr unsigned FULL = 0xffffffffu;
using u64 = unsigned long long;

// int32 arithmetic that wraps as torch's does
__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// torch's floor division (k // nbins), nbins > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// k // nbins by a multiply: m = ceil(2^(32 + s) / d), s = floor(log2 d),
// exact for 0 <= x < 2^31 (the error m d - 2^(32 + s) < d <= 2^s keeps
// x (m d - 2^(32 + s)) below 2^(32 + s)); a power of two shifts
struct RowDiv {
  int d, s;
  unsigned m;
  __device__ __forceinline__ int row(int x) const {
    if (x < 0) return floor_div(x, d);
    return (int)((m ? __umulhi((unsigned)x, m) : (unsigned)x) >> s);
  }
};
__device__ __forceinline__ RowDiv row_div(int d) {
  const int s = 31 - __clz(d);
  const unsigned m =
      (d & (d - 1))
          ? (unsigned)(((1ull << (32 + s)) + (unsigned)d - 1) / (unsigned)d)
          : 0u;
  return RowDiv{d, s, m};
}

// one step (or a composition of steps) of the recurrence: the state R
// becomes f ? a : max(a, R + b)
struct Fold {
  int a, b, f;
};
__device__ __forceinline__ Fold then(Fold x, Fold y) {   // x, then y
  return Fold{y.f ? y.a : max(y.a, add32(x.a, y.b)),
              y.f ? y.b : add32(x.b, y.b), x.f | y.f};
}
__device__ __forceinline__ int apply(Fold x, int r) {
  return x.f ? x.a : max(x.a, add32(r, x.b));
}
__device__ __forceinline__ Fold shfl_up(Fold v, int o) {
  return Fold{__shfl_up_sync(FULL, v.a, o), __shfl_up_sync(FULL, v.b, o),
              __shfl_up_sync(FULL, v.f, o)};
}

// the latest run start: its position, key and clamp term
struct Run {
  int has, p, k, c;
};
__device__ __forceinline__ Run then(Run x, Run y) { return y.has ? y : x; }
__device__ __forceinline__ Run shfl_up(Run v, int o) {
  return Run{__shfl_up_sync(FULL, v.has, o), __shfl_up_sync(FULL, v.p, o),
             __shfl_up_sync(FULL, v.k, o), __shfl_up_sync(FULL, v.c, o)};
}

// Block-wide exclusive scan of v under then(), seeded with `seed`: the
// composition of seed and every earlier thread's v. `total` gets the
// composition of seed and all of the block's. One block barrier; wsum
// (WARPS words) is free again after the caller's next barrier.
template <class T>
__device__ __forceinline__ T block_scan(T v, T seed, T ident, T* wsum,
                                        T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(inc, o);
    if (lane >= o) inc = then(y, inc);
  }
  T ex = shfl_up(inc, 1);
  if (lane == 0) ex = ident;
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  T acc = seed, mine = seed;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) mine = acc;
    acc = then(acc, wsum[w]);
  }
  total = acc;
  return then(mine, ex);
}

__device__ __forceinline__ u64 pack(int votes, int key) {
  return ((u64)(uint32_t)votes << 32) |
         (uint32_t)~((uint32_t)key ^ 0x80000000u);
}
__device__ __forceinline__ int unpack_key(u64 m) {
  return (int)(~(uint32_t)m ^ 0x80000000u);
}

// insert p into the descending top[NC]
template <int NC>
__device__ __forceinline__ void insert(u64 (&top)[NC], u64 p) {
  if (p <= top[NC - 1]) return;
#pragma unroll
  for (int q = NC - 1; q > 0; --q)
    top[q] = p > top[q - 1] ? top[q - 1] : max(top[q], p);
  top[0] = max(top[0], p);
}

// a run of chain score c: ranked where it passes min_votes, as the plain
// top-k's int32 pack reads it (the header); negative readings counted
template <int NC>
__device__ __forceinline__ void score(u64 (&top)[NC], int c, int key, int mv,
                                      int wbits, int& nneg, int& wneg) {
  if (c < mv) return;
  const int w = (int)((unsigned)c << wbits) >> wbits;
  if (w > 0) {
    insert(top, pack(w, key));
  } else if (w < 0) {
    ++nneg;
    wneg = max(wneg, w);
  }
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the block's vote lists merged into fin[0, ncand): ncand warp maxima over
// each warp's lanes, then over the warps' lists; ends on a block barrier
template <int NC>
__device__ __forceinline__ void block_top(u64 (&top)[NC], int ncand, u64* wl,
                                          u64* fin) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < ncand; ++c) {
    const u64 m = warp_max(top[0]);
    if (m && top[0] == m) {
#pragma unroll
      for (int q = 0; q < NC - 1; ++q) top[q] = top[q + 1];
      top[NC - 1] = 0;
    }
    if (lane == 0) wl[warp * NC + c] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int pos = 0;
    u64 head = lane < WARPS ? wl[lane * NC] : 0;
    for (int c = 0; c < ncand; ++c) {
      const u64 m = warp_max(head);
      if (m && head == m) {
        ++pos;
        head = pos < ncand ? wl[lane * NC + pos] : 0;
      }
      if (lane == 0) fin[c] = m;
    }
  }
  __syncthreads();
}

// Where a block may start a stretch of the sorted row k[0, M) that owes
// nothing to the keys before it: the first i >= s at which the subject
// row changes (the chain starts afresh there), or s itself inside the
// invalid tail (nothing there is scored). Searched by one warp, 32 probes
// a step; every lane returns it.
__device__ int boundary(const int32_t* k, int s, int M, RowDiv dv) {
  if (s <= 0) return 0;
  if (s >= M) return M;
  const int p = __ldg(k + s - 1);
  if (p >= GHOSTM_BIG) return s;
  const long long T = min((long long)GHOSTM_BIG,
                          ((long long)dv.row(p) + 1) * dv.d);
  const int lane = threadIdx.x & 31;
  int lo = s, hi = M;   // the first index of [lo, hi) whose key is >= T
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = min(lo + (lane + 1) * step, hi) - 1;
    const unsigned b = __ballot_sync(FULL, __ldg(k + idx) >= T);
    if (!b) return hi;
    const int L = __ffs(b) - 1;
    hi = min(lo + (L + 1) * step, hi);
    lo += L * step;
  }
  const int idx = lo + lane;
  const unsigned b = __ballot_sync(FULL, idx < hi && __ldg(k + idx) >= T);
  return b ? lo + __ffs(b) - 1 : hi;
}

template <int NC>
__global__ void __launch_bounds__(THREADS, NC <= 8 ? 4 : 1)
    chain_vote_kernel(const int32_t* __restrict__ keys_in, int M, int nbins,
                      int gamma, int ncand, int min_votes, int vec, int part,
                      int parts, u64* __restrict__ lists,
                      int* __restrict__ done, int32_t* __restrict__ keys_out,
                      int32_t* __restrict__ votes_out) {
  __shared__ Fold fsum[WARPS];
  __shared__ Run rsum[WARPS];
  __shared__ u64 wl[WARPS * NC];
  __shared__ u64 fin[NC];
  __shared__ int span[2];
  __shared__ int neg[2];    // the row's negative readings: count, max
  __shared__ int merges;
  const int t = threadIdx.x, warp = t >> 5;
  const size_t r = blockIdx.x / parts;
  const int b = blockIdx.x % parts;
  const int32_t* k = keys_in + r * (size_t)M;
  const int mv = max(min_votes, 1);
  const int bits = 32 - __clz(max(M, 1));
  const int wbits = 2 * bits <= 31 ? bits : 0;   // the plain top-k's pack
  const RowDiv dv = row_div(nbins);
  const Fold fid{NEGC, 0, 0};
  const Run rid{0, 0, 0, 0};

  // the block's stretch [start, end): its part of the row, both ends
  // moved on to the next boundary
  if (warp < 2) {
    const int s = boundary(
        k, (int)min((long long)M, (long long)(b + warp) * part), M, dv);
    if ((t & 31) == 0) span[warp] = s;
  }
  if (t == 0) {
    neg[0] = 0;
    neg[1] = INT_MIN;
  }
  __syncthreads();
  const int start = span[0], end = span[1];

  u64 top[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) top[q] = 0;
  int nneg = 0, wneg = INT_MIN;
  Fold fcarry = fid;      // the state after the previous tile
  Run rcarry = rid;       // the latest run start before this tile

  for (int base = start & ~(KPT - 1); base < end; base += TILE_KEYS) {
    const int i0 = base + t * KPT;
    int x[KPT];
    if (vec && i0 + KPT <= M) {
#pragma unroll
      for (int j = 0; j < KPT / 4; ++j) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(k + i0) + j);
        x[4 * j] = w.x;
        x[4 * j + 1] = w.y;
        x[4 * j + 2] = w.z;
        x[4 * j + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < KPT; ++e)
        x[e] = i0 + e < M ? __ldg(k + i0 + e) : GHOSTM_BIG;
    }
    const int before = i0 > 0 && i0 <= M ? __ldg(k + i0 - 1) : 0;
    const int after = i0 + KPT < M ? __ldg(k + i0 + KPT) : 0;

    // walk 1: masks of the thread's keys in the stretch and their
    // composition. Keys past the valid prefix (sorted rows: all of a
    // thread's keys once its first is invalid) score nothing: such a
    // thread only loads them.
    unsigned runs = 0, ends = 0, resets = 0, valids = 0;
    Fold agg = fid;
    const bool live = x[0] < GHOSTM_BIG && i0 < end && i0 + KPT > start;
    int prev = before, prow = dv.row(before);
#pragma unroll
    for (int e = 0; e < KPT && live; ++e) {
      const int i = i0 + e, row = dv.row(x[e]);
      if (i >= start && i < end) {
        const bool valid = x[e] < GHOSTM_BIG;
        const bool reset = i == 0 || row != prow;
        const bool first = valid && (i == 0 || x[e] != prev);
        const int nx = e + 1 < KPT ? x[e + 1] : after;
        const bool last = valid && (i + 1 == M || nx != x[e]);
        runs |= (unsigned)first << e;
        ends |= (unsigned)last << e;
        resets |= (unsigned)reset << e;
        valids |= (unsigned)valid << e;
        agg = then(agg, Fold{first ? add32(mul32(gamma, x[e]), 1) : NEGC,
                             valid ? 1 : 0, reset ? 1 : 0});
      }
      prev = x[e];
      prow = row;
    }

    Fold ftot;
    const Fold fin_state = block_scan(agg, fcarry, fid, fsum, ftot);

    // walk 2: RMex and the clamp term at each run start; score the runs
    // that start and end in the thread's keys
    int R = fin_state.a;
    Run latest = rid;
#pragma unroll
    for (int e = 0; e < KPT && live; ++e) {
      const int i = i0 + e;
      if (i >= start && i < end) {
        const bool first = runs >> e & 1, reset = resets >> e & 1;
        const int gk = mul32(gamma, x[e]);
        if (first) {
          const int rmex = reset ? NEGC : R;
          latest = Run{1, i, x[e], max(0, sub32(rmex, gk))};
        }
        R = apply(Fold{first ? add32(gk, 1) : NEGC, (int)(valids >> e & 1),
                       (int)reset}, R);
        if ((ends >> e & 1) && latest.has) {
          score(top, add32(i - latest.p + 1, latest.c), latest.k, mv, wbits,
                nneg, wneg);
        }
      }
    }

    Run rtot;
    const Run rin = block_scan(latest, rcarry, rid, rsum, rtot);
    // the run carried into the thread's keys ends at its first run end
    const int e0 = max(start - i0, 0);
    if (e0 < KPT && (valids >> e0 & 1) && !(runs >> e0 & 1) && ends) {
      const int i = i0 + __ffs(ends) - 1;
      score(top, add32(i - rin.p + 1, rin.c), rin.k, mv, wbits, nneg, wneg);
    }
    fcarry = ftot;
    rcarry = rtot;
  }

  if (nneg) {
    atomicAdd(&neg[0], nneg);
    atomicMax(&neg[1], wneg);
  }
  block_top<NC>(top, ncand, wl, fin);
  if (parts > 1) {
    // the row's last block to finish merges every block's list
    u64* row_lists = lists + r * (size_t)parts * ncand;
    int* row_done = done + r * DONE;
    if (t < ncand) {
      row_lists[(size_t)b * ncand + t] = fin[t];
      __threadfence();
    }
    __syncthreads();
    if (t == 0) {
      if (neg[0]) {
        atomicAdd(row_done + 1, neg[0]);
        atomicMax(reinterpret_cast<unsigned*>(row_done + 2),
                  (unsigned)neg[1] ^ 0x80000000u);
        __threadfence();
      }
      merges = atomicAdd(row_done, 1) == parts - 1;
    }
    __syncthreads();
    if (!merges) return;
    __threadfence();
    if (t == 0) {
      neg[0] = __ldcg(row_done + 1);
      neg[1] = (int)((unsigned)__ldcg(row_done + 2) ^ 0x80000000u);
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) top[q] = 0;
    for (int j = t; j < parts * ncand; j += THREADS)
      insert(top, __ldcg(row_lists + j));
    block_top<NC>(top, ncand, wl, fin);
  }
  if (t < ncand) {
    keys_out[r * ncand + t] = fin[t] ? unpack_key(fin[t]) : GHOSTM_BIG;
    votes_out[r * ncand + t] =
        t == 0 && neg[0] && neg[0] == M ? neg[1] : (int)(fin[t] >> 32);
  }
}

template <int NC>
int launch(const int32_t* k, int Q, int M, int nbins, int gamma, int ncand,
           int min_votes, int vec, int part, u64* lists, int* done,
           int32_t* keys, int32_t* votes, cudaStream_t stream) {
  const int parts = M > part ? (M + part - 1) / part : 1;
  chain_vote_kernel<NC><<<(unsigned)((long long)Q * parts), THREADS, 0,
                          stream>>>(k, M, nbins, gamma, ncand, min_votes, vec,
                                    part, parts, lists, done, keys, votes);
  return (int)cudaGetLastError();
}

}  // namespace

// k (Q, M): rows sorted ascending, contiguous; keys, votes (Q, ncand);
// 1 <= ncand <= 32, nbins >= 1, gamma >= 1. vec: the rows are 16-byte
// aligned (M % 4 == 0 and k aligned). A block takes `part` keys of a row
// (part % 16 == 0), parts = ceil(M / part) a row; lists (Q, parts, ncand)
// 64-bit words of scratch and done (Q, 3) zeroed ints, read where
// parts > 1.
extern "C" int ghostm_chain_vote_rows(const int32_t* k, int Q, int M,
                                      int nbins, int gamma, int ncand,
                                      int min_votes, int vec, int part,
                                      unsigned long long* lists, int* done,
                                      int32_t* keys, int32_t* votes,
                                      cudaStream_t stream) {
  if (nbins < 1 || gamma < 1 || ncand < 1 || part < KPT || part % KPT)
    return (int)cudaErrorInvalidValue;
  if (ncand <= 8)
    return launch<8>(k, Q, M, nbins, gamma, ncand, min_votes, vec, part,
                     lists, done, keys, votes, stream);
  if (ncand <= 32)
    return launch<32>(k, Q, M, nbins, gamma, ncand, min_votes, vec, part,
                      lists, done, keys, votes, stream);
  return (int)cudaErrorInvalidValue;
}
