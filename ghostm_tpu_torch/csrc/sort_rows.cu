// Kernel B1: ascending sort of each row of a (Q, M) int32 array.
//
// Replaces ghostm_tpu/kernels/sort.py::_sort_kernel (entry sort_rows), the
// Pallas bitonic row sort that the propose phase's split sort runs on both
// halves of every key row ((6144, 4096) and (6144, 512) with 100 bp reads,
// (2944, 8192) and (2944, 2560) with 250 bp reads; presorted runs of 128).
//
// Bound on the H100: device-memory bytes. Each row is read once and written
// once (8 bytes per key); everything between stays on chip. The previous
// design ran every compare-exchange of the bitonic network as a
// shared-memory pass with a block barrier (50 passes over a 4096-key row,
// half of them 2-way bank-conflicted), so shared-memory traffic and
// barriers, not device memory, set its time.
//
// Design: a bitonic network held in registers. A row of L = 2^LOGL keys is
// spread over L / 32 threads, 32 keys each; blocks hold 128 threads (several
// rows when L < 4096). L is a template parameter (one instance per power of
// two from 128 to 16384), so every stride, layout and loop is a
// compile-time constant and the network unrolls.
//  * Layouts. In layout LO a thread's 32 registers hold the keys whose
//    index bits LO .. LO+4 are the register number; its other index bits
//    come from the thread number. A compare-exchange at stride 2^j with
//    LO <= j < LO + 5 is two register instructions (min, max): no memory,
//    no barrier. Each run of strides is served by one layout: strides
//    below 32 by LO = 0, larger ones by LO >= 5 chosen to cover as many of
//    the stage's next strides as it can. Changing layout is one trip
//    through shared memory (write, barrier, read): 1-3 per stage instead
//    of one pass per stride (a 4096-key row with runs of 128: 11 trips
//    instead of 50 passes). The first stage reads the loaded row straight
//    into the layout of its largest stride.
//  * No bank conflicts. Rows of up to 8192 keys get one padding word per
//    32 keys, so a register's word is its thread's base word plus a
//    constant (an immediate offset: no address arithmetic, few
//    registers); the 16,384-key row, which padding would push past 64 KB,
//    XORs bits 0..4 of the index by bits 5..9, 10..14 and 15..19. In
//    every layout used here the 32 lanes of a warp fall in 32 different
//    banks either way.
//  * No direction logic: before stage k the keys of each 2^k block whose
//    index has bit k set are complemented (~x reverses int32 order), so
//    every compare-exchange puts the minimum at the lower index; the
//    complement is undone at the next stage's start (one XOR per key and
//    stage) and is zero after the last stage.
//  * The presorted-run skip: starting at stage `first` needs each aligned
//    2^(first-1) block sorted ascending at even and descending at odd block
//    index (the JAX package's contract); first = 1 sorts arbitrary rows.
//  * Rows are read and written with 16-byte accesses when M % 4 == 0 and
//    the tensors are 16-byte aligned, else with a scalar edge; keys past M
//    are PAD (sorts after every key) and are never written back.
// Shared memory: the block's rows and their padding (33 KB at L = 8192; the
// unpadded 64 KB at L = 16384 is above the 48 KB default, so the launch
// opts in). The network, its layouts and the row load live in bitonic.cuh,
// which sort_vote.cu's monolithic entry of kernel B2 shares.
//
// Rows longer than one block holds (M > 16384: the chained long-read rows,
// (768, 27600) at 5 kbp and (384, 55248) at 10 kbp with 16-wide seed
// tables, (128, 441856) with 128-wide ones at 3,456-residue frames; the TPU
// kernel sorts them in one block of 96 MB of VMEM) take two trips through
// device memory, launched by the wrapper:
//  * ghostm_sort_tiles: one block a tile of T = 16384 keys of a row, sorted
//    by the L = 16384 network above (the same functions; T is a multiple of
//    2 x run, so a tile keeps the presorted-run skip). Only a row's last
//    tile is short; it is padded with PAD in shared memory, so device
//    memory moves M keys a row, not the next power of two. It also writes
//    every T / NSR-th key of its sorted tile (NSR = KWAY_SAMPLES = 256
//    samples a tile, 1/64 of the keys) for the k-way merge.
//  * ghostm_merge_kway: one k-way merge of all K sorted runs of each row
//    (2 <= K <= KMAX = KWAY_MAX = 32), two kernels in one launch:
//     - kway_split_kernel, a block a row: the row's samples in shared
//       memory merged by a merge-path tree (stable: equal keys in run
//       order), so its g-th, 2g-th, ... sample is a splitter p_b. The rows'
//       keys are ordered by (key, run, position): the cut of run t at p_b
//       (its keys before p_b) is p_b's own position in p_b's run; in a
//       lower run the keys <= p_b's key, in a higher one the keys < it. The
//       samples put that count inside one sample interval of the run (S =
//       width / NSR keys), which one thread scans (16-byte loads where vec
//       holds). Keys equal to a splitter so go to the buckets in run
//       order; the sort moves keys only, so equal keys are
//       interchangeable and no index breaks the ties.
//     - kway_merge_kernel, a block a bucket b (the keys from p_b up to
//       p_(b+1)): the K slices between the bucket's cuts staged in shared
//       memory, merged there by a merge-path tree of ceil(log2 K) levels
//       (each thread merges its share of every level from its co-rank),
//       and stored from row position sum_t cut_t(p_b). A bucket holds g
//       samples' keys on average (g S = 7168) and at most (g + K) S - K,
//       which sizes its shared memory (71 KB at K = 27: three blocks an
//       SM, ~29 keys a thread a level).
//    Bound: bytes, 8 a key: the runs read once and the row written once;
//    at K = 27 the samples add 1.5% and the split's interval scans 11.5%.
//  * ghostm_merge_pass (rows of more than KMAX tiles, first): merges each
//    pair of sorted runs of `width` keys (the last run of a row may be
//    short or have no partner) until KMAX runs remain, then the k-way
//    merge takes runs of that width while its bucket fits in shared memory
//    (rows of up to 336 tiles; longer rows merge pairwise to the end: the
//    wrapper's plan, sort.long_plan). A block owns SPAN output keys; two
//    threads find where the span starts and ends in both runs by a co-rank
//    (merge-path) search in device memory (vote.cuh's co_rank, the search
//    B2's merge entry runs in shared memory), the block stages both ranges
//    in shared memory, each thread merges SPAN / MT keys from its own
//    co-rank, and the span leaves with coalesced 16-byte stores. Bound:
//    bytes, 8 a key a pass.
#include "vote.cuh"

namespace {

template <int LOGL>
__global__ void __launch_bounds__(Shape<LOGL>::NT)
    sort_rows_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                     int Q, int M, int first, int vec) {
  using S = Shape<LOGL>;
  using W = Words<LOGL>;
  constexpr int L = S::L;
  extern __shared__ int32_t s[];
  const int r = threadIdx.x / S::TR, t = threadIdx.x % S::TR;
  const size_t row0 = (size_t)blockIdx.x * S::ROWS;
  load_rows<LOGL>(x, s, Q, M, row0, vec);
  __syncthreads();
  sort_rows_smem<LOGL>(s, r, t, first);
  if (vec) {
    for (int a = threadIdx.x * 4; a < S::ROWS * L; a += S::NT * 4) {
      const size_t row = row0 + (a >> LOGL);
      const int c = a & (L - 1);
      if (row < (size_t)Q && c < M)
        *reinterpret_cast<int4*>(out + row * M + c) =
            make_int4(s[W::of(a)], s[W::of(a + 1)], s[W::of(a + 2)],
                      s[W::of(a + 3)]);
    }
  } else {
    for (int a = threadIdx.x; a < S::ROWS * L; a += S::NT) {
      const size_t row = row0 + (a >> LOGL);
      const int c = a & (L - 1);
      if (row < (size_t)Q && c < M) out[row * M + c] = s[W::of(a)];
    }
  }
}

template <int LOGL>
int launch(const int32_t* x, int32_t* out, int Q, int M, int first, int vec,
           cudaStream_t stream) {
  using S = Shape<LOGL>;
  const int shm = S::WORDS * (int)sizeof(int32_t);
  if (!row_smem_ok(sort_rows_kernel<LOGL>, shm))
    return (int)cudaErrorInvalidValue;
  const int grid = (Q + S::ROWS - 1) / S::ROWS;
  sort_rows_kernel<LOGL><<<grid, S::NT, shm, stream>>>(x, out, Q, M, first,
                                                       vec);
  return (int)cudaGetLastError();
}

constexpr int TILE_LOG = 14;
constexpr int TILE = 1 << TILE_LOG;
// the k-way merge's geometry, which its wrapper plans with, is defined
// once in kernels/_build.py (DEFINES) and comes in as -D flags
#if !defined(KWAY_MAX) || !defined(KWAY_SAMPLES) || !defined(KWAY_SMEM)
#error "sort_rows.cu is built by kernels/_build.py (-DKWAY_MAX ...)"
#endif
constexpr int NSR = KWAY_SAMPLES;   // the k-way merge's samples of a run
static_assert(TILE % (4 * NSR) == 0, "a tile's samples: 16-byte steps");

__global__ void __launch_bounds__(Shape<TILE_LOG>::NT)
    sort_tiles_kernel(const int32_t* __restrict__ x,
                      int32_t* __restrict__ out, int M, int tiles, int first,
                      int vec, int32_t* __restrict__ smp) {
  using S = Shape<TILE_LOG>;   // one row a block: 512 threads
  using W = Words<TILE_LOG>;
  extern __shared__ int32_t s[];
  const int r = threadIdx.x / S::TR, t = threadIdx.x % S::TR;
  const int tile = blockIdx.x % tiles;
  const size_t base = (size_t)(blockIdx.x / tiles) * M + (size_t)tile * TILE;
  const int n = min(TILE, M - tile * TILE);
  load_rows<TILE_LOG>(x + base, s, 1, n, 0, vec);
  __syncthreads();
  sort_rows_smem<TILE_LOG>(s, r, t, first);
  int32_t* o = out + base;
  if (vec) {
    for (int a = threadIdx.x * 4; a < n; a += S::NT * 4)
      *reinterpret_cast<int4*>(o + a) =
          make_int4(s[W::of(a)], s[W::of(a + 1)], s[W::of(a + 2)],
                    s[W::of(a + 3)]);
  } else {
    for (int a = threadIdx.x; a < n; a += S::NT) o[a] = s[W::of(a)];
  }
  if (smp) {   // every TILE / NSR-th key: the tile's samples
    constexpr int KS = TILE / NSR;
    for (int j = threadIdx.x; j * KS < n; j += S::NT)
      smp[(size_t)blockIdx.x * NSR + j] = s[W::of(j * KS)];
  }
}

constexpr int SPAN = 4096;   // output keys a merge block
constexpr int MT = 256;      // threads a merge block: 16 keys each

__global__ void __launch_bounds__(MT)
    merge_pass_kernel(const int32_t* __restrict__ in,
                      int32_t* __restrict__ out, int M, int width, int spans,
                      int vec) {
  __shared__ int32_t stage[SPAN];   // the span's a range, then its b range
  __shared__ __align__(16) int32_t merged[SPAN];
  __shared__ int cut[2];
  const size_t row = blockIdx.x / spans;
  const int d0 = (blockIdx.x % spans) * SPAN;   // span start in the row
  const int p0 = d0 / (2 * width) * (2 * width);   // its pair of runs
  const int na = min(width, M - p0);
  const int nb = max(0, min(width, M - p0 - width));
  const int32_t* a = in + row * M + p0;
  const int32_t* b = a + na;
  const int lo = d0 - p0, hi = min(lo + SPAN, na + nb);
  if (threadIdx.x < 2)
    cut[threadIdx.x] = co_rank(a, na, b, nb, threadIdx.x ? hi : lo);
  __syncthreads();
  const int i0 = cut[0], i1 = cut[1];
  const int j0 = lo - i0, j1 = hi - i1;
  const int sa = i1 - i0, n = hi - lo;
  for (int i = threadIdx.x; i < n; i += MT)
    stage[i] = i < sa ? a[i0 + i] : b[j0 + i - sa];
  __syncthreads();
  const int32_t* ga = stage;
  const int32_t* gb = stage + sa;
  const int sb = j1 - j0;
  const int d = threadIdx.x * (SPAN / MT);
  if (d < n) {
    int ia = co_rank(ga, sa, gb, sb, d), ib = d - ia;
    const int e = min(d + SPAN / MT, n);
    for (int p = d; p < e; ++p)
      merged[p] = ib >= sb || (ia < sa && ga[ia] <= gb[ib]) ? ga[ia++]
                                                            : gb[ib++];
  }
  __syncthreads();
  int32_t* o = out + row * M + d0;
  if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += MT * 4)
      *reinterpret_cast<int4*>(o + i) =
          *reinterpret_cast<const int4*>(merged + i);
  } else {
    for (int i = threadIdx.x; i < n; i += MT) o[i] = merged[i];
  }
}

constexpr int KMAX = KWAY_MAX;   // runs of a k-way merge
constexpr int ST = 1024;    // threads of a split block
constexpr int KT = 256;     // threads of a merge block

// lists t = 0 .. K-1 of a buffer hold keys [off[t], off[t + 1]); the last
// list t with off[t] <= d, for d < off[K]
__device__ __forceinline__ int list_at(const int* off, int K, int d) {
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= d) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// a thread's share of a level: odd, so that threads d / vt apart write
// 32 different banks
__device__ __forceinline__ int share(int n, int nt) {
  return ((n + nt - 1) / nt) | 1;
}

// Outputs [d, e) of one level of a merge-path tree from x into y: at span
// s the lists are groups of s of the K input lists, merged pairwise (the
// lower group first on equal keys, so the tree is stable). x holds one
// readable word past its keys: an exhausted list's head is read, never
// used.
__device__ void merge_level(const int32_t* __restrict__ x,
                            int32_t* __restrict__ y, const int* off, int K,
                            int s, int d, int e) {
  while (d < e) {
    const int p = list_at(off, K, d) / (2 * s) * (2 * s);
    const int a = off[p], m = off[min(p + s, K)], f = off[min(p + 2 * s, K)];
    const int stop = min(e, f);
    // co-rank: keys of [a, m) among the first d - a of the pair
    int lo = max(a, d - f + m), hi = min(d, m);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (x[mid] <= x[m + d - mid - 1]) lo = mid + 1; else hi = mid;
    }
    int ia = lo, ib = m + d - lo;   // heads, as word indices
    int va = x[ia], vb = x[ib];
    for (; d < stop; ++d) {
      const bool ta = ib >= f || (ia < m && va <= vb);
      y[d] = ta ? va : vb;
      ia += ta;
      ib += !ta;
      const int v = x[ta ? ia : ib];
      va = ta ? v : va;
      vb = ta ? vb : v;
    }
  }
}

// keys of sorted list [a, f) of a buffer below v (upper: <= v)
__device__ __forceinline__ int rank_in(const int32_t* x, int a, int f,
                                       int32_t v, bool upper) {
  int lo = a, hi = f;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t k = x[mid];
    if (k < v || (upper && k == v)) lo = mid + 1; else hi = mid;
  }
  return lo - a;
}

// keys at positions [lo, hi) of a sorted run below v (upper: <= v); vec:
// the run and its length are 16-byte multiples
__device__ int count_below(const int32_t* __restrict__ r, int lo, int hi,
                           int32_t v, bool upper, int vec) {
  int c = 0;
  if (vec) {
#pragma unroll 4
    for (int p = lo & ~3; p < hi; p += 4) {
      const int4 q = *reinterpret_cast<const int4*>(r + p);
      const int32_t k[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        c += p + i >= lo && p + i < hi && (k[i] < v || (upper && k[i] == v));
    }
  } else {
    for (int p = lo; p < hi; ++p) c += r[p] < v || (upper && r[p] == v);
  }
  return c;
}

// One block a row: cuts[row][b][t], the first key of bucket b in run t, for
// b = 0 .. nb (bucket nb: the run's end). Sample (t, j) of the row is
// smp[row * s_row + t * s_run + j * s_j].
__global__ void __launch_bounds__(ST)
    kway_split_kernel(const int32_t* __restrict__ in,
                      const int32_t* __restrict__ smp, long long s_row,
                      int s_run, int s_j, int32_t* __restrict__ cuts, int M,
                      int width, int K, int g, int nb, int vec) {
  extern __shared__ int32_t sm[];
  __shared__ int off[KMAX + 1];
  const int S = width / NSR;
  const int ns = (K - 1) * NSR + (M - (K - 1) * width + S - 1) / S;
  const size_t row = blockIdx.x;
  for (int t = threadIdx.x; t <= K; t += ST) off[t] = t < K ? t * NSR : ns;
  int32_t* A = sm;   // the samples, kept for the splitters' ranks
  int32_t* B = A + ns + 1;
  int32_t* C = B + ns + 1;
  const int32_t* sr = smp + row * s_row;
  for (int i = threadIdx.x; i < ns; i += ST) {
    const int t = i / NSR;
    A[i] = sr[(size_t)t * s_run + (size_t)(i - t * NSR) * s_j];
  }
  __syncthreads();
  const int vt = share(ns, ST);
  const int d = min(ns, (int)threadIdx.x * vt), e = min(ns, d + vt);
  const int32_t* m = A;
  for (int s = 1; s < K; s *= 2) {
    int32_t* y = m == B ? C : B;
    merge_level(m, y, off, K, s, d, e);
    __syncthreads();
    m = y;
  }
  // a warp a splitter, a lane a run
  const int lane = threadIdx.x & 31;
  const int32_t* run = in + row * M + (size_t)min(lane, K - 1) * width;
  const int n = lane < K ? min(width, M - lane * width) : 0;
  for (int b = threadIdx.x >> 5; b <= nb; b += ST / 32) {
    int c = b == nb ? n : 0;
    if (b > 0 && b < nb) {
      const int D = b * g;             // the splitter's rank among samples
      const int32_t x = m[D];
      int lt = 0, le = 0;
      if (lane < K) {
        lt = rank_in(A, off[lane], off[lane + 1], x, false);
        le = rank_in(A, off[lane], off[lane + 1], x, true);
      }
      const int eq = le - lt;
      int cum = eq, slt = lt;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(~0u, cum, o);
        if (lane >= o) cum += v;
      }
      cum -= eq;                       // equal samples in lower runs
      for (int o = 16; o; o >>= 1) slt += __shfl_xor_sync(~0u, slt, o);
      const int r = D - slt;           // equal samples before the splitter
      const int u = __ffs(__ballot_sync(~0u, eq > 0 && cum <= r &&
                                                 r < cum + eq)) - 1;
      // samples of this run before the splitter
      const int sig = lane < u ? le : lane > u ? lt : lt + r - cum;
      if (lane == u) {
        c = sig * S;
      } else if (lane < K && sig > 0) {
        const int lo = (sig - 1) * S + 1;
        c = lo + count_below(run, lo, min(sig * S, n), x, lane < u, vec);
      }
    }
    if (lane < K) cuts[(row * (nb + 1) + b) * K + lane] = c;
  }
}

// One block a bucket of a row: its K slices staged in shared memory,
// merged there, and stored into out.
__global__ void __launch_bounds__(KT, 3)
    kway_merge_kernel(const int32_t* __restrict__ in,
                      int32_t* __restrict__ out,
                      const int32_t* __restrict__ cuts, int M, int width,
                      int K, int nb, int cap) {
  extern __shared__ int32_t sm[];
  __shared__ int off[KMAX + 1], beg[KMAX];
  __shared__ int base;
  const size_t row = blockIdx.x / nb;
  const int b = blockIdx.x % nb;
  if (threadIdx.x < 32) {   // the slices, their offsets, the output's start
    const int lane = threadIdx.x;
    const int32_t* c = cuts + (row * (nb + 1) + b) * K;
    const int c0 = lane < K ? c[lane] : 0;
    const int len = lane < K ? c[K + lane] - c0 : 0;
    int inc = len, sum = c0;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += v;
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    if (lane < K) {
      beg[lane] = c0;
      off[lane + 1] = inc;
    }
    if (lane == 0) {
      off[0] = 0;
      base = sum;
    }
  }
  __syncthreads();
  const int n = off[K];
  int32_t* X = sm;
  int32_t* Y = sm + cap + 1;
  const int32_t* r = in + row * M;
  constexpr int UN = 16;   // loads in flight a thread
  int t = 0;
  for (int i0 = threadIdx.x; i0 < n; i0 += UN * KT) {
    int32_t v[UN];
#pragma unroll
    for (int k = 0; k < UN; ++k) {
      const int i = i0 + k * KT;
      if (i < n) {
        while (off[t + 1] <= i) ++t;
        v[k] = r[(size_t)t * width + beg[t] + i - off[t]];
      }
    }
#pragma unroll
    for (int k = 0; k < UN; ++k)
      if (i0 + k * KT < n) X[i0 + k * KT] = v[k];
  }
  __syncthreads();
  const int vt = share(n, KT);
  const int d = min(n, (int)threadIdx.x * vt), e = min(n, d + vt);
  const int32_t* m = X;
  for (int s = 1; s < K; s *= 2) {
    int32_t* y = m == X ? Y : X;
    merge_level(m, y, off, K, s, d, e);
    __syncthreads();
    m = y;
  }
  int32_t* o = out + row * M + base;
  for (int i = threadIdx.x; i < n; i += KT) o[i] = m[i];
}

}  // namespace

// x, out: (Q, M) int32, contiguous; L = pow2 >= max(M, 128), L <= 16384;
// first = log2(presorted run) + 1; vec: M % 4 == 0 and x, out 16-byte
// aligned.
extern "C" int ghostm_sort_rows(const int32_t* x, int32_t* out, int Q, int M,
                                int L, int first, int vec,
                                cudaStream_t stream) {
  switch (L) {
    case 1 << 7: return launch<7>(x, out, Q, M, first, vec, stream);
    case 1 << 8: return launch<8>(x, out, Q, M, first, vec, stream);
    case 1 << 9: return launch<9>(x, out, Q, M, first, vec, stream);
    case 1 << 10: return launch<10>(x, out, Q, M, first, vec, stream);
    case 1 << 11: return launch<11>(x, out, Q, M, first, vec, stream);
    case 1 << 12: return launch<12>(x, out, Q, M, first, vec, stream);
    case 1 << 13: return launch<13>(x, out, Q, M, first, vec, stream);
    case 1 << 14: return launch<14>(x, out, Q, M, first, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Long rows, step 1: x, out (Q, M) int32, contiguous, M > 16384; every
// 16384-key tile of a row sorted ascending into out from stage `first`
// (each tile holds whole presorted runs); vec: M % 4 == 0 and x, out
// 16-byte aligned. samples (Q, tiles, NSR) int32 or null: every
// (16384 / NSR)-th key of each sorted tile, for ghostm_merge_kway.
extern "C" int ghostm_sort_tiles(const int32_t* x, int32_t* out, int Q,
                                 int M, int first, int vec, int32_t* samples,
                                 cudaStream_t stream) {
  using S = Shape<TILE_LOG>;
  const int tiles = (M + TILE - 1) / TILE;
  const int shm = S::WORDS * (int)sizeof(int32_t);
  if (!row_smem_ok(sort_tiles_kernel, shm)) return (int)cudaErrorInvalidValue;
  if ((long long)Q * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  sort_tiles_kernel<<<Q * tiles, S::NT, shm, stream>>>(x, out, M, tiles,
                                                        first, vec, samples);
  return (int)cudaGetLastError();
}

// Long rows of more than KMAX tiles, step 2 until KMAX runs remain: in,
// out (Q, M) int32, contiguous; each row of `in` holds sorted runs of
// `width` keys (width a multiple of 16384, the last run of a row shorter);
// out gets each pair of runs merged (a run with no partner copied). vec:
// M % 4 == 0 and in, out 16-byte aligned.
extern "C" int ghostm_merge_pass(const int32_t* in, int32_t* out, int Q,
                                 int M, int width, int vec,
                                 cudaStream_t stream) {
  const int spans = (M + SPAN - 1) / SPAN;
  if (width % SPAN || (long long)Q * spans > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  merge_pass_kernel<<<Q * spans, MT, 0, stream>>>(in, out, M, width, spans,
                                                  vec);
  return (int)cudaGetLastError();
}

// Long rows, the last step: in, out (Q, M) int32, contiguous; each row of
// `in` holds K = ceil(M / width) sorted runs of `width` keys (2 <= K <=
// KMAX, width a multiple of 16384, the last run shorter); out gets each
// row sorted. samples: ghostm_sort_tiles' (width 16384), or null to read
// every (width / NSR)-th key of the runs in place. cuts: (Q, nb + 1, K)
// int32 scratch; g samples a bucket, nb = ceil(samples a row / g) (the
// wrapper's sort._kway_shape). vec: M % 4 == 0 and in 16-byte aligned.
extern "C" int ghostm_merge_kway(const int32_t* in, int32_t* out, int Q,
                                 int M, int width, const int32_t* samples,
                                 int32_t* cuts, int g, int nb, int vec,
                                 cudaStream_t stream) {
  const int K = (M + width - 1) / width;
  if (K < 2 || K > KMAX || width % (4 * NSR) || g < 1)
    return (int)cudaErrorInvalidValue;
  const int S = width / NSR;
  const int ns = (K - 1) * NSR + (M - (K - 1) * width + S - 1) / S;
  const long long cap = (long long)(g + K) * S;
  if (nb != (ns + g - 1) / g || cap > (1 << 20) ||
      (long long)Q * nb > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int split_shm = 3 * (ns + 1) * (int)sizeof(int32_t);
  const int merge_shm = 2 * ((int)cap + 1) * (int)sizeof(int32_t);
  if (!row_smem_ok(kway_split_kernel, split_shm, KWAY_SMEM) ||
      !row_smem_ok(kway_merge_kernel, merge_shm, KWAY_SMEM))
    return (int)cudaErrorInvalidValue;
  long long s_row = (long long)K * NSR;
  int s_run = NSR, s_j = 1;
  if (!samples) {
    samples = in;
    s_row = M;
    s_run = width;
    s_j = S;
  }
  kway_split_kernel<<<Q, ST, split_shm, stream>>>(
      in, samples, s_row, s_run, s_j, cuts, M, width, K, g, nb, vec);
  kway_merge_kernel<<<Q * nb, KT, merge_shm, stream>>>(in, out, cuts, M,
                                                       width, K, nb, (int)cap);
  return (int)cudaGetLastError();
}
