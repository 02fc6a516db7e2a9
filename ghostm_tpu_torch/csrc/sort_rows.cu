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
// opts in).
#include "bitonic.cuh"

namespace {

constexpr int EPT = 32;          // keys per thread
constexpr int BLOCK = 128;       // threads per block (more at L > 4096)

// XOR swizzle: bits 0..4 of a XORed by bits 5..9, 10..14 and 15..19
__host__ __device__ constexpr int swz(int a) {
  return a ^ (((a >> 5) ^ (a >> 10) ^ (a >> 15)) & 31);
}

// a key's shared-memory word: padded up to 8192 keys, else XOR-swizzled
template <int LOGL>
struct Words {
  static constexpr bool padded = LOGL <= 13;
  __host__ __device__ static constexpr int of(int a) {
    return padded ? a + (a >> 5) : swz(a);
  }
  // word of (base | c) from word(base) and word(c), base and c disjoint
  __device__ static int join(int wbase, int wc) {
    return padded ? wbase + wc : wbase ^ wc;
  }
};

// index bits of thread t's register 0 in layout LO
template <int LO>
__device__ __forceinline__ int lay_base(int t) {
  return ((t >> LO) << (LO + 5)) | (t & ((1 << LO) - 1));
}

template <int LOGL, int LO>
__device__ __forceinline__ void to_smem(const int32_t (&x)[EPT], int32_t* s,
                                        int base) {
  using W = Words<LOGL>;
  const int wb = W::of(base);
#pragma unroll
  for (int e = 0; e < EPT; ++e) s[W::join(wb, W::of(e << LO))] = x[e];
}

template <int LOGL, int LO>
__device__ __forceinline__ void from_smem(int32_t (&x)[EPT],
                                          const int32_t* s, int base) {
  using W = Words<LOGL>;
  const int wb = W::of(base);
#pragma unroll
  for (int e = 0; e < EPT; ++e) x[e] = s[W::join(wb, W::of(e << LO))];
}

template <int LOGL, int LO, int NLO>
__device__ __forceinline__ void relayout(int32_t (&x)[EPT], int32_t* s,
                                         int rbase, int t) {
  if constexpr (LO != NLO) {
    __syncthreads();   // everyone has read the previous layout
    to_smem<LOGL, LO>(x, s, rbase | lay_base<LO>(t));
    __syncthreads();
    from_smem<LOGL, NLO>(x, s, rbase | lay_base<NLO>(t));
  }
}

// the layout that serves stride 2^j, coming from layout lo
template <int LOGL>
__host__ __device__ constexpr int window(int j, int lo) {
  if (j >= lo && j < lo + 5) return lo;
  if (j < 5) return 0;
  if (LOGL < 10) return LOGL - 5;   // rows of 4..16 threads
  return j - 4 > 5 ? j - 4 : 5;
}

// strides 2^J .. 1 of one stage, starting in layout LO; ends in layout 0
template <int LOGL, int J, int LO>
__device__ __forceinline__ void half_cleaners(int32_t (&x)[EPT], int32_t* s,
                                              int rbase, int t) {
  if constexpr (J < 0) {
    relayout<LOGL, LO, 0>(x, s, rbase, t);
  } else {
    constexpr int NLO = window<LOGL>(J, LO);
    relayout<LOGL, LO, NLO>(x, s, rbase, t);
    constexpr int d = 1 << (J - NLO);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (!(e & d)) {
        const int32_t lo = min(x[e], x[e | d]), hi = max(x[e], x[e | d]);
        x[e] = lo;
        x[e | d] = hi;
      }
    }
    half_cleaners<LOGL, J - 1, NLO>(x, s, rbase, t);
  }
}

// complement the keys whose index has bit K set, and undo the complement
// of bit `prev` (31: none), in layout LO
template <int K, int LO>
__device__ __forceinline__ void complement(int32_t (&x)[EPT], int t,
                                           int prev) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = lay_base<LO>(t) | (e << LO);
    x[e] ^= -((i >> K) & 1) ^ -((i >> prev) & 1);
  }
}

// stages K .. LOGL, each skipped below `first`; the first stage reads the
// row from shared memory straight into the layout of its largest stride;
// layout 0 on exit
template <int LOGL, int K>
__device__ __forceinline__ void stages(int32_t (&x)[EPT], int32_t* s,
                                       int rbase, int t, int first) {
  if constexpr (K <= LOGL) {
    if (K == first) {
      constexpr int W = window<LOGL>(K - 1, 0);
      from_smem<LOGL, W>(x, s, rbase | lay_base<W>(t));
      complement<K, W>(x, t, 31);
      half_cleaners<LOGL, K - 1, W>(x, s, rbase, t);
    } else if (K > first) {
      complement<K, 0>(x, t, K - 1);
      half_cleaners<LOGL, K - 1, 0>(x, s, rbase, t);
    }
    stages<LOGL, K + 1>(x, s, rbase, t, first);
  }
}

template <int LOGL>
struct Shape {
  static constexpr int L = 1 << LOGL;
  static constexpr int TR = L / EPT;                       // threads a row
  static constexpr int ROWS = TR < BLOCK ? BLOCK / TR : 1;  // rows a block
  static constexpr int NT = TR * ROWS;
  static constexpr int WORDS = Words<LOGL>::of(ROWS * L - 1) + 1;
};

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
  // load: coalesced, key a of the block's rows -> word W::of(a)
  if (vec) {
    for (int a = threadIdx.x * 4; a < S::ROWS * L; a += S::NT * 4) {
      const size_t row = row0 + (a >> LOGL);
      const int c = a & (L - 1);
      int4 v = make_int4(GHOSTM_PAD, GHOSTM_PAD, GHOSTM_PAD, GHOSTM_PAD);
      if (row < (size_t)Q && c < M)
        v = *reinterpret_cast<const int4*>(x + row * M + c);
      s[W::of(a)] = v.x;
      s[W::of(a + 1)] = v.y;
      s[W::of(a + 2)] = v.z;
      s[W::of(a + 3)] = v.w;
    }
  } else {
    for (int a = threadIdx.x; a < S::ROWS * L; a += S::NT) {
      const size_t row = row0 + (a >> LOGL);
      const int c = a & (L - 1);
      s[W::of(a)] = row < (size_t)Q && c < M ? x[row * M + c] : GHOSTM_PAD;
    }
  }
  __syncthreads();
  if (first <= LOGL) {
    const int rbase = r << LOGL;
    int32_t v[EPT];
    stages<LOGL, 1>(v, s, rbase, t, first);
    __syncthreads();
    to_smem<LOGL, 0>(v, s, rbase | lay_base<0>(t));
    __syncthreads();
  }
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
