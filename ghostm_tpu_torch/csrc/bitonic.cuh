// Shared helpers of the row-sort kernels (sort_rows.cu, sort_vote.cu,
// merge_vote.cu, lex_rank.cu): the padding and invalid-key values, the
// shared-memory opt-in, and kernel B1's register bitonic network, which
// sort_rows.cu and sort_vote.cu's monolithic entry both run (its design
// note is sort_rows.cu's).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GHOSTM_PAD 0x7FFFFFFF  // row padding: sorts after every key
#define GHOSTM_BIG (1 << 30)   // first invalid vote key
#define GHOSTM_MAX_ROW_SMEM (64 << 10)  // a row of up to 16384 int32 keys

// A block's dynamic shared memory above the 48 KB default needs the
// kernel's opt-in (Hopper allows 227 KB); B1 and B2 cap a row at 64 KB.
template <typename K>
inline bool row_smem_ok(K kernel, int bytes, int cap = GHOSTM_MAX_ROW_SMEM) {
  if (bytes > cap) return false;
  if (bytes <= (48 << 10)) return true;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes) == cudaSuccess;
}

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
  // padding is monotone; the swizzle permutes [0, L), so its last key's
  // word is not its largest
  static constexpr int WORDS =
      Words<LOGL>::padded ? Words<LOGL>::of(ROWS * L - 1) + 1 : ROWS * L;
};

// The block's rows row0 .. row0 + ROWS - 1 of the (Q, M) x into shared
// memory, coalesced: key a of the block's rows -> word W::of(a); keys past
// M and rows past Q are PAD. vec: M % 4 == 0 and x 16-byte aligned.
template <int LOGL>
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ x,
                                          int32_t* s, int Q, int M,
                                          size_t row0, int vec) {
  using S = Shape<LOGL>;
  using W = Words<LOGL>;
  constexpr int L = S::L;
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
}

// Sorts the block's rows in shared memory (loaded by load_rows, after a
// barrier) ascending from stage `first`; they are in the same words on
// exit, after a barrier. Thread t of row r: threadIdx.x / TR and % TR,
// computed by the caller before the load (computed here, after it, ptxas
// gives 4 of B1's 8 instances other register counts). Every thread of the
// block must call this.
template <int LOGL>
__device__ __forceinline__ void sort_rows_smem(int32_t* s, int r, int t,
                                               int first) {
  if (first <= LOGL) {
    const int rbase = r << LOGL;
    int32_t v[EPT];
    stages<LOGL, 1>(v, s, rbase, t, first);
    __syncthreads();
    to_smem<LOGL, 0>(v, s, rbase | lay_base<0>(t));
    __syncthreads();
  }
}

}  // namespace
