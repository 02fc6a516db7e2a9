// Shared helpers of the row-sort kernels (sort_rows.cu, sort_vote.cu,
// merge_vote.cu, lex_rank.cu): the padding and invalid-key values, the
// shared-memory opt-in, and one block-wide bitonic network over a row held
// in shared memory (sort_vote.cu's monolithic entry).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GHOSTM_PAD 0x7FFFFFFF  // row padding: sorts after every key
#define GHOSTM_BIG (1 << 30)   // first invalid vote key
#define GHOSTM_MAX_ROW_SMEM (64 << 10)  // a row of up to 16384 int32 keys

// A block's row above the 48 KB dynamic shared-memory default needs the
// kernel's opt-in (Hopper allows 227 KB); rows are capped at 64 KB.
template <typename K>
inline bool row_smem_ok(K kernel, int bytes) {
  if (bytes > GHOSTM_MAX_ROW_SMEM) return false;
  if (bytes <= (48 << 10)) return true;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes) == cudaSuccess;
}

// Bitonic stages k = first .. log2(L) over s[0, L), L a power of two. Stage k
// merges runs of 2^k; a run is ascending iff bit k of its index is 0, so the
// last stage sorts the whole row ascending. Starting at stage first > 1
// requires each aligned 2^(first-1) block to be sorted already (ascending for
// even block index, descending for odd) — the JAX package's presorted-run
// skip. Every thread of the block must call this; it ends synchronised.
__device__ __forceinline__ void bitonic_block(int32_t* s, int L, int first) {
  const int nstage = 31 - __clz(L);
  const int half = L >> 1;
  for (int k = first; k <= nstage; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      const int d = 1 << j;
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // t-th pair: i has bit j clear, its partner is i + d
        const int i = ((t >> j) << (j + 1)) | (t & (d - 1));
        const int32_t a = s[i], b = s[i + d];
        const bool desc = (i >> k) & 1;
        if ((a > b) != desc) {
          s[i] = b;
          s[i + d] = a;
        }
      }
      __syncthreads();
    }
  }
}
