// Kernel B4: stable lexicographic multi-operand row sort, first topk columns.
//
// Replaces ghostm_tpu/kernels/sort.py::_lex_rank_kernel (entry lex_rank_rows),
// the per-read hit ranking of engine.rank_reads: 9 int32 operands of
// (R, 48), ascending on the first 5, the original column as the final key
// (stable-sort semantics), first 10 columns kept.
//
// Bound on the H100: device-memory bytes (each operand read once, topk
// columns written once; ~17 MB at R = 8192). Design: one thread block per
// row; the row's nops operands plus the original index sit in shared memory
// as (nops + 1) x L int32 (2.5 KB at L = 64, padded with PAD, which sorts
// last — and the index tie-break keeps padding behind any real PAD value).
// A bitonic network compares (key_0 .. key_{num_keys-1}, index) and swaps
// all nops + 1 entries of a pair together.
#include "bitonic.cuh"

__device__ __forceinline__ bool lex_less(const int32_t* s, int L, int p,
                                         int i, int num_keys, int nops) {
  for (int k = 0; k < num_keys; ++k) {
    const int32_t a = s[k * L + p], b = s[k * L + i];
    if (a != b) return a < b;
  }
  return s[nops * L + p] < s[nops * L + i];
}

__global__ void lex_rank_kernel(const int32_t* __restrict__ ops,
                                int32_t* __restrict__ out, int nops, int Q,
                                int M, int L, int num_keys, int topk) {
  extern __shared__ int32_t s[];
  const size_t r = blockIdx.x;
  for (int op = 0; op < nops; ++op) {
    const int32_t* row = ops + ((size_t)op * Q + r) * M;
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      s[op * L + i] = i < M ? row[i] : GHOSTM_PAD;
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) s[nops * L + i] = i;
  __syncthreads();
  const int nstage = 31 - __clz(L);
  const int half = L >> 1;
  for (int k = 1; k <= nstage; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      const int d = 1 << j;
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t >> j) << (j + 1)) | (t & (d - 1));
        const int p = i + d;
        const bool desc = (i >> k) & 1;
        // ascending run: swap when the partner is smaller; descending run:
        // swap when it is larger (keys + index are unique, never equal)
        if (lex_less(s, L, p, i, num_keys, nops) != desc) {
          for (int op = 0; op <= nops; ++op) {
            const int32_t tmp = s[op * L + i];
            s[op * L + i] = s[op * L + p];
            s[op * L + p] = tmp;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int op = 0; op < nops; ++op) {
    int32_t* o = out + ((size_t)op * Q + r) * topk;
    for (int i = threadIdx.x; i < topk; i += blockDim.x) o[i] = s[op * L + i];
  }
}

// ops: (nops, Q, M) int32; out: (nops, Q, topk) int32, topk <= M;
// L = pow2 >= max(M, 128) with (nops + 1) * L * 4 <= 48 KB.
extern "C" int ghostm_lex_rank_rows(const int32_t* ops, int32_t* out, int nops,
                                    int Q, int M, int L, int num_keys,
                                    int topk, cudaStream_t stream) {
  int threads = L / 2 < 1024 ? L / 2 : 1024;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)(nops + 1) * L * sizeof(int32_t);
  lex_rank_kernel<<<Q, threads, smem, stream>>>(ops, out, nops, Q, M, L,
                                                num_keys, topk);
  return (int)cudaGetLastError();
}
