// Kernel B2, monolithic entry: per row, sort + run-length vote + top-ncand.
//
// Replaces ghostm_tpu/kernels/sort.py::_sort_vote_kernel, entry
// sort_vote_rank_rows: a full sort of a (Q, M) key row starting at stage
// `first` (presorted runs). The merge entry (merge_vote_rank_rows) has its
// own kernel, merge_vote.cu.
// Then the run length of each distinct valid key (< 2^30) is its vote,
// zeroed below min_votes, and the top ncand by (votes desc, first position
// asc) are written as (keys, votes), key 2^30 where votes == 0.
//
// Bound on the H100: operations at the golden shape (768 rows of 608 keys:
// the network and the vote outweigh the 1.9 MB read).
// Design: one thread block per row, the row in shared memory (4 L bytes;
// above the 48 KB default the launch opts in, up to 64 KB). The vote needs
// no scan: a run's length is the distance from its first position to
// upper_bound(key) over the sorted row, one binary search per run start.
// Each thread keeps the packed (votes << log2(L)+1 | L-1-i) words of its
// elements in registers; ncand block-wide max reductions pick the
// candidates (the packing needs 2 * bit_length(L) <= 31, checked by the
// wrapper).
#include "bitonic.cuh"

// EPT = keys per thread: 8 for L <= 8192, 16 for L = 16384 (1024 threads)
template <int EPT>
__global__ void sort_vote_kernel(const int32_t* __restrict__ a, int M,
                                 int L, int first, int ncand, int min_votes,
                                 int32_t* __restrict__ keys,
                                 int32_t* __restrict__ votes) {
  extern __shared__ int32_t s[];
  __shared__ int32_t red[32];
  const size_t r = blockIdx.x;
  const int32_t* row = a + r * M;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    s[i] = i < M ? row[i] : GHOSTM_PAD;
  __syncthreads();
  bitonic_block(s, L, first);

  const int shift = 32 - __clz(L);  // bit_length(L)
  const int ept = L / blockDim.x;
  int32_t pk[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    pk[e] = 0;
    if (e < ept) {
      const int i = e * blockDim.x + threadIdx.x;
      const int32_t v = s[i];
      int nv = 0;
      if (v < GHOSTM_BIG && (i == 0 || s[i - 1] != v)) {
        int lo = i + 1, hi = L;  // first index in [i+1, L) with s > v
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s[mid] > v) hi = mid; else lo = mid + 1;
        }
        nv = lo - i;
        if (nv < min_votes) nv = 0;
      }
      pk[e] = (nv << shift) | (L - 1 - i);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int32_t mask = (1 << shift) - 1;
  for (int c = 0; c < ncand; ++c) {
    int32_t m = 0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) m = max(m, pk[e]);
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = 0;
    for (int w = 0; w < nwarps; ++w) m = max(m, red[w]);
    __syncthreads();  // red is rewritten next round
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (pk[e] == m) pk[e] = 0;
    if (threadIdx.x == 0) {
      const int32_t tv = m >> shift;
      const int idx = (L - 1) - (m & mask);
      keys[r * ncand + c] = tv > 0 ? s[idx] : GHOSTM_BIG;
      votes[r * ncand + c] = tv;
    }
  }
}

// a (Q, M), first = log2(run) + 1; keys, votes: (Q, ncand) int32.
// L = pow2 >= max(M, 128), L <= 16384.
extern "C" int ghostm_sort_vote_rows(const int32_t* a, int Q, int M, int L,
                                     int first, int ncand, int min_votes,
                                     int32_t* keys, int32_t* votes,
                                     cudaStream_t stream) {
  const int threads = L / 2 < 1024 ? L / 2 : 1024;
  const int shm = L * (int)sizeof(int32_t);
  if (L / threads <= 8) {
    if (!row_smem_ok(sort_vote_kernel<8>, shm))
      return (int)cudaErrorInvalidValue;
    sort_vote_kernel<8><<<Q, threads, shm, stream>>>(
        a, M, L, first, ncand, min_votes, keys, votes);
  } else if (L / threads <= 16) {
    if (!row_smem_ok(sort_vote_kernel<16>, shm))
      return (int)cudaErrorInvalidValue;
    sort_vote_kernel<16><<<Q, threads, shm, stream>>>(
        a, M, L, first, ncand, min_votes, keys, votes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
