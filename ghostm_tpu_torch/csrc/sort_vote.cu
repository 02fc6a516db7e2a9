// Kernel B2, monolithic entry: per row, sort + run-length vote + top-ncand.
//
// Replaces ghostm_tpu/kernels/sort.py::_sort_vote_kernel, entry
// sort_vote_rank_rows: a full sort of a (Q, M) key row starting at stage
// `first` (presorted runs), where the propose phase does not split the
// sort (the config-1 golden's (768, 608) rows with runs of 16; 36-residue
// frames at hits_per_seed 128: (Q, 4096) with runs of 128). Then the run
// length of each distinct valid key (< 2^30) is its vote, zeroed below
// min_votes, and the top ncand by (votes desc, first position asc) are
// written as (keys, votes), key 2^30 where votes == 0. The merge entry
// (merge_vote_rank_rows) is merge_vote.cu.
//
// Bound on the H100: operations at the golden shape (768 rows of 608 keys:
// the network and the vote outweigh the 1.9 MB read); device-memory bytes
// at (6144, 4096) (8 bytes a key would move a row in and out; the row is
// read once and 64 bytes of candidates written). The previous design ran
// the TPU network as it was: one shared-memory pass and one block barrier
// per stride, a binary search per run start, and ncand block-wide max
// rounds with two barriers each.
//
// Design: no network and no vote of its own. The sort is kernel B1's
// register bitonic network (bitonic.cuh: load_rows, sort_rows_smem): a row
// of L keys over L / 32 threads, 128-thread blocks holding 128 / (L / 32)
// rows when L < 4096, one row of L / 32 threads above. The sorted rows go
// from the network's padded (or swizzled) words to plain order in place,
// through registers (32 reads, a barrier, 32 coalesced writes a thread),
// and the vote is merge_vote.cu's (vote.cuh: vote_rank with an empty
// second list). Mapping: a row is voted by max(L / 32, 32) threads, whole
// warps, so the same threads sort and vote: at L >= 1024 the L / 32
// threads that sorted a row vote it (one warp a row at L = 1024, 4 warps
// at 4096, 16 at 16384, each thread ~32 positions, as in the merge entry);
// below 1024 each of the block's 4 warps votes 128 / (L / 32) / 4 rows in
// turn, with warp barriers only. The packing (votes << 14 | position) needs
// L <= 16384 and 2 * bit_length(L) <= 31, checked by the wrapper.
// Shared memory: B1's padded rows (4.1 KB a 1024-key row; 64 KB at L =
// 16384, where the launch opts in) and the vote's lists (NC words a warp
// and a row group).
//
// Build: the network is compiled once a row length (sort_block_rows, not
// inlined), not once a row length and candidate count; it reads the
// block's dynamic shared memory by name, so its accesses stay shared-space
// ones across the call.
#include "vote.cuh"

namespace {

template <int LOGL>
__device__ __noinline__ void sort_block_rows(int r, int t, int first) {
  extern __shared__ int32_t s[];
  sort_rows_smem<LOGL>(s, r, t, first);
}

template <int LOGL, int NC>
__global__ void __launch_bounds__(Shape<LOGL>::NT)
    sort_vote_kernel(const int32_t* __restrict__ x, int Q, int M, int first,
                     int vec, int ncand, int min_votes,
                     int32_t* __restrict__ keys,
                     int32_t* __restrict__ votes) {
  using S = Shape<LOGL>;
  using W = Words<LOGL>;
  constexpr int L = S::L;
  constexpr int V = S::TR < 32 ? 32 : S::TR;   // threads voting a row
  constexpr int NW = V / 32;
  constexpr int G = S::NT / V;                 // vote groups a block
  extern __shared__ int32_t s[];
  __shared__ uint32_t wl[S::NT / 32 * NC];     // each warp's top ncand
  __shared__ uint32_t fin[G * NC];             // each group's top ncand
  const size_t row0 = (size_t)blockIdx.x * S::ROWS;
  load_rows<LOGL>(x, s, Q, M, row0, vec);
  __syncthreads();
  sort_block_rows<LOGL>(threadIdx.x / S::TR, threadIdx.x % S::TR, first);
  // key a of the block's rows: word W::of(a) -> word a
  int32_t v[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) v[e] = s[W::of(threadIdx.x + e * S::NT)];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < EPT; ++e) s[threadIdx.x + e * S::NT] = v[e];
  __syncthreads();
  const int g = threadIdx.x / V, t = threadIdx.x % V;
  for (int row = g; row < S::ROWS; row += G) {
    if constexpr (NW == 1) __syncwarp();   // the last row's lists are read
    const size_t q = row0 + row;
    vote_rank<NC, NW>(s + row * L, L, nullptr, 0, ncand, min_votes, t,
                      wl + g * NW * NC, fin + g * NC, keys + q * ncand,
                      votes + q * ncand, q < (size_t)Q);
  }
}

template <int LOGL, int NC>
int launch(const int32_t* x, int Q, int M, int first, int vec, int ncand,
           int min_votes, int32_t* keys, int32_t* votes,
           cudaStream_t stream) {
  using S = Shape<LOGL>;
  const int shm = S::WORDS * (int)sizeof(int32_t);
  if (!row_smem_ok(sort_vote_kernel<LOGL, NC>, shm))
    return (int)cudaErrorInvalidValue;
  const int grid = (Q + S::ROWS - 1) / S::ROWS;
  sort_vote_kernel<LOGL, NC><<<grid, S::NT, shm, stream>>>(
      x, Q, M, first, vec, ncand, min_votes, keys, votes);
  return (int)cudaGetLastError();
}

template <int LOGL>
int launch_nc(const int32_t* x, int Q, int M, int first, int vec, int ncand,
              int min_votes, int32_t* keys, int32_t* votes,
              cudaStream_t stream) {
  if (ncand <= 8)
    return launch<LOGL, 8>(x, Q, M, first, vec, ncand, min_votes, keys,
                           votes, stream);
  if (ncand <= 32)
    return launch<LOGL, 32>(x, Q, M, first, vec, ncand, min_votes, keys,
                            votes, stream);
  if (ncand <= MAX_NCAND)
    return launch<LOGL, MAX_NCAND>(x, Q, M, first, vec, ncand, min_votes,
                                   keys, votes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a (Q, M) contiguous, first = log2(run) + 1; keys, votes: (Q, ncand)
// int32, 1 <= ncand <= 128; L = pow2 >= max(M, 128), L <= 16384; vec:
// M % 4 == 0 and a 16-byte aligned.
extern "C" int ghostm_sort_vote_rows(const int32_t* a, int Q, int M, int L,
                                     int first, int vec, int ncand,
                                     int min_votes, int32_t* keys,
                                     int32_t* votes, cudaStream_t stream) {
  switch (L) {
#define GHOSTM_L(LOGL)                                                    \
  case 1 << LOGL:                                                         \
    return launch_nc<LOGL>(a, Q, M, first, vec, ncand, min_votes, keys,  \
                           votes, stream);
    GHOSTM_L(7) GHOSTM_L(8) GHOSTM_L(9) GHOSTM_L(10)
    GHOSTM_L(11) GHOSTM_L(12) GHOSTM_L(13) GHOSTM_L(14)
#undef GHOSTM_L
    default: return (int)cudaErrorInvalidValue;
  }
}
