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
// which touches each key once): the block (256 threads) copies a and b
// into shared memory with 16-byte loads, then its 8 warps vote the row
// through vote.cuh's vote_rank (valid prefixes, per-thread run counting
// along the merge path, the two-level warp-maxima top ncand): two
// barriers in all. sort_vote.cu's monolithic entry votes through the same
// function.
// Shared memory: the two rows, (La + Mb) * 4 bytes (18 KB at 4096 + 512;
// 43 KB at 8192 + 2560), and 4.5 KB of lists.
#include "vote.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

  vote_rank<NC, WARPS>(sa, La, sb, Mb, ncand, min_votes, threadIdx.x, wl,
                       fin, keys + r * ncand, votes + r * ncand, true);
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
