// Kernel B4: stable lexicographic multi-operand row sort, first topk columns.
//
// Replaces ghostm_tpu/kernels/sort.py::_lex_rank_kernel (entry lex_rank_rows),
// the per-read hit ranking of engine.rank_reads: 9 int32 operands of
// (R, 48), ascending on the first 5, the original column as the final key
// (stable-sort semantics), first 10 columns kept; and the multi-shard
// select (candidates.select_global): 3 operands of (6 R, n_shards x 8) on
// 3 keys, first 8 columns kept.
//
// Bound on the H100: device-memory bytes (each operand read once, topk
// columns written once; ~17 MB at R = 8192). The previous design carried
// the TPU network over as it was: a 32-thread block a row with all nops
// operands and the index in shared memory, 21 block-wide passes at L = 64,
// each compare-exchange swapping all 10 words of a pair, although only the
// winners' payload is ever written; and the payload capped a row at 48 KB
// of shared memory (L <= 1024 with 9 operands).
//
// Design: only the keys and the column index take part in the ranking.
// The payload operands (num_keys .. nops) and the losing columns never
// move: once a slot's original column is known, each payload value is
// read by index from the row (just read: L1 or L2) and written out.
//  * Rows of up to 64 columns at 5 keys (the rank) or 3 keys (the
//    multi-shard select): a warp a row, 8 rows a block, no block barrier. A bitonic network over 64 positions
//    p = lane + 32 e, each lane holding positions lane and lane + 32 as
//    (keys, column) tuples in registers: strides below 32 exchange a tuple
//    with __shfl_xor_sync and keep the smaller or the larger; stride 32
//    compares the lane's two tuples. The key count is a template
//    parameter, so the compare unrolls. Rank by counting (each column
//    compared with every other, the keys read from a per-warp copy in
//    shared memory) was the alternative: on an H100 at the main shape it
//    took 0.048 ms to this network's 0.025 (its M x M compares cost 2.3x
//    the network's 21 steps of 64).
//  * Longer rows, and any other key count: a block a row (L / 2 threads,
//    at most 1024; the key count read at run time). Shared memory holds
//    the keys and the index only, (num_keys + 1) x L x 4 bytes; above
//    48 KB the launch opts in, up to the card's 227 KB (L <= 8192 at 5
//    keys). A bitonic network over the index array compares through it
//    (keys[k][idx]) and swaps one word a pair.
//  * Sentinels: keys are compared as int32, so INT32_MIN and INT32_MAX
//    rank as the plain version ranks them. Rows are padded to 64 (warp)
//    or L (block) positions holding PAD keys and their own index, so a
//    real column whose keys are all PAD sorts before every padding
//    position and padding never reaches the first M slots.
#include "bitonic.cuh"

#define GHOSTM_MAX_LEX_SMEM (227 << 10)   // an H100 block's opt-in limit

namespace {

constexpr int WARP_COLS = 64;   // columns of a warp's row: 2 a lane
constexpr int WARP_ROWS = 8;    // rows (warps) a block on the warp path

// (b) < (a) on NK keys, then the column (word NK)
template <int NK>
__device__ __forceinline__ bool tuple_less(const int32_t (&b)[NK + 1],
                                           const int32_t (&a)[NK + 1]) {
  bool lt = false, eq = true;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    lt = lt | (eq & (b[k] < a[k]));
    eq = eq & (b[k] == a[k]);
  }
  return lt | (eq & (b[NK] < a[NK]));
}

template <int NK>
__global__ void __launch_bounds__(WARP_ROWS * 32)
    lex_rank_warp(const int32_t* __restrict__ ops, int32_t* __restrict__ out,
                  int nops, int Q, int M, int topk) {
  const int lane = threadIdx.x & 31;
  const size_t r = (size_t)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (r >= (size_t)Q) return;   // whole warps: no block barrier below
  const size_t plane = (size_t)Q * M;
  const int32_t* row = ops + r * M;
  int32_t x[2][NK + 1];   // positions lane, lane + 32: keys, then column
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = lane + 32 * e;
#pragma unroll
    for (int k = 0; k < NK; ++k)
      x[e][k] = p < M ? row[k * plane + p] : GHOSTM_PAD;
    x[e][NK] = p;
  }
  // stage k merges runs of 2^k, ascending where bit k of p is clear
#pragma unroll
  for (int k = 1; k <= 6; ++k) {
#pragma unroll
    for (int j = k - 1; j >= 0; --j) {
      if (j == 5) {   // stride 32, stage 6 (ascending): the lane's pair
        if (tuple_less<NK>(x[1], x[0])) {
#pragma unroll
          for (int w = 0; w <= NK; ++w) {
            const int32_t t = x[0][w];
            x[0][w] = x[1][w];
            x[1][w] = t;
          }
        }
      } else {
        const int d = 1 << j;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = lane + 32 * e;
          int32_t y[NK + 1];
#pragma unroll
          for (int w = 0; w <= NK; ++w)
            y[w] = __shfl_xor_sync(0xffffffffu, x[e][w], d);
          // the lower position of an ascending pair keeps the smaller
          // tuple, as does the upper one of a descending pair
          const bool keep_min = !(lane & d) == !((p >> k) & 1);
          const bool take = tuple_less<NK>(y, x[e]) == keep_min;
#pragma unroll
          for (int w = 0; w <= NK; ++w) x[e][w] = take ? y[w] : x[e][w];
        }
      }
    }
  }
  // position p < topk is slot p
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = lane + 32 * e;
    if (p < topk) {
      int32_t* o = out + r * topk + p;
      const size_t oplane = (size_t)Q * topk;
#pragma unroll
      for (int k = 0; k < NK; ++k) o[k * oplane] = x[e][k];
      for (int op = NK; op < nops; ++op)
        o[op * oplane] = row[op * plane + x[e][NK]];
    }
  }
}

// (keys_y, y) < (keys_x, x), keys k of column c at s[k L + c]
__device__ __forceinline__ bool col_less(const int32_t* s, int L, int nk,
                                         int y, int x) {
  for (int k = 0; k < nk; ++k) {
    const int32_t a = s[k * L + y], b = s[k * L + x];
    if (a != b) return a < b;
  }
  return y < x;
}

__global__ void __launch_bounds__(1024)
    lex_rank_block(const int32_t* __restrict__ ops, int32_t* __restrict__ out,
                   int nops, int Q, int M, int L, int nk, int topk) {
  extern __shared__ int32_t s[];   // keys [nk][L], then the index [L]
  int32_t* idx = s + nk * L;
  const size_t r = blockIdx.x, plane = (size_t)Q * M;
  const int32_t* row = ops + r * M;
  for (int k = 0; k < nk; ++k)
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      s[k * L + i] = i < M ? row[k * plane + i] : GHOSTM_PAD;
  for (int i = threadIdx.x; i < L; i += blockDim.x) idx[i] = i;
  __syncthreads();
  const int nstage = 31 - __clz(L);
  const int half = L >> 1;
  for (int k = 1; k <= nstage; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      const int d = 1 << j;
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t >> j) << (j + 1)) | (t & (d - 1));
        const int x = idx[i], y = idx[i + d];
        // ascending run (bit k of i clear): swap when the partner is
        // smaller; descending: when it is larger (tuples never tie)
        if (col_less(s, L, nk, y, x) != (bool)((i >> k) & 1)) {
          idx[i] = y;
          idx[i + d] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < nops * topk; t += blockDim.x) {
    const int op = t / topk, c = t - op * topk;
    const int i = idx[c];
    out[((size_t)op * Q + r) * topk + c] =
        op < nk ? s[op * L + i] : row[op * plane + i];
  }
}

template <int NK>
int launch_warp(const int32_t* ops, int32_t* out, int nops, int Q, int M,
                int topk, cudaStream_t stream) {
  lex_rank_warp<NK><<<(Q + WARP_ROWS - 1) / WARP_ROWS, WARP_ROWS * 32, 0,
                      stream>>>(ops, out, nops, Q, M, topk);
  return (int)cudaGetLastError();
}

int launch_block(const int32_t* ops, int32_t* out, int nops, int Q, int M,
                 int L, int num_keys, int topk, cudaStream_t stream) {
  const int shm = (num_keys + 1) * L * (int)sizeof(int32_t);
  if (!row_smem_ok(lex_rank_block, shm, GHOSTM_MAX_LEX_SMEM))
    return (int)cudaErrorInvalidValue;
  const int threads = L / 2 < 1024 ? L / 2 : 1024;
  lex_rank_block<<<Q, threads, shm, stream>>>(ops, out, nops, Q, M, L,
                                              num_keys, topk);
  return (int)cudaGetLastError();
}

}  // namespace

// ops: (nops, Q, M) int32; out: (nops, Q, topk) int32, topk <= M;
// 1 <= num_keys <= nops; L = pow2 >= M (no 128 floor) with
// (num_keys + 1) * L * 4 <= 227 KB.
extern "C" int ghostm_lex_rank_rows(const int32_t* ops, int32_t* out, int nops,
                                    int Q, int M, int L, int num_keys,
                                    int topk, cudaStream_t stream) {
  if (M <= WARP_COLS && num_keys == 5)
    return launch_warp<5>(ops, out, nops, Q, M, topk, stream);
  if (M <= WARP_COLS && num_keys == 3)
    return launch_warp<3>(ops, out, nops, Q, M, topk, stream);
  return launch_block(ops, out, nops, Q, M, L, num_keys, topk, stream);
}
