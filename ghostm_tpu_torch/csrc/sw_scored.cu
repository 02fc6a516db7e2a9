// Kernel B5: banded Smith-Waterman (Gotoh, affine gaps) on a precomputed
// score tile, by rows.
//
// Replaces ghostm_tpu/kernels/sw_pallas.py::_sw_kernel (entry
// sw_banded_pallas), the engine's score-fed align path for matrices outside
// the fused kernel's nibble range (BLOSUM50, PAM) or bands the fused kernel
// does not take, at frames too short for the wavefront kernel B6. Input: a
// (N, Lq, B) tile, int8 with MASKED_I8 for a masked cell or int32 (LOW
// cells taken as they are). Per alignment it returns (score, i_end, b_end):
// max score, then min i, then min b; (-1, -1) when the score is <= 0 —
// equal to sw_xla.sw_banded on the same tile.
//
// Bound on the H100: integer operations (~12 per cell) at int8 tiles; the
// tile itself (1 byte a cell) is read once. Design: B3's row step
// (sw_row_step in sw_common.cuh) with the in-kernel table lookup replaced
// by a read of sc[n, i, b]: one warp per alignment, lane l owning the
// D = ceil(B / 32) diagonals b = l * D + d, so one row of a tile is one
// coalesced load, issued a row ahead of its use. The TPU kernel's row
// tiles (H/F carried in VMEM scratch across grid steps) become the warp's
// registers over a loop of all Lq rows; it needs no N % 128 or row-tile
// padding.
#include "sw_common.cuh"

#define WARPS 4

template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lane,
                                         int B, int (&s)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int b = lane * D + d;
    s[d] = b < B ? widen(__ldg(row + b)) : NEG;
  }
}

template <typename T, int D>
__global__ void sw_scored_kernel(const T* __restrict__ sc, int N, int Lq,
                                 int B, int go1, int ge,
                                 int32_t* __restrict__ score,
                                 int32_t* __restrict__ iend,
                                 int32_t* __restrict__ bend) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps exit; there is no block barrier
  const T* tile = sc + (size_t)n * Lq * B;

  int H[D], F[D], bH[D], bI[D], s[D], nxt[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    H[d] = 0;
    F[d] = NEG;
    bH[d] = 0;
    bI[d] = 0;
  }
  if (Lq > 0) load_row<T, D>(tile, lane, B, nxt);
  for (int i = 0; i < Lq; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = nxt[d];
    if (i + 1 < Lq) load_row<T, D>(tile + (size_t)(i + 1) * B, lane, B, nxt);
    sw_row_step<D>(H, F, bH, bI, s, i, lane, B, go1, ge);
  }
  int bb[D];
#pragma unroll
  for (int d = 0; d < D; ++d) bb[d] = lane * D + d;
  int best, ci, cb;
  sw_finalize<D>(bH, bI, bb, B, 32, best, ci, cb);
  if (lane == 0) {
    score[n] = best;
    iend[n] = ci;
    bend[n] = cb;
  }
}

// sc: (N, Lq, B) contiguous, int8 (is_i8 = 1) or int32; go1 = gap_open +
// gap_extend, ge = gap_extend; outputs (N,) int32. 1 <= B <= 128.
extern "C" int ghostm_sw_scored(const void* sc, int is_i8, int N, int Lq,
                                int B, int go1, int ge, int32_t* score,
                                int32_t* iend, int32_t* bend,
                                cudaStream_t stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  const int D = (B + 31) / 32;
#define LAUNCH(TT, DD)                                                     \
  sw_scored_kernel<TT, DD><<<blocks, 32 * WARPS, 0, stream>>>(             \
      (const TT*)sc, N, Lq, B, go1, ge, score, iend, bend)
#define BY_D(TT)                  \
  switch (D) {                    \
    case 1: LAUNCH(TT, 1); break; \
    case 2: LAUNCH(TT, 2); break; \
    case 3: LAUNCH(TT, 3); break; \
    case 4: LAUNCH(TT, 4); break; \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (is_i8) {
    BY_D(int8_t)
  } else {
    BY_D(int32_t)
  }
#undef BY_D
#undef LAUNCH
  return (int)cudaGetLastError();
}
