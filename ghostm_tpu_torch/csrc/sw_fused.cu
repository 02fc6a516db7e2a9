// Kernel B3: banded Smith-Waterman (Gotoh, affine gaps) with the
// substitution scores looked up in-kernel.
//
// Replaces ghostm_tpu/kernels/sw_fused.py::_fused_kernel (entry
// sw_fused_wave), the align phase: N query frames of Lq codes against N
// windows of >= Lq + B subject codes, over B diagonals (393,216 alignments
// of 40 x 32 cells per config-2 batch). Per alignment it returns
// (score, i_end, b_end): max score, then min i, then min b; (-1, -1) when
// the score is <= 0 — equal to sw_xla.sw_banded(banded_scores_i8(...)).
//
// Bound on the H100: integer operations (~12 per cell: the H, E, F
// recurrences and the best-cell update), not bytes (112 code bytes per
// 1280-cell alignment). Design: one warp per alignment, lane l owning the
// D = ceil(B / 32) diagonals b = l * D + d (B = 32: one diagonal a lane).
// Rows advance in order, as sw_xla._row_step (sw_row_step in
// sw_common.cuh, shared with the score-fed row kernel B5).
// The 32 x 32 score table sits in shared memory as int8 with -128 for a
// masked entry (a LOW matrix entry, or a window code >= code_limit); the
// subject-span mask [rel_lo, rel_hi) is tested per cell. The TPU kernel's
// nibble-packed profile words existed only because the TPU has no gather.
// Hopper's DPX instructions (__viaddmax_s32 ...) fit this recurrence: later.
#include "sw_common.cuh"

#define WARPS 4

template <int D>
__global__ void sw_fused_kernel(const int8_t* __restrict__ q,
                                const int8_t* __restrict__ w,
                                const int32_t* __restrict__ rel_lo,
                                const int32_t* __restrict__ rel_hi,
                                const int8_t* __restrict__ table, int N, int Lq,
                                int Wl, int B, int go1, int ge,
                                int32_t* __restrict__ score,
                                int32_t* __restrict__ iend,
                                int32_t* __restrict__ bend) {
  __shared__ int8_t tab[32 * 32];
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps exit; no block barrier follows
  const int8_t* qn = q + (size_t)n * Lq;
  const int8_t* wn = w + (size_t)n * Wl;
  const int lo = rel_lo[n], hi = rel_hi[n];

  int H[D], F[D], bH[D], bI[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    H[d] = 0;
    F[d] = NEG;
    bH[d] = 0;
    bI[d] = 0;
  }
  for (int i = 0; i < Lq; ++i) {
    // codes are < 32 by construction; & 31 keeps a bad code in the table
    const int8_t* trow = tab + ((qn[i] & 31) << 5);
    int s[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int b = lane * D + d;
      s[d] = NEG;
      if (b < B) {
        const int j = i + b;
        const int t = trow[wn[j] & 31];
        if (t != MASKED_I8 && j >= lo && j < hi) s[d] = t;
      }
    }
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

// q: (N, Lq) int8; w: (N, Wl) int8 with Wl >= Lq + B; rel_lo, rel_hi: (N,)
// int32 window-local subject span; table: (32, 32) int8, -128 = masked;
// go1 = gap_open + gap_extend, ge = gap_extend; outputs (N,) int32.
// B even, 16 <= B <= 128.
extern "C" int ghostm_sw_fused(const int8_t* q, const int8_t* w,
                               const int32_t* rel_lo, const int32_t* rel_hi,
                               const int8_t* table, int N, int Lq, int Wl,
                               int B, int go1, int ge, int32_t* score,
                               int32_t* iend, int32_t* bend,
                               cudaStream_t stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  const int D = (B + 31) / 32;
#define LAUNCH(DD)                                                        \
  sw_fused_kernel<DD><<<blocks, 32 * WARPS, 0, stream>>>(                 \
      q, w, rel_lo, rel_hi, table, N, Lq, Wl, B, go1, ge, score, iend, bend)
  switch (D) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
